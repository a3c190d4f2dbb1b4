"""Head-parallel tensor parallelism of the dense decoders over gloo process
groups on the CPU, alone and with ZeRO-3 over the data axis, against the
reference's unsharded jitted step; the tensor-parallel operators, the
replicated leaves' rule, checkpoints across meshes, the train CLI and the
refusals that stand (ROADMAP A.4c).

Three groups are started, of 1, 2 and 4 ranks, each a set of worker
processes (`WORKER`, one rendezvous through a `file://` store under the
test's temporary directory, no TCP port, a timeout on the group and on
the parent's wait), each running every case below before it exits.  A
case is an arch's f32 smoke config (the bridged reference parameters of
`test_torch_train._models`; qwen3-14b with a 250-token vocab, so each
rank's half of the head is stored row-padded; gemma3-1b's tied table at
one rank) under a forced tp-mode plan: at (data 1, model 1), (1, 2), and
(2, 2) with `fsdp` False and True.  Its three global batches carry a 0/1 mask drawn per element, so
the data ranks' mask counts differ.  Each rank trains its rows
(`data.rank_rows`) through `make_sharded_train_step`; rank 0 gathers the
whole gradient of step 1 and the whole parameters and AdamW moments
after steps 1 and 3.  The parent holds them, and the losses, to the
reference's `make_train_step`, jitted and unsharded, from the same
parameters on the same batches, with the bars of
`tests/test_torch_train.py::check_train_step` (`test_torch_parallel_train`'s
checks), and holds each run's collectives to the meta trace of the same
rank's step (`make_sharded_train_step(rank=)` on the "meta" device).

Each group also holds `vocab_log_likelihood` and `vocab_embed` at a model
axis of its size against `torch.log_softmax` / `F.embedding` (values and
gradients); the 2-rank group records, for qwen3-14b at (1, 2), each
rank's own gradients of the residual-stream norms and of q_norm / k_norm
before they are summed; and each group restores its pieces of one
checkpoint the parent wrote, checks them against its own cut of the whole
leaves, and writes it again from its pieces: the files written at (1, 1),
(1, 2) and (2, 2) are byte-equal to the parent's."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import rank_rows, to_device
from repro_torch.launch import step_cost
from repro_torch.launch import steps as tsteps
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init
from repro_torch.parallel import fsdp, tensor
from repro_torch.parallel.logical import use_rules
from repro_torch.parallel.sharding import make_plan
from test_torch_parallel_train import LR, STEPS, TOTAL, _inputs, _reference, _whole_state
from test_torch_train import GRAD_RTOL, LOSS_TOL, _assert_trees_close, _cfgs

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("qwen3-14b", "qwen2.5-14b", "mistral-nemo-12b")
B = 4
# qwen2.5-14b's k bias: its gradient sums the RoPE-rotated keys' gradients
# over the positions, which mostly cancel (without RoPE they would cancel
# exactly: a bias on every key adds q . b_k to all of a query's scores),
# so the sums' order shows in the updates.  The port's own unsharded step
# lands 5.4e-6 from the reference's live parameters of layer 1 after step
# 3 (4.4e-7 in layer 0, these batches), over the live bar of 4e-6; so
# those leaves' live parameters are held to twice that gap, and their
# gradients and moments to the usual bars (the sharded cases land within
# 6.3e-6).
CANCELLING = {"qwen2.5-14b": ("bk",)}
CANCELLING_BAR = 1.1e-5
GROUP_TIMEOUT = 240          # seconds a group may take, under a test's 300
VOCAB_TOL = 1e-6             # the operators against log_softmax / F.embedding, f32
# (mesh sizes, fsdp) of each group's cases, and the mesh of its checkpoint
MESHES = {1: [((1, 1), False)], 2: [((1, 2), False)], 4: [((2, 2), False), ((2, 2), True)]}
CKPT_MESH = {1: ((1, 1), False), 2: ((1, 2), False), 4: ((2, 2), True)}


def _cases(world):
    """(name, arch, mesh sizes, fsdp) of one group; at one rank also
    gemma3-1b, whose tied table is both the vocab-parallel lookup and the
    head (its one kv head divides only a model axis of 1)."""
    out = [(f"{arch}-{a}x{m}" + ("-zero3" if z else ""), arch, (a, m), z)
           for arch in ARCHS for (a, m), z in MESHES[world]]
    return out + ([("gemma3-1b-1x1", "gemma3-1b", (1, 1), False)] if world == 1 else [])


def port_cfg(arch):
    return _cfgs(arch)[1]


def tp_plan(sizes, zero3):
    mesh = MeshShape(("data", "model"), tuple(sizes))
    return mesh, make_plan(mesh, 10**12, force_mode="tp", force_fsdp=zero3)


WORKER = textwrap.dedent("""
    import dataclasses, datetime, json, sys
    import numpy as np, torch, torch.distributed as dist
    import torch.nn.functional as F
    a = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + a["store"], rank=a["rank"],
                            world_size=a["world"],
                            timeout=datetime.timedelta(seconds=a["timeout"]))
    from repro_torch import configs, tree as tree_lib
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.data import rank_rows, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import fsdp, tensor
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.runtime import Supervisor, TrainLoopConfig

    rank, world = a["rank"], a["world"]

    def port_cfg(arch):
        return dataclasses.replace(configs.get_smoke(arch), **a["overrides"].get(arch, {}))

    def tp(sizes, zero3):
        mesh = MeshShape(("data", "model"), tuple(sizes))
        return mesh, make_plan(mesh, 10**12, force_mode="tp", force_fsdp=zero3)

    out = {}
    # -- the operators at a model axis of the group's size -------------------------
    rng = np.random.default_rng(5)
    Bv, C, V, d = 2, 5, 48, 8
    logits = torch.from_numpy(rng.standard_normal((Bv, C, V)).astype(np.float32) * 3)
    labels = torch.from_numpy(rng.integers(0, V, (Bv, C)))
    g = torch.from_numpy(rng.standard_normal((Bv, C)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((V, d)).astype(np.float32))
    gx = torch.from_numpy(rng.standard_normal((Bv, C, d)).astype(np.float32))
    axis = tensor.ModelAxis(size=world, index=rank)
    n = V // world
    sl = slice(rank * n, (rank + 1) * n)
    local = logits[..., sl].clone().requires_grad_(True)
    ll = tensor.vocab_log_likelihood(local, labels, axis)
    (ll * g).sum().backward()
    whole = logits.clone().requires_grad_(True)
    want = torch.gather(torch.log_softmax(whole, -1), -1, labels[..., None])[..., 0]
    (want * g).sum().backward()
    piece = table[sl].clone().requires_grad_(True)
    x = tensor.vocab_embed(labels, piece, axis)
    (x * gx).sum().backward()
    wtable = table.clone().requires_grad_(True)
    wx = F.embedding(labels, wtable)
    (wx * gx).sum().backward()
    out["vocab"] = {"ll": float((ll - want).abs().max()),
                    "dlogits": float((local.grad - whole.grad[..., sl]).abs().max()),
                    "embed": float((x - wx).abs().max()),
                    "dtable": float((piece.grad - wtable.grad[sl]).abs().max()),
                    "collectives": dict(axis.collectives)}
    # -- the train cases ----------------------------------------------------------
    saved = {}
    for name, arch, sizes, zero3 in a["cases"]:
        cfg = port_cfg(arch)
        data = np.load(a["inputs"][arch])
        params = M.init_model(cfg, seed=0, device="cpu")
        for i, leaf in enumerate(tree_lib.leaves(params)):
            leaf.copy_(torch.from_numpy(data[f"p{i}"]))
        mesh, plan = tp(sizes, zero3)
        opt_cfg = steps.optimizer_config(cfg)
        step = steps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=a["lr"],
                                             total_steps=a["total"])
        lay = step.layout
        params = lay.shard(params)
        opt = adamw_init(params, opt_cfg)
        batches = [{k[3:]: data[k] for k in data.files if k.startswith(f"b{s}_")}
                   for s in range(a["steps"])]
        local = [to_device(rank_rows(b, mesh, plan, rank), "cpu") for b in batches]
        cuts = lay.state_dims(opt)
        _, grads = step.gradients(params, local[0])
        host = lay.gather_to_host(tree_lib.unflatten(params, grads), cuts["params"])
        if rank == 0:
            saved.update({f"{name}/g{i}": x.numpy() for i, x in
                          enumerate(tree_lib.leaves(host))})
        if name == a["own_grads_case"]:
            lay.reduce = lambda g: g          # each rank's own gradients
            _, own = step.gradients(params, local[0])
            del lay.reduce
            mine = {"/".join(map(str, p)): g.detach().numpy().tolist()
                    for (p, _), g in zip(tree_lib.leaves_with_paths(params), own)
                    if p[-1] in ("final_norm", "norm1", "q_norm", "k_norm")}
            every = [None] * world
            dist.all_gather_object(every, mine)
            out["own_grads"] = every
            out["partial"] = {"/".join(map(str, p)): bool(f) for (p, _), f in
                              zip(tree_lib.leaves_with_paths(params), lay.partial)}
        losses = []
        for s in range(a["steps"]):
            params, opt, m = step(params, opt, local[s])
            losses.append(float(m["loss"]))
            if s in (0, a["steps"] - 1):
                host = lay.gather_to_host({"params": params, "opt": opt, "step": s},
                                          lay.state_dims(opt))
                if rank == 0:
                    saved.update({f"{name}/s{s}_{i}": x.numpy() for i, x in
                                  enumerate(tree_lib.leaves(host)) if torch.is_tensor(x)})
        if world == 1:
            # at (1, 1) the port's unsharded step, from the same weights
            whole = M.init_model(cfg, seed=0, device="cpu")
            for i, leaf in enumerate(tree_lib.leaves(whole)):
                leaf.copy_(torch.from_numpy(data[f"p{i}"]))
            plain = steps.make_train_step(cfg, opt_cfg, base_lr=a["lr"], total_steps=a["total"])
            popt = adamw_init(whole, opt_cfg)
            plosses = []
            for b in local:
                whole, popt, pm = plain(whole, popt, b)
                plosses.append(float(pm["loss"]))
            out.setdefault("bitwise", {})[name] = plosses == losses and all(
                torch.equal(x, y) for x, y in zip(tree_lib.leaves(whole),
                                                  tree_lib.leaves(params)))
        out[name] = {"losses": losses, "collectives": dict(m["collectives"]),
                     "collective_bytes": dict(m["collective_bytes"]),
                     "sharded": lay.sharded, "model_sharded": lay.model_sharded,
                     "rows": int(local[0]["tokens"].shape[0])}
    if rank == 0:
        np.savez(a["out"] + "/saved.npz", **saved)
    # -- checkpoints: restore the parent's pieces, check them, save them again ----------
    cfg = port_cfg("qwen3-14b")
    sizes, zero3 = a["ckpt_mesh"]
    mesh, plan = tp(sizes, zero3)
    lay = fsdp.Layout(steps.params_struct(cfg), mesh, plan)
    whole_params = M.init_model(cfg, seed=0, device="cpu")
    local = {"params": lay.shard(whole_params), "step": 0,
             "opt": adamw_init(lay.shard(whole_params), steps.optimizer_config(cfg))}
    whole = {"params": whole_params, "step": 0,
             "opt": adamw_init(whole_params, steps.optimizer_config(cfg))}
    cuts = lay.state_dims(local["opt"])
    full = restore_checkpoint(a["ckpt_src"], 1, whole)
    coord = mesh.coordinate(rank)

    def cut(x, c):
        for dim, axis_name in (() if c is None else ((c.data, "data"), (c.model, "model"))):
            if dim is not None:
                k = x.shape[dim] // mesh.shape[axis_name]
                x = x.narrow(dim, coord[axis_name] * k, k)
        return x

    got = restore_checkpoint(a["ckpt_src"], 1, local, pieces=lay.pieces(cuts))
    for x, y, c in zip(tree_lib.leaves(got), tree_lib.leaves(full), tree_lib.leaves(cuts)):
        assert (torch.equal(x, cut(y, c)) if torch.is_tensor(x) else x == y), c
    sup = Supervisor(None, data_at=None, layout=lay,
                     loop_cfg=TrainLoopConfig(total_steps=1, ckpt_dir=a["out"] + "/ckpt"))
    sup._save(1, got["params"], got["opt"])
    sup._wait()
    out["ckpt"] = {"model_sharded": lay.model_sharded, "sharded": lay.sharded}
    dist.barrier()
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
""")


def _run_group(world, tmp, inputs, ckpt_src):
    store = os.path.join(tmp, f"store{world}")
    out = os.path.join(tmp, f"w{world}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    own = "qwen3-14b-1x2" if world == 2 else None
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, json.dumps(dict(
            rank=r, world=world, store=store, out=out, inputs=inputs, cases=_cases(world),
            ckpt_src=ckpt_src, ckpt_mesh=CKPT_MESH[world], own_grads_case=own, lr=LR,
            total=TOTAL, steps=STEPS, timeout=GROUP_TIMEOUT,
            overrides={"qwen3-14b": {"vocab": port_cfg("qwen3-14b").vocab}}))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=GROUP_TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, results):
        assert p.returncode == 0, se[-4000:]
    return json.loads(results[0][0].strip().splitlines()[-1]), out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The three groups' results, and the parent's checkpoint."""
    tmp = str(tmp_path_factory.mktemp("tp"))
    inputs = {}
    for arch in ARCHS + ("gemma3-1b",):
        path = os.path.join(tmp, f"{arch}.npz")
        _, _, _, tparams, batches = _inputs(arch, B)
        arrays = {f"p{i}": x.numpy() for i, x in enumerate(tree_lib.leaves(tparams))}
        for s, b in enumerate(batches):
            arrays.update({f"b{s}_{k}": v for k, v in b.items()})
        np.savez(path, **arrays)
        inputs[arch] = path
    whole = _whole_state(port_cfg("qwen3-14b"), "float32")
    src = os.path.join(tmp, "w0")
    save_checkpoint(src, 1, whole)
    out = {"tmp": tmp, "whole": whole}
    for world in (1, 2, 4):
        out[world] = _run_group(world, tmp, inputs, src)
    return out


_GRADS = {}


def _reference_grads(arch):
    """The reference's gradient of the loss at the initial parameters on
    the first batch, in the port's layout."""
    if arch not in _GRADS:
        rcfg, rparams, tcfg, _, batches = _inputs(arch, B)
        grads = jax.grad(RM.loss_fn)(rparams, rcfg,
                                     {k: jnp.asarray(v) for k, v in batches[0].items()})
        _GRADS[arch] = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, grads),
                                                    tcfg, "cpu")
    return _GRADS[arch]


def _case_params():
    return [pytest.param(world, c, id=f"w{world}-{c[0]}") for world in (1, 2, 4)
            for c in _cases(world)]


@pytest.mark.parametrize("world,case", _case_params())
def test_tp_steps_match_reference(groups, world, case):
    name, arch, sizes, zero3 = case
    res, out = groups[world]
    tparams, rlosses, after = _reference(arch, B)
    got = res[name]
    np.testing.assert_allclose(got["losses"], rlosses, **LOSS_TOL)
    n = len(tree_lib.leaves(tparams))
    # the model axis holds q / k / v / o, the MLP, the embedding and the head
    cfg = port_cfg(arch)
    layer = 7 + (3 if cfg.qkv_bias else 0)
    assert got["model_sharded"] == (1 if cfg.tie_embeddings else 2) + cfg.n_layers * layer
    assert (got["sharded"] > 0) == zero3
    assert got["rows"] == B // sizes[0]            # model ranks share their data rank's rows
    saved = np.load(os.path.join(out, "saved.npz"))
    grads = tree_lib.unflatten(tparams, [torch.from_numpy(saved[f"{name}/g{i}"])
                                         for i in range(n)])
    _assert_trees_close(grads, _reference_grads(arch), GRAD_RTOL, f"{name} grad")
    for s in (0, STEPS - 1):
        # {"opt": {"count", "m", "v"}, "params", "step"}'s tensor leaves
        leaves = [torch.from_numpy(saved[f"{name}/s{s}_{i}"]) for i in range(3 * n + 1)]
        assert int(leaves[0]) == s + 1 and f"{name}/s{s}_{3 * n + 1}" not in saved.files
        m, v, p = (tree_lib.unflatten(tparams, leaves[1 + k * n:1 + (k + 1) * n])
                   for k in range(3))
        want = after[s]
        _assert_trees_close(m, want["m"], GRAD_RTOL, f"{name} m step {s + 1}")
        _assert_trees_close(v, want["v"], GRAD_RTOL, f"{name} v step {s + 1}")
        for (path, g), w, mm in zip(tree_lib.leaves_with_paths(p),
                                    tree_lib.leaves(want["params"]),
                                    tree_lib.leaves(want["m"])):
            diff = (g - w).abs()
            live = mm.abs() > GRAD_RTOL * float(mm.abs().max())
            if bool(live.any()):
                bar = (CANCELLING_BAR if path[-1] in CANCELLING.get(arch, ())
                       else 1e-6 + 1e-3 * LR)
                assert float(diff[live].max()) <= bar, (name, s, path)
            assert float(diff.max()) <= 2 * LR, (name, s, path)


def test_tp_at_one_rank_is_the_unsharded_step_bit_for_bit(groups):
    """At (1, 1) the operators run with their collectives over a one-rank
    group, and the vocab-parallel cross-entropy is log_softmax's, forward
    and backward: three steps' losses and parameters equal the port's
    unsharded `make_train_step`'s bit for bit, for each arch."""
    assert groups[1][0]["bitwise"] == {c[0]: True for c in _cases(1)}


@pytest.mark.parametrize("world,case", _case_params())
def test_tp_collectives_match_the_meta_trace(groups, world, case):
    """Rank 0's step on the meta device (`make_sharded_train_step(rank=0)`,
    its collectives counted, not run) counts the collectives the gloo run
    made, call for call and byte for byte, and launches the hand kernels
    (their meta routes) as often as the unsharded step."""
    name, arch, sizes, zero3 = case
    got = groups[world][0][name]
    cfg = port_cfg(arch)
    mesh, plan = tp_plan(sizes, zero3)
    opt_cfg = tsteps.optimizer_config(cfg)
    step = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, rank=0)
    params = step.layout.shard(tsteps.params_struct(cfg))
    rows = B // sizes[0]
    batch = {k: torch.zeros((rows, 32), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    batch["mask"] = torch.zeros((rows, 32), device="meta")
    cost = step_cost.analyze(step, params, adamw_init(params, opt_cfg), batch)
    assert dict(step.layout.collectives) == got["collectives"]
    assert dict(step.layout.collective_bytes) == got["collective_bytes"]
    whole = tsteps.params_struct(cfg)
    ref = step_cost.analyze(tsteps.make_train_step(cfg, opt_cfg), whole,
                            adamw_init(whole, opt_cfg), batch)
    assert cost.launches == ref.launches and cost.launches["gemm"] > 0


@pytest.mark.parametrize("world", [1, 2, 4])
def test_vocab_parallel_operators(groups, world):
    """`vocab_log_likelihood` and `vocab_embed` at a model axis of 1, 2 and
    4 ranks against log_softmax + gather and F.embedding, values and
    gradients; one all-reduce each for the max, the sum, the label's logit
    and the lookup, none in their backwards."""
    v = groups[world][0]["vocab"]
    for key in ("ll", "dlogits", "embed", "dtable"):
        assert v[key] <= VOCAB_TOL, (key, v)
    assert v["collectives"] == {"all_reduce": 4}


def test_replicated_leaves_rule(groups):
    """qwen3-14b at (1, 2), each rank's own gradients before they are
    summed: a norm on the residual stream gets its whole gradient on both
    model ranks (summed over the data axes only); q_norm / k_norm, applied
    to a rank's own heads, get parts that sum to the whole (summed over
    the model axis too: `Layout.partial`)."""
    res = groups[2][0]
    mine = res["own_grads"]
    want = _reference_grads("qwen3-14b")
    flat = {"/".join(map(str, p)): w for p, w in tree_lib.leaves_with_paths(want)}
    assert set(mine[0]) == {"final_norm", "layers/0/norm1", "layers/1/norm1",
                            "layers/0/mixer/q_norm", "layers/0/mixer/k_norm",
                            "layers/1/mixer/q_norm", "layers/1/mixer/k_norm"}
    for path in mine[0]:
        a, b = (np.asarray(m[path]) for m in mine)
        w = flat[path].numpy()
        tol = GRAD_RTOL * float(np.abs(w).max())
        partial = path.endswith("_norm") and "mixer" in path
        assert res["partial"][path] == partial
        if partial:
            np.testing.assert_allclose(a + b, w, rtol=0, atol=tol, err_msg=path)
            assert float(np.abs(a - b).max()) > 10 * tol, path   # truly parts
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
            np.testing.assert_allclose(a, w, rtol=0, atol=tol, err_msg=path)
    assert sum(res["partial"].values()) == 4


def test_checkpoints_are_byte_equal_across_meshes(groups):
    """One checkpoint restored as pieces at (1, 1), (1, 2) and (2, 2) with
    ZeRO-3, and written again from them: every file equals the parent's,
    byte for byte, and restores bit for bit."""
    tmp, whole = groups["tmp"], groups["whole"]
    base = os.path.join(tmp, "w0", "step_1")
    for world in (1, 2, 4):
        res = groups[world][0]["ckpt"]
        assert res["model_sharded"] > 0 and (res["sharded"] > 0) == (world == 4)
        d = os.path.join(tmp, f"w{world}", "ckpt", "step_1")
        assert sorted(os.listdir(d)) == sorted(os.listdir(base))
        for f in os.listdir(base):
            with open(os.path.join(d, f), "rb") as a, open(os.path.join(base, f), "rb") as b:
                assert a.read() == b.read(), (world, f)
        back = restore_checkpoint(os.path.join(tmp, f"w{world}", "ckpt"), 1, whole)
        for x, y in zip(tree_lib.leaves(back), tree_lib.leaves(whole)):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y


# -- without a process group --------------------------------------------------------

def test_model_functions_unchanged_outside_a_model_axis():
    """Under dp-mode rules, and under tp-mode rules without a model axis,
    loss_fn and its gradients are the same bits as with no rules."""
    cfg = port_cfg("qwen3-14b")
    _, _, _, tparams, batches = _inputs("qwen3-14b", B)
    batch = to_device(batches[0], "cpu")
    leaves = tree_lib.leaves(tparams)

    def run():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = TM.loss_fn(tparams, cfg, batch)
            return [loss.detach()] + list(torch.autograd.grad(loss, leaves))
        finally:
            for p in leaves:
                p.requires_grad_(False)

    want = run()
    for mode in ("dp", "tp"):
        mesh = MeshShape(("data", "model"), (2, 2))
        plan = make_plan(mesh, 10**12, force_mode=mode)
        with use_rules(mesh, plan.activation_rules()), tensor.use_model_axis(None):
            got = run()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), mode


def test_rank_rows_give_model_ranks_equal_rows():
    """Under a tp plan at (2, 2) the batch splits over the data axis only:
    ranks 0 and 1 (data 0) hold rows 0-1, ranks 2 and 3 rows 2-3."""
    mesh, plan = tp_plan((2, 2), False)
    batch = {"tokens": np.arange(4)[:, None] * np.ones((1, 5), np.int32)}
    rows = [rank_rows(batch, mesh, plan, r)["tokens"][:, 0].tolist() for r in range(4)]
    assert rows == [[0, 1], [0, 1], [2, 3], [2, 3]]


def _refused(cfg, sizes, **kw):
    mesh = MeshShape(("data", "model"), sizes)
    plan = make_plan(mesh, 10**12, force_mode="tp", **kw)
    with pytest.raises(NotImplementedError, match="A.4c") as e:
        tsteps.make_sharded_train_step(cfg, None, mesh, plan)
    return str(e.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_attn_seq_builds_a_step_where_head_tp_is_refused(arch, monkeypatch):
    """At (1, 4) the smoke configs' 2 kv heads take sequence-parallel
    attention (make_plan's rule), which builds a step
    (tests/test_torch_parallel_sp.py trains it) where the axis divides d_ff
    and the vocabulary (not qwen3-14b's 250 tokens: refused); forced to
    head-TP they do not divide the axis and are refused, and under attn_seq
    a sequence length the axis does not divide is refused, each before any
    weight is made."""
    cfg = port_cfg(arch)
    mesh = MeshShape(("data", "model"), (1, 4))
    plan = make_plan(mesh, 10**12, force_mode="tp", n_kv_heads=cfg.n_kv_heads)
    assert plan.attn_seq
    if cfg.vocab % 4 == 0:
        step = tsteps.make_sharded_train_step(cfg, None, mesh, plan, rank=0, seq_len=32)
        assert step.layout.model.seq and step.layout.model.size == 4
    made = []
    monkeypatch.setattr(TM, "init_model", lambda *a, **k: made.append(1))
    if cfg.vocab % 4:
        assert "250 vocab do not divide" in _refused(cfg, (1, 4), n_kv_heads=cfg.n_kv_heads)
    else:
        with pytest.raises(NotImplementedError, match="sequence of 30 .* axis of 4"):
            tsteps.make_sharded_train_step(cfg, None, mesh, plan, rank=0, seq_len=30)
    assert "2 kv heads do not divide" in _refused(cfg, (1, 4), force_attn_seq=False)
    assert not made
    # at (1, 2) make_plan takes head-TP, which trains (test_tp_steps_match_reference)
    mesh = MeshShape(("data", "model"), (1, 2))
    assert not make_plan(mesh, 10**12, n_kv_heads=cfg.n_kv_heads).attn_seq


@pytest.mark.parametrize("arch,why", [
    ("dbrx-132b", "MoE under a model axis"), ("arctic-480b", "MoE under a model axis"),
    ("jamba-1.5-large-398b", "MoE under a model axis"), ("xlstm-1.3b", "'ssm' family"),
    ("whisper-medium", "'encdec' family"), ("paligemma-3b", "'vlm' family"),
    ("bert-base", "gelu MLP"), ("vit-b-16", "gelu MLP")])
def test_other_archs_under_a_model_axis_are_refused(arch, why, monkeypatch):
    """MoE under a model axis, the other families and the GELU MLP: refused
    naming A.4c, before any weight is made."""
    made = []
    monkeypatch.setattr(TM, "init_model", lambda *a, **k: made.append(1))
    assert why in _refused(tconfigs.get_smoke(arch), (1, 2))
    assert not made


def test_int8_moments_under_a_model_axis_are_refused():
    mesh, plan = tp_plan((1, 2), False)
    with pytest.raises(NotImplementedError, match="int8 moments.*A.4c"):
        fsdp.Layout(tsteps.params_struct(port_cfg("qwen3-14b")), mesh, plan,
                    int8_moments=True, rank=0)


def _above_tp_threshold(mesh, param_count, **kw):
    """The CLI's `make_plan` call, with every arch counted above make_plan's
    4e9-parameter tp threshold, so a smoke config takes the plan its full
    size takes."""
    return make_plan(mesh, 10**12, **kw)


def test_train_cli_refusals_before_making_weights(monkeypatch):
    """The CLI over a patched world of 4, with every arch above the tp
    threshold: qwen3-14b's smoke config at --model-parallel 4 (2 kv heads),
    xlstm-1.3b at 2 and dbrx-132b at 2 (MoE) raise before init_model."""
    made = []
    monkeypatch.setattr(TM, "init_model", lambda *a, **k: made.append(1))
    monkeypatch.setattr(tmesh, "world", lambda: (0, 4))
    monkeypatch.setattr(ttrain, "make_plan", _above_tp_threshold)
    for arch, preset, mp, why in (
            ("qwen3-14b", "smoke", 4, "kv heads do not divide"),
            ("xlstm-1.3b", "smoke", 2, "'ssm' family"),
            ("dbrx-132b", "full", 2, "MoE under a model axis")):
        with pytest.raises(NotImplementedError, match=why):
            ttrain._train(ttrain.argparse.Namespace(arch=arch, preset=preset, model_parallel=mp),
                          torch.device("cpu"), None)
    assert not made


# torchrun's entry for the CLI test below: the CLI's own `main`, with the
# smoke config counted above the tp threshold as in _above_tp_threshold.
ABOVE_TP_MAIN = textwrap.dedent("""
    import sys
    from repro_torch.launch import train
    from repro_torch.parallel import sharding
    train.make_plan = lambda mesh, n, **kw: sharding.make_plan(mesh, 10**12, **kw)
    train.main(sys.argv[1:])
""")


def test_train_cli_tensor_parallel_over_two_ranks(tmp_path, capsys):
    """`--model-parallel 2` under torchrun over two gloo ranks (qwen3-14b
    smoke counted above the tp threshold, a failure injected at step 7,
    restored from the pieces of the step-5 checkpoint): rank 0 alone prints
    the tp mesh, the last loss is the world-1 run's within the step bar,
    and the checkpoint holds whole leaves."""
    argv = ["--device", "cpu", "--arch", "qwen3-14b", "--preset", "smoke", "--steps", "10",
            "--batch", "4", "--seq", "16", "--lr", "3e-3", "--ckpt-every", "5"]
    one = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    entry = tmp_path / "above_tp_main.py"
    entry.write_text(ABOVE_TP_MAIN)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         str(entry)] + argv + [
            "--ckpt-dir", str(tmp_path / "two"), "--fail-at", "7", "--model-parallel", "2"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("arch=qwen3-14b") == 1
    assert "'data': 1, 'model': 2} mode=tp" in out.stdout
    summary = json.loads(out.stdout[out.stdout.index("{\n"):])
    assert summary["steps"] == 10 and summary["restarts"] == 1
    np.testing.assert_allclose(summary["last_loss"], one["metrics"][-1]["loss"], **LOSS_TOL)
    back = restore_checkpoint(str(tmp_path / "two"), 10, {
        "params": one["params"], "opt": one["opt_state"], "step": 0})
    assert back["step"] == 10 and int(back["opt"]["count"]) == 10
    for x, y in zip(tree_lib.leaves(back["params"]), tree_lib.leaves(one["params"])):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), y.detach().numpy(), rtol=0, atol=2 * 3e-3 * 10)
