"""Sequence-parallel attention (`attn_seq`) of the dense decoders over gloo
process groups on the CPU, alone and with ZeRO-3 over the data axis,
against the reference's unsharded jitted step; the sequence operators,
the replicated leaves' rule under the sequence rules, and each rank's
collectives and kernel work against its meta trace.

Three groups are started, of 1, 2 and 4 ranks, as in
`tests/test_torch_parallel_tp.py` (`python -c` workers meeting at a
`file://` store under the test's temporary directory, no TCP port, a
timeout on the group and on the parent's wait), each running every case
below before it exits.  A case is an arch's f32 smoke config (the bridged
reference parameters of `test_torch_train._models`; qwen3-14b with a
250-token vocab) under a tp-mode plan with `attn_seq`, forced or by
`make_plan`'s own rule (kv heads that do not divide the model axis):
  * (1, 1): qwen3-14b, qwen2.5-14b, mistral-nemo-12b and gemma3-1b forced,
    each also held bit for bit to the port's unsharded step;
  * (1, 2): the three forced, gemma3-1b (1 kv head, window 8, tied table)
    by the rule;
  * (1, 4): qwen2.5-14b, mistral-nemo-12b and gemma3-1b by the rule
    (qwen3-14b's 250-token vocabulary does not divide 4:
    test_torch_parallel_tp.py holds that refusal);
  * (2, 2): qwen3-14b forced and gemma3-1b by the rule, each with and
    without ZeRO-3.
Each rank trains its rows (`data.rank_rows`: the whole sequence of its
data rank's rows) through `make_sharded_train_step`; rank 0 gathers the
whole gradient of step 1 and the whole parameters and AdamW moments after
steps 1 and 3, which the parent holds, with the losses, to the reference's
`make_train_step`, jitted and unsharded, with the bars of
`tests/test_torch_train.py::check_train_step` (as test_torch_parallel_tp
applies them, its one loosened leaf included).  Every rank's collectives
of step 3 are held to the meta trace of the same rank's step, and the
traced K5 / K5b work of the ranks (each at its chunk's q offset) sums to
the unsharded step's."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.data import to_device
from repro_torch.kernels import cost as kcost
from repro_torch.launch import step_cost
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init
from repro_torch.parallel import tensor
from repro_torch.parallel.logical import use_rules
from repro_torch.parallel.sharding import make_plan
from test_torch_parallel_tp import (B, CANCELLING, CANCELLING_BAR, GROUP_TIMEOUT, ROOT,
                                    _reference_grads, port_cfg)
from test_torch_parallel_train import LR, STEPS, TOTAL, _inputs, _reference
from test_torch_train import GRAD_RTOL, LOSS_TOL, _assert_trees_close

ARCHS = ("qwen3-14b", "qwen2.5-14b", "mistral-nemo-12b", "gemma3-1b")
SEQ = 32                     # the batches' sequence length (test_torch_parallel_train)
OPERATOR_TOL = 1e-6          # the sequence operators against whole tensors, f32


def _cases(world):
    """(name, arch, mesh sizes, fsdp, by make_plan's rule) of one group."""
    if world == 1:
        return [(f"{a}-1x1", a, (1, 1), False, False) for a in ARCHS]
    if world == 2:
        return [(f"{a}-1x2", a, (1, 2), False, a == "gemma3-1b") for a in ARCHS]
    return ([(f"{a}-1x4", a, (1, 4), False, True)
             for a in ("qwen2.5-14b", "mistral-nemo-12b", "gemma3-1b")]
            + [(f"{a}-2x2" + ("-zero3" if z else ""), a, (2, 2), z, a == "gemma3-1b")
               for a in ("qwen3-14b", "gemma3-1b") for z in (False, True)])


def sp_plan(cfg, sizes, zero3, rule):
    """The attn_seq plan over (data, model) = `sizes`: by make_plan's rule
    from the kv heads, or forced."""
    mesh = MeshShape(("data", "model"), tuple(sizes))
    kw = {"n_kv_heads": cfg.n_kv_heads} if rule else {"force_attn_seq": True}
    plan = make_plan(mesh, 10**12, force_mode="tp", force_fsdp=zero3, **kw)
    assert plan.attn_seq
    return mesh, plan


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
    from repro_torch.data import rank_rows, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import tensor
    from repro_torch.parallel.sharding import make_plan

    rank, world = a["rank"], a["world"]

    def port_cfg(arch):
        return dataclasses.replace(configs.get_smoke(arch), **a["overrides"].get(arch, {}))

    def sp(cfg, sizes, zero3, rule):
        mesh = MeshShape(("data", "model"), tuple(sizes))
        kw = {"n_kv_heads": cfg.n_kv_heads} if rule else {"force_attn_seq": True}
        plan = make_plan(mesh, 10**12, force_mode="tp", force_fsdp=zero3, **kw)
        assert plan.attn_seq
        return mesh, plan

    out = {}
    # -- the sequence operators at a model axis of the group's size ----------------
    # Every rank draws every rank's arrays from one seed, so each can say
    # what the sums over the ranks must be.
    rng = np.random.default_rng(9)
    Bo, s, d, V = 2, 3, 5, 8 * world
    S = s * world
    draw = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = draw(Bo, S, d)                                # the whole sequence
    up = [draw(Bo, S, d) for _ in range(world)]       # each rank's gradient of the gather
    ys = [draw(Bo, S, d) for _ in range(world)]       # each rank's partial sums
    hs = [draw(Bo, s, d) for _ in range(world)]       # each rank's gradient of its chunk
    table = draw(V, d)
    tokens = torch.from_numpy(rng.integers(0, V, (Bo, S)))
    gx = [draw(Bo, s, d) for _ in range(world)]
    chunk = slice(rank * s, (rank + 1) * s)
    axis = tensor.ModelAxis(size=world, index=rank, seq=True)
    with tensor.use_model_axis(axis):
        mine = x[:, chunk].clone().requires_grad_(True)
        whole = tensor.gather_seq(mine)
        (whole * up[rank]).sum().backward()
        y = ys[rank].clone().requires_grad_(True)
        part = tensor.reduce_from_model(y)
        (part * hs[rank]).sum().backward()
        n = V // world
        piece = table[rank * n:(rank + 1) * n].clone().requires_grad_(True)
        emb = tensor.vocab_embed(tokens, piece, axis)
        (emb * gx[rank]).sum().backward()
        offset = tensor.seq_offset(s)
    offsets = [None] * world
    dist.all_gather_object(offsets, offset)
    wtable = table.clone().requires_grad_(True)
    F.embedding(tokens, wtable).backward(torch.cat(gx, dim=1))
    err = lambda t, w: float((t - w).abs().max())
    out["operators"] = {
        "gather": err(whole, x),
        "gather_grad": err(mine.grad, sum(u[:, chunk] for u in up)),
        "reduce_scatter": err(part, sum(v[:, chunk] for v in ys)),
        "reduce_scatter_grad": err(y.grad, torch.cat(hs, dim=1)),
        "embed": err(emb, F.embedding(tokens, table)[:, chunk]),
        "embed_grad": err(piece.grad, wtable.grad[rank * n:(rank + 1) * n]),
        "offsets": offsets, "collectives": dict(axis.collectives),
        "collective_bytes": dict(axis.collective_bytes)}
    # -- the train cases ----------------------------------------------------------
    saved = {}
    for name, arch, sizes, zero3, rule in a["cases"]:
        cfg = port_cfg(arch)
        data = np.load(a["inputs"][arch])
        params = M.init_model(cfg, seed=0, device="cpu")
        for i, leaf in enumerate(tree_lib.leaves(params)):
            leaf.copy_(torch.from_numpy(data[f"p{i}"]))
        mesh, plan = sp(cfg, sizes, zero3, rule)
        opt_cfg = steps.optimizer_config(cfg)
        step = steps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=a["lr"],
                                             total_steps=a["total"], seq_len=a["seq"])
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
                    if p[-1] in ("final_norm", "norm1", "wq", "q_norm")}
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
        calls = [None] * world
        dist.all_gather_object(calls, [dict(m["collectives"]), dict(m["collective_bytes"])])
        out[name] = {"losses": losses, "collectives": calls,
                     "sharded": lay.sharded, "model_sharded": lay.model_sharded,
                     "rows": int(local[0]["tokens"].shape[0]),
                     "seq": int(local[0]["tokens"].shape[1])}
    if rank == 0:
        np.savez(a["out"] + "/saved.npz", **saved)
    dist.barrier()
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
""")


def _run_group(world, tmp, inputs):
    store = os.path.join(tmp, f"store{world}")
    out = os.path.join(tmp, f"w{world}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    own = "qwen3-14b-1x2" if world == 2 else None
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, json.dumps(dict(
            rank=r, world=world, store=store, out=out, inputs=inputs, cases=_cases(world),
            own_grads_case=own, lr=LR, total=TOTAL, steps=STEPS, seq=SEQ,
            timeout=GROUP_TIMEOUT,
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
    """The three groups' results."""
    tmp = str(tmp_path_factory.mktemp("sp"))
    inputs = {}
    for arch in ARCHS:
        path = os.path.join(tmp, f"{arch}.npz")
        _, _, _, tparams, batches = _inputs(arch, B)
        assert all(b["tokens"].shape[1] == SEQ for b in batches)
        arrays = {f"p{i}": x.numpy() for i, x in enumerate(tree_lib.leaves(tparams))}
        for s, b in enumerate(batches):
            arrays.update({f"b{s}_{k}": v for k, v in b.items()})
        np.savez(path, **arrays)
        inputs[arch] = path
    return {world: _run_group(world, tmp, inputs) for world in (1, 2, 4)}


def _case_params():
    return [pytest.param(world, c, id=f"w{world}-{c[0]}") for world in (1, 2, 4)
            for c in _cases(world)]


@pytest.mark.parametrize("world,case", _case_params())
def test_sp_steps_match_reference(groups, world, case):
    """Loss, the whole gradient of step 1, and params / m / v after steps 1
    and 3 against the reference's jitted unsharded step
    (test_torch_parallel_tp's bars); the model axis holds the MLP, the
    embedding and the untied head, not the attention projections; each
    model rank takes its data rank's rows, whole over the sequence."""
    name, arch, sizes, zero3, _ = case
    res, out = groups[world]
    tparams, rlosses, after = _reference(arch, B)
    got = res[name]
    np.testing.assert_allclose(got["losses"], rlosses, **LOSS_TOL)
    n = len(tree_lib.leaves(tparams))
    cfg = port_cfg(arch)
    assert got["model_sharded"] == (1 if cfg.tie_embeddings else 2) + cfg.n_layers * 3
    assert (got["sharded"] > 0) == zero3
    assert got["rows"] == B // sizes[0] and got["seq"] == SEQ
    saved = np.load(os.path.join(out, "saved.npz"))
    grads = tree_lib.unflatten(tparams, [torch.from_numpy(saved[f"{name}/g{i}"])
                                         for i in range(n)])
    _assert_trees_close(grads, _reference_grads(arch), GRAD_RTOL, f"{name} grad")
    for s in (0, STEPS - 1):
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


def test_sp_at_one_rank_is_the_unsharded_step_bit_for_bit(groups):
    """At (1, 1) the sequence operators gather and reduce-scatter over a
    one-rank group and attention runs at q offset 0: three steps' losses
    and parameters equal the port's unsharded `make_train_step`'s bit for
    bit, for each arch."""
    assert groups[1][0]["bitwise"] == {c[0]: True for c in _cases(1)}


def _meta_step(cfg, sizes, zero3, rule, rank):
    """Rank `rank`'s step traced on the meta device: (the step, its
    StepCost, the K5 and K5b operations it counted)."""
    mesh, plan = sp_plan(cfg, sizes, zero3, rule)
    opt_cfg = tsteps.optimizer_config(cfg)
    step = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, rank=rank)
    params = step.layout.shard(tsteps.params_struct(cfg))
    return step, *_traced(step, params, adamw_init(params, opt_cfg), B // sizes[0])


def _traced(step, params, opt, rows):
    batch = {k: torch.zeros((rows, SEQ), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    batch["mask"] = torch.zeros((rows, SEQ), device="meta")
    work = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}

    def sink(kernel, c):
        if kernel in work:
            work[kernel] += c.ops

    with kcost.recording(sink):
        cost = step_cost.analyze(step, params, opt, batch)
    return cost, work


@pytest.mark.parametrize("world,case", _case_params())
def test_sp_collectives_match_the_meta_trace(groups, world, case):
    """Each rank's step on the meta device (`make_sharded_train_step(rank=)`,
    its collectives counted, not run) counts the collectives that rank's
    gloo run made, call for call and byte for byte, and launches the hand
    kernels as often as the unsharded step; K5 and K5b score each rank's
    chunk of queries at its q offset, so under causal masks a later rank
    does more of their work, and the ranks of one data rank together do
    the unsharded step's."""
    name, arch, sizes, zero3, rule = case
    got = groups[world][0][name]["collectives"]
    cfg = port_cfg(arch)
    model = sizes[1]
    opt_cfg = tsteps.optimizer_config(cfg)
    whole = tsteps.params_struct(cfg)
    ref, ref_work = _traced(tsteps.make_train_step(cfg, opt_cfg), whole,
                            adamw_init(whole, opt_cfg), B // sizes[0])
    works = []
    for r in range(model):            # the model ranks of data rank 0
        step, c, work = _meta_step(cfg, sizes, zero3, rule, r)
        assert [dict(step.layout.collectives), dict(step.layout.collective_bytes)] == got[r], r
        assert c.launches == ref.launches and c.launches["flash_attention_bwd"] > 0
        works.append(work)
    for r in range(model, world):     # the other data rank's: the same as its model peer's
        step, *_ = _meta_step(cfg, sizes, zero3, rule, r)
        assert [dict(step.layout.collectives), dict(step.layout.collective_bytes)] == got[r], r
    for k in ref_work:
        assert sum(w[k] for w in works) == pytest.approx(ref_work[k], rel=1e-12), k
        assert all(a[k] < b[k] for a, b in zip(works, works[1:])), (k, works)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sequence_operators(groups, world):
    """`gather_seq`, `reduce_from_model` (a reduce-scatter under a
    sequence-parallel axis) and the vocab-parallel lookup reduced to a
    chunk, at a model axis of 1, 2 and 4 ranks, against the
    whole tensors and the sums over the ranks, values and gradients; one
    all-gather or reduce-scatter each way of each, and `seq_offset` the
    first position of each rank's chunk."""
    v = groups[world][0]["operators"]
    for key in ("gather", "gather_grad", "reduce_scatter", "reduce_scatter_grad", "embed",
                "embed_grad"):
        assert v[key] <= OPERATOR_TOL, (key, v)
    assert v["offsets"] == [3 * r for r in range(world)]      # each rank's chunk of 3
    assert v["collectives"] == {"all_gather": 3, "reduce_scatter": 3}
    # bytes: the gathered and the stacked (B, S, d) f32, three times each
    whole = 2 * 3 * world * 5 * 4
    assert v["collective_bytes"] == {"all_gather": 3 * whole, "reduce_scatter": 3 * whole}


def test_replicated_leaves_rule_under_attn_seq(groups):
    """qwen3-14b at (1, 2), each rank's own gradients before they are
    summed: every leaf the model axis replicates (the norms, wq, q_norm) is
    applied to a rank's chunk of the sequence only, so the ranks' parts sum
    to the whole gradient and differ (`Layout.partial` marks each)."""
    res = groups[2][0]
    mine = res["own_grads"]
    want = _reference_grads("qwen3-14b")
    flat = {"/".join(map(str, p)): w for p, w in tree_lib.leaves_with_paths(want)}
    assert set(mine[0]) == {"final_norm", "layers/0/norm1", "layers/1/norm1",
                            "layers/0/mixer/wq", "layers/1/mixer/wq",
                            "layers/0/mixer/q_norm", "layers/1/mixer/q_norm"}
    for path in mine[0]:
        a, b = (np.asarray(m[path]) for m in mine)
        w = flat[path].numpy()
        tol = GRAD_RTOL * float(np.abs(w).max())
        assert res["partial"][path]
        np.testing.assert_allclose(a + b, w, rtol=0, atol=tol, err_msg=path)
        assert float(np.abs(a - b).max()) > 10 * tol, path
    split = ("w_gate", "w_up", "w_down", "embed", "head")
    assert all(f == (p.split("/")[-1] not in split) for p, f in res["partial"].items())


def test_model_functions_unchanged_outside_a_model_axis_under_seq_rules():
    """Under the sequence rules without a model axis (no operator runs),
    loss_fn and its gradients are the same bits as with no rules."""
    cfg = port_cfg("gemma3-1b")
    _, _, _, tparams, batches = _inputs("gemma3-1b", B)
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
    mesh, plan = sp_plan(cfg, (1, 4), False, True)
    with use_rules(mesh, plan.activation_rules()), tensor.use_model_axis(None):
        assert not tensor.sequence_parallel() and tensor.seq_offset(8) == 0
        got = run()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
