"""Data-parallel and ZeRO-3 training over gloo process groups on the CPU,
against the reference's unsharded jitted step, and the checkpoints and
train CLI over such groups.

Two groups are started, of 2 and of 4 ranks, each a set of worker
processes (`WORKER`, one rendezvous through a `file://` store under the
test's temporary directory, no TCP port), each running every case below
before it exits.  A case is an arch's f32 smoke config (the bridged
reference parameters of `test_torch_train._models`), a mesh and a plan
(dp: `force_fsdp=False`, every leaf replicated; zero3: the dp-mode
default, leaves sharded by `param_sharding`); its three global batches
carry a 0/1 mask drawn per row, so the ranks' mask counts differ.  Each
rank trains its rows (`data.rank_rows`) through
`make_sharded_train_step`; rank 0 gathers the whole parameters and AdamW
moments after steps 1 and 3.  The parent runs the reference's
`make_train_step`, jitted and unsharded, from the same parameters on the
same global batches and holds the loss, parameters and moments to the
bars `tests/test_torch_train.py::check_train_step` holds the unsharded
port step to (with `FLOOR_OF_TREE` for the families, as
`tests/test_torch_train_families.py` does).  Besides the five archs,
gemma3-1b runs with a batch that no batch axis divides (2 ranks, batch
3: replicated) and one that divides only the data axis of a (2, 2) mesh.

Checkpoints: the parent saves one unsharded state (float and int8
moments); each group restores its pieces of it, checks them against its
own cut of the whole leaves, and saves it again from its pieces; every
file written at world sizes 1, 2 and 4 is byte-equal, and each restores
bit for bit at the others."""

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

from repro.launch import steps as rsteps
from repro.optim import adamw_init as radamw_init
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data import SyntheticLMData, rank_rows, to_device
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import make_plan
from test_torch_train import GRAD_RTOL, LOSS_TOL, _assert_trees_close, _cfgs, _models
from test_torch_train_families import FLOOR_OF_TREE, family_batch

ROOT = os.path.join(os.path.dirname(__file__), "..")
LR, TOTAL, STEPS = 3e-3, 10, 3
ARCHS = ("gemma3-1b", "qwen3-14b", "xlstm-1.3b", "whisper-medium", "paligemma-3b")
FLOORS = {"xlstm-1.3b": FLOOR_OF_TREE, "whisper-medium": FLOOR_OF_TREE,
          "paligemma-3b": FLOOR_OF_TREE}
GROUP_TIMEOUT = 240          # seconds a group may take, under a test's 300


def _cases(world):
    """(name, arch, mesh sizes, fsdp, global batch) of one group."""
    out = [(f"{arch}-{mode}", arch, (world, 1), mode == "zero3", 4)
           for arch in ARCHS for mode in ("dp", "zero3")]
    if world == 2:
        out.append(("gemma3-1b-replicated", "gemma3-1b", (2, 1), True, 3))
    else:
        out.append(("gemma3-1b-data-only", "gemma3-1b", (2, 2), True, 2))
    return out


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    a = json.loads(sys.argv[1])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + a["store"], rank=a["rank"],
                            world_size=a["world"])
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.data import rank_rows, to_device
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model as M
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel import fsdp
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.runtime import Supervisor, TrainLoopConfig
    import dataclasses
    from repro_torch import configs

    def port_cfg(arch):
        return dataclasses.replace(configs.get_smoke(arch), **a["overrides"].get(arch, {}))

    rank = a["rank"]
    LR, TOTAL, STEPS = a["lr"], a["total"], a["steps"]
    out = {}
    for name, arch, sizes, zero3, B in a["cases"]:
        cfg = port_cfg(arch)
        data = np.load(a["inputs"][name])
        params = M.init_model(cfg, seed=0, device="cpu")
        for i, leaf in enumerate(tree_lib.leaves(params)):
            leaf.copy_(torch.from_numpy(data[f"p{i}"]))
        mesh = MeshShape(("data", "model"), tuple(sizes))
        plan = make_plan(mesh, cfg.param_count(), force_fsdp=zero3)
        opt_cfg = steps.optimizer_config(cfg)
        step = steps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=LR,
                                             total_steps=TOTAL)
        params = step.layout.shard(params)
        opt = adamw_init(params, opt_cfg)
        losses, saved = [], {}
        for s in range(STEPS):
            batch = {k[3:]: data[k] for k in data.files if k.startswith(f"b{s}_")}
            local = to_device(rank_rows(batch, mesh, plan, rank), "cpu")
            params, opt, m = step(params, opt, local)
            losses.append(float(m["loss"]))
            if s in (0, STEPS - 1):
                tree = {"params": params, "opt": opt, "step": s}
                host = step.layout.gather_to_host(tree, step.layout.state_dims(opt))
                if rank == 0:
                    saved.update({f"s{s}_{i}": x.numpy() for i, x in
                                  enumerate(tree_lib.leaves(host)) if torch.is_tensor(x)})
        if rank == 0:
            np.savez(a["out"] + f"/{name}.npz", **saved)
        out[name] = {"losses": losses, "sharded": step.layout.sharded,
                     "collectives": dict(m["collectives"])}
    # Checkpoints: restore the parent's, check the pieces, save them again.
    for label, state_dtype in (("f32", "float32"), ("int8", "int8")):
        cfg = port_cfg("gemma3-1b")
        mesh = MeshShape(("data", "model"), (a["world"], 1))
        plan = make_plan(mesh, cfg.param_count())
        layout = fsdp.Layout(steps.params_struct(cfg), mesh, plan,
                             int8_moments=state_dtype == "int8")
        whole_params = M.init_model(cfg, seed=0, device="cpu")
        whole_opt = adamw_init(whole_params, AdamWConfig(state_dtype=state_dtype))
        whole = {"params": whole_params, "opt": whole_opt, "step": 0}
        local = {"params": layout.shard(whole_params),
                 "opt": adamw_init(layout.shard(whole_params), AdamWConfig(state_dtype=state_dtype)),
                 "step": 0}
        dims = layout.state_dims(local["opt"])
        for src in a["ckpt_sources"]:
            d = f"{src}/{label}"
            full = restore_checkpoint(d, 1, whole)
            cut = [x if dd is None else
                   x.narrow(dd.data, rank * (x.shape[dd.data] // a["world"]),
                            x.shape[dd.data] // a["world"])
                   for x, dd in zip(tree_lib.leaves(full), tree_lib.leaves(dims))]
            got = restore_checkpoint(d, 1, local, pieces=layout.pieces(dims))
            for x, y in zip(tree_lib.leaves(got), cut):
                assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), (d, label)
            out.setdefault("restored", []).append(f"{src}/{label}")
        sup = Supervisor(None, data_at=None, layout=layout,
                         loop_cfg=TrainLoopConfig(total_steps=1, ckpt_dir=a["out"] + "/" + label))
        sup._save(1, got["params"], got["opt"])
        sup._wait()
        out.setdefault("ckpt_sharded", {})[label] = layout.sharded
    dist.barrier()
    if rank == 0:
        print(json.dumps(out))
    dist.destroy_process_group()
""")


def port_cfg(arch):
    return _cfgs(arch)[1]


def _batches(cfg, B, seed):
    """Three global batches, each with a 0/1 mask drawn per element (rows,
    so ranks, differ in their counts)."""
    out = []
    for s in range(STEPS):
        b = family_batch(cfg, B=B, S=32, seed=seed, cursor=s)
        b["mask"] = (np.random.default_rng(100 * seed + s).random(b["labels"].shape) < 0.6
                     ).astype(np.float32)
        out.append(b)
    return out


def _inputs(arch, B):
    """(port config, the bridged reference parameters, three batches)."""
    rcfg, rparams, tcfg, tparams = _models(arch)
    return rcfg, rparams, tcfg, tparams, _batches(tcfg, B, seed=B)


_REFERENCE = {}


def _reference(arch, B):
    """The reference's three jitted unsharded steps from `_inputs`:
    losses, and the port-layout params / m / v after steps 1 and 3."""
    if (arch, B) in _REFERENCE:
        return _REFERENCE[arch, B]
    rcfg, rparams, tcfg, tparams, batches = _inputs(arch, B)
    opt_cfg = rsteps.optimizer_config(rcfg)
    rstep = jax.jit(rsteps.make_train_step(rcfg, opt_cfg, base_lr=LR, total_steps=TOTAL))
    rs = radamw_init(rparams, opt_cfg)
    to_port = lambda t: bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, t),
                                                     tcfg, "cpu")
    rp, losses, after = rparams, [], {}
    for s, b in enumerate(batches):
        rp, rs, m = rstep(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        if s in (0, STEPS - 1):
            after[s] = {"params": to_port(rp), "m": to_port(rs["m"]), "v": to_port(rs["v"])}
    _REFERENCE[arch, B] = tparams, losses, after
    return _REFERENCE[arch, B]


def _run_group(world, tmp, inputs, cases, ckpt_sources):
    store = os.path.join(tmp, f"store{world}")
    out = os.path.join(tmp, f"w{world}")
    os.makedirs(out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, json.dumps(dict(
            rank=r, world=world, store=store, out=out, inputs=inputs, cases=cases,
            ckpt_sources=ckpt_sources, lr=LR, total=TOTAL, steps=STEPS,
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


def _whole_state(cfg, state_dtype):
    params = TM.init_model(cfg, seed=0, device="cpu")
    for i, p in enumerate(tree_lib.leaves(params)):     # values apart from init's
        p.add_(0.01 * (i + 1))
    opt = adamw_init(params, AdamWConfig(state_dtype=state_dtype))
    g = torch.Generator().manual_seed(7)
    grads = [torch.randn(p.shape, generator=g) for p in tree_lib.leaves(params)]
    from repro_torch.optim import adamw_update
    adamw_update(grads, opt, params, 1e-3, AdamWConfig(state_dtype=state_dtype))
    return {"params": params, "opt": opt, "step": 1}


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups' results and the parent's checkpoints."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    inputs = {}
    for world in (2, 4):
        for name, arch, sizes, _, B in _cases(world):
            path = os.path.join(tmp, f"{arch}-{B}.npz")
            if not os.path.exists(path):
                _, _, _, tparams, batches = _inputs(arch, B)
                arrays = {f"p{i}": x.numpy() for i, x in enumerate(tree_lib.leaves(tparams))}
                for s, b in enumerate(batches):
                    arrays.update({f"b{s}_{k}": v for k, v in b.items()})
                np.savez(path, **arrays)
            inputs[name] = path
    cfg = port_cfg("gemma3-1b")
    whole = {}
    for label, dt in (("f32", "float32"), ("int8", "int8")):
        whole[label] = _whole_state(cfg, dt)
        save_checkpoint(os.path.join(tmp, "w1", label), 1, whole[label])
    out = {"tmp": tmp, "whole": whole}
    out[2] = _run_group(2, tmp, inputs, _cases(2), [os.path.join(tmp, "w1")])
    out[4] = _run_group(4, tmp, inputs, _cases(4),
                        [os.path.join(tmp, "w1"), os.path.join(tmp, "w2")])
    return out


def _case_params(world):
    return [pytest.param(world, c, id=f"w{world}-{c[0]}") for c in _cases(world)]


@pytest.mark.parametrize("world,case", _case_params(2) + _case_params(4))
def test_sharded_steps_match_reference(groups, world, case):
    name, arch, sizes, zero3, B = case
    res, out = groups[world]
    tparams, rlosses, after = _reference(arch, B)
    got = res[name]
    np.testing.assert_allclose(got["losses"], rlosses, **LOSS_TOL)
    n = len(tree_lib.leaves(tparams))
    assert (got["sharded"] > n // 2) if zero3 else got["sharded"] == 0, got["sharded"]
    # a step's collectives: the mask count, the norm and the loss, and per
    # leaf an all-reduce (replicated) or a gather and a reduce-scatter
    calls = got["collectives"]
    assert calls["all_reduce"] == n - got["sharded"] + 3
    assert calls.get("all_gather", 0) == calls.get("reduce_scatter", 0) == got["sharded"]
    saved = np.load(os.path.join(out, f"{name}.npz"))
    floor = FLOORS.get(arch, 0.0)
    for s in (0, STEPS - 1):
        # {"opt": {"count", "m", "v"}, "params", "step"}'s tensor leaves
        leaves = [torch.from_numpy(saved[f"s{s}_{i}"]) for i in range(3 * n + 1)]
        assert int(leaves[0]) == s + 1 and f"s{s}_{3 * n + 1}" not in saved.files
        m, v, p = (tree_lib.unflatten(tparams, leaves[1 + k * n:1 + (k + 1) * n])
                   for k in range(3))
        want = after[s]
        _assert_trees_close(m, want["m"], GRAD_RTOL, f"{name} m step {s + 1}", floor)
        _assert_trees_close(v, want["v"], GRAD_RTOL, f"{name} v step {s + 1}", floor)
        m_floor = floor * max(float(x.abs().max()) for x in tree_lib.leaves(want["m"]))
        for (path, g), w, mm in zip(tree_lib.leaves_with_paths(p),
                                    tree_lib.leaves(want["params"]),
                                    tree_lib.leaves(want["m"])):
            diff = (g - w).abs()
            live = mm.abs() > GRAD_RTOL * max(float(mm.abs().max()), m_floor)
            if bool(live.any()):
                assert float(diff[live].max()) <= 1e-6 + 1e-3 * LR, (name, s, path)
            assert float(diff.max()) <= 2 * LR, (name, s, path)


@pytest.mark.parametrize("label", ["f32", "int8"])
def test_checkpoints_move_between_world_sizes(groups, label):
    tmp, whole = groups["tmp"], groups["whole"][label]
    base = os.path.join(tmp, "w1", label, "step_1")
    assert sorted(groups[2][0]["restored"]) == sorted(
        [os.path.join(tmp, "w1") + f"/{x}" for x in ("f32", "int8")])
    assert len(groups[4][0]["restored"]) == 4           # world 1's and world 2's
    for world in (2, 4):
        assert groups[world][0]["ckpt_sharded"][label] > 0
        d = os.path.join(tmp, f"w{world}", label, "step_1")
        assert sorted(os.listdir(d)) == sorted(os.listdir(base))
        for f in os.listdir(base):
            with open(os.path.join(d, f), "rb") as a, open(os.path.join(base, f), "rb") as b:
                assert a.read() == b.read(), (world, f)
        back = restore_checkpoint(os.path.join(tmp, f"w{world}", label), 1, whole)
        for x, y in zip(tree_lib.leaves(back), tree_lib.leaves(whole)):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y


def test_int8_moments_shard_only_whole_blocks():
    """Under int8 moments a leaf stays replicated unless each piece is
    whole 128-element blocks of its flat order (a dim-0 piece of 128k
    elements)."""
    cfg = port_cfg("gemma3-1b")
    struct = tsteps.params_struct(cfg)
    mesh = MeshShape(("data", "model"), (1, 1))
    plan = make_plan(mesh, cfg.param_count())
    f32 = fsdp.Layout(struct, mesh, plan)
    int8 = fsdp.Layout(struct, mesh, plan, int8_moments=True)
    for x, a, b in zip(tree_lib.leaves(struct), f32.dims, int8.dims):
        shape = tuple(x.shape)
        whole = a is not None and all(n == 1 for n in shape[:a]) and \
            torch.Size(shape).numel() % 128 == 0
        assert b == (a if whole else None), (shape, a, b)
    assert f32.sharded > int8.sharded > 0


def test_rank_rows_follow_batch_sharding():
    """Rows by `batch_spec`: 4 rows over (2, 2) as data x model pieces; 2
    rows over data only (model replicates); 3 rows whole."""
    mesh = MeshShape(("data", "model"), (2, 2))
    plan = make_plan(mesh, 10**9)
    batch = {"tokens": np.arange(4)[:, None] * np.ones((1, 5), np.int32)}
    assert [int(rank_rows(batch, mesh, plan, r)["tokens"][0, 0]) for r in range(4)] == \
        [0, 1, 2, 3]
    two = {"tokens": np.arange(2)[:, None]}
    assert [int(rank_rows(two, mesh, plan, r)["tokens"][0, 0]) for r in range(4)] == \
        [0, 0, 1, 1]
    three = {"tokens": np.arange(3)[:, None], "frames": np.zeros((3, 2, 2))}
    assert all(rank_rows(three, mesh, plan, r)["tokens"].shape == (3, 1) for r in range(4))


# -- the train CLI over two gloo ranks --------------------------------------------

def test_train_cli_two_ranks_prints_the_world_one_summary(tmp_path, capsys):
    """Two gloo ranks under torchrun, with a failure injected at step 7
    (both ranks restore their pieces of the step-5 checkpoint and replay
    steps 6-7): rank 0 alone prints, its summary's loss is the world-1
    run's within the step bars, and the checkpoint holds whole leaves."""
    argv = ["--device", "cpu", "--arch", "gemma3-1b", "--preset", "smoke", "--steps", "10",
            "--batch", "4", "--seq", "16", "--lr", "3e-3", "--ckpt-every", "5"]
    one = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train"] + argv + ["--ckpt-dir", str(tmp_path / "two"),
                                                      "--fail-at", "7"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("arch=gemma3-1b") == 1 and "'data': 2" in out.stdout
    summary = json.loads(out.stdout[out.stdout.index("{\n"):])
    assert summary["steps"] == 10 and summary["restarts"] == 1
    want = one["metrics"][-1]["loss"]
    np.testing.assert_allclose(summary["last_loss"], want, **LOSS_TOL)
    back = restore_checkpoint(str(tmp_path / "two"), 10, {
        "params": one["params"], "opt": one["opt_state"], "step": 0})
    assert back["step"] == 10 and int(back["opt"]["count"]) == 10
    assert all(bool(torch.isfinite(x).all()) for x in tree_lib.leaves(back["params"]))


# -- the refusals -------------------------------------------------------------------

def test_refusals():
    import repro_torch.parallel as par

    for name in ("gpipe", "split_stages"):
        with pytest.raises(AttributeError, match="A.4c"):
            getattr(par, name)
    assert par.make_plan is make_plan
    # MoE over a data axis > 1, before any weight is made; at 1 it trains.
    dbrx = tconfigs.get("dbrx-132b")
    two = MeshShape(("data", "model"), (2, 1))
    with pytest.raises(NotImplementedError, match="A.4c"):
        fsdp.check_plan(dbrx, two, make_plan(two, dbrx.param_count(), force_fsdp=False))
    one = MeshShape(("data", "model"), (1, 1))
    fsdp.check_plan(dbrx, one, make_plan(one, dbrx.param_count(), force_fsdp=False))
    # the refusals of a model axis that stand (tests/test_torch_parallel_tp.py
    # and test_torch_parallel_sp.py hold the plans that now train): MoE under
    # it, a sequence length a sequence-parallel axis does not divide
    tp_mesh = MeshShape(("data", "model"), (1, 2))
    with pytest.raises(NotImplementedError, match="MoE under a model axis.*A.4c"):
        fsdp.check_plan(dbrx, tp_mesh, make_plan(tp_mesh, dbrx.param_count()))
    qwen = tconfigs.get("qwen3-14b")
    fsdp.check_plan(qwen, tp_mesh, make_plan(tp_mesh, qwen.param_count(), force_fsdp=False))
    seq_mesh = MeshShape(("data", "model"), (1, 16))
    seq_plan = make_plan(seq_mesh, qwen.param_count(), n_kv_heads=qwen.n_kv_heads)
    assert seq_plan.attn_seq
    fsdp.check_plan(qwen, seq_mesh, seq_plan, seq_len=4096)
    with pytest.raises(NotImplementedError, match="sequence of 1000 .* axis of 16"):
        tsteps.make_sharded_train_step(qwen, None, seq_mesh, seq_plan, seq_len=1000)
    # backends: NCCL for CUDA, gloo for the CPU, nothing else
    assert tmesh.backend_for("cuda") == "nccl" and tmesh.backend_for("cpu") == "gloo"
    assert tmesh.backend_for(torch.device("cuda", 1)) == "nccl"
    with pytest.raises(ValueError, match="backend"):
        tmesh.backend_for("meta")
    # meshes
    assert tmesh.make_local_mesh(1) == MeshShape(("data", "model"), (1, 1))
    with pytest.raises(ValueError, match="divide"):
        tmesh.make_local_mesh(2)
    with pytest.raises(ValueError, match="256"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="512"):
        tmesh.make_production_mesh(multi_pod=True)


def test_train_cli_refuses_moe_over_two_ranks_before_making_weights(monkeypatch):
    """dbrx-132b at a data axis of 2, and under a model axis of 2: the CLI
    raises before init_model (the world's size read from a patched group;
    no process starts)."""
    made = []
    monkeypatch.setattr(TM, "init_model", lambda *a, **k: made.append(1))
    monkeypatch.setattr(tmesh, "world", lambda: (0, 2))
    with pytest.raises(NotImplementedError, match="MoE"):
        ttrain._train(ttrain.argparse.Namespace(
            arch="dbrx-132b", preset="full", model_parallel=1), torch.device("cpu"), None)
    with pytest.raises(NotImplementedError, match="MoE under a model axis"):
        ttrain._train(ttrain.argparse.Namespace(
            arch="dbrx-132b", preset="full", model_parallel=2), torch.device("cpu"), None)
    assert not made
