"""The port's checkpoints, supervisor and train CLI on the CPU.

Checkpoints round-trip exactly (bf16 leaves through f32, a row-padded
matrix back row-padded, BlockQ moments, the step number), keep the last N,
never read a half-written `.tmp`, and save asynchronously with a write's
error raised at the next wait.  The supervisor's clean run, and a failure
at step k followed by a restore from the latest checkpoint, give the same
per-step losses bit for bit, on a toy model and on the gemma3-1b smoke
model through the real train step.  The train CLI on the CPU (the port's
form of the reference's `test_system.py::test_training_loss_decreases` and
`::test_train_determinism`, which fail on this host: ROADMAP C.5) lowers
the loss by more than 0.2 in 40 steps and gives identical runs twice; it
defaults to CUDA and raises without one."""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint import store as tstore
from repro_torch.data import SyntheticLMData, to_device
from repro_torch.kernels import gemm as tgemm
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as TM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime import Supervisor, TrainLoopConfig


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _tree():
    g = torch.Generator().manual_seed(0)
    padded = tgemm.aligned_rows(torch.randn((5, 7), generator=g))   # rows padded to 8
    opt = adamw_init({"w": torch.randn((3, 130), generator=g)}, AdamWConfig(state_dtype="int8"))
    return {
        "a": torch.randn((8, 4), generator=g),
        "nested": {"b": torch.arange(6, dtype=torch.int32),
                   "c": torch.randn((3,), generator=g).to(torch.bfloat16)},
        "layers": [{"w": padded}, {"w": torch.randn((2, 2), generator=g)}],
        "opt": opt,
        "step": 11,
    }


def test_checkpoint_roundtrip_exact(tmp_ckpt):
    tree = _tree()
    save_checkpoint(tmp_ckpt, 7, tree)
    assert latest_step(tmp_ckpt) == 7
    with open(os.path.join(tmp_ckpt, "step_7", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["num_leaves"] == len(tree_lib.leaves(tree))
    assert list(manifest["bf16_leaves"].values()) == ["bfloat16"]
    out = restore_checkpoint(tmp_ckpt, 7, tree)
    assert out["step"] == 11 and isinstance(out["step"], int)
    assert type(out["opt"]["m"]["w"]).__name__ == "BlockQ"
    for a, b in zip(tree_lib.leaves(tree), tree_lib.leaves(out)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.stride() == b.stride()
            assert torch.equal(a, b)
    w = out["layers"][0]["w"]
    assert w.stride(0) == 8 and tgemm.aligned_rows(w) is w


def test_checkpoint_gc_keeps_last(tmp_ckpt):
    tree = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_ckpt, s, tree, keep_last=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_ckpt) if d.startswith("step_"))
    assert steps == [4, 5]


def test_checkpoint_atomicity_ignores_tmp(tmp_ckpt):
    save_checkpoint(tmp_ckpt, 3, _tree())
    os.makedirs(os.path.join(tmp_ckpt, "step_9.tmp"))     # a crashed writer
    os.makedirs(os.path.join(tmp_ckpt, "step_11"))        # no manifest: incomplete
    assert latest_step(tmp_ckpt) == 3


def test_async_checkpointer_snapshots_and_raises(tmp_ckpt, monkeypatch):
    tree = _tree()
    ck = AsyncCheckpointer(tmp_ckpt)
    ck.save(1, tree)
    want = tree["a"].clone()
    tree["a"].add_(1.0)          # the snapshot was taken at save()
    ck.save(2, tree)             # waits for the first
    ck.wait()
    assert latest_step(tmp_ckpt) == 2
    assert torch.equal(restore_checkpoint(tmp_ckpt, 1, tree)["a"], want)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tstore, "save_checkpoint", broken)
    ck.save(3, tree)
    with pytest.raises(OSError, match="disk full"):
        ck.wait()
    ck.wait()                    # the error is raised once


def _toy_setup(ckpt_dir, total=30, fail_at=None, ckpt_every=10):
    """A linear regression under the real supervisor and AdamW."""
    cfg = AdamWConfig(weight_decay=0.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros((3,))}
    opt = adamw_init(params, cfg)
    data = SyntheticLMData(vocab=17, batch=1, seq=3, seed=0)

    def train_step(params, opt_state, batch):
        x = batch["tokens"].to(torch.float32) / 17.0
        w = params["w"].detach().requires_grad_(True)
        loss = torch.mean((x @ w - x @ target) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        adamw_update([g], opt_state, params, 0.05, cfg)
        return params, opt_state, {"loss": loss.detach()}

    sup = Supervisor(train_step, data.batch_at,
                     TrainLoopConfig(total_steps=total, ckpt_every=ckpt_every,
                                     ckpt_dir=ckpt_dir, log_every=1),
                     put_batch=lambda b: to_device(b, "cpu"), simulate_failure_at=fail_at)
    return sup, params, opt


def test_supervisor_clean_run(tmp_ckpt):
    sup, p, o = _toy_setup(tmp_ckpt)
    out = sup.run(p, o)
    assert out["step"] == 30 and out["restarts"] == 0 and len(out["metrics"]) == 30
    assert latest_step(tmp_ckpt) == 30


def _losses_by_step(metrics):
    by = {}
    for m in metrics:
        by.setdefault(m["step"], []).append(m["loss"])
    return by


def test_supervisor_failure_restart_matches_clean(tmp_path):
    sup, p, o = _toy_setup(str(tmp_path / "clean"))
    clean = sup.run(p, o)
    sup2, p2, o2 = _toy_setup(str(tmp_path / "faulty"), fail_at=17)
    faulty = sup2.run(p2, o2)
    assert faulty["restarts"] == 1 and faulty["step"] == 30
    assert torch.equal(clean["params"]["w"], faulty["params"]["w"])
    want = _losses_by_step(clean["metrics"])
    got = _losses_by_step(faulty["metrics"])
    assert sorted(got) == sorted(want)
    for step, losses in got.items():       # steps 11-17 ran twice after the restore
        assert len(losses) == (2 if 10 < step <= 17 else 1)
        assert all(x == want[step][0] for x in losses)


def test_supervisor_restore_api(tmp_ckpt):
    sup, p, o = _toy_setup(tmp_ckpt, total=20)
    sup.run(p, o)
    sup2, p2, o2 = _toy_setup(tmp_ckpt, total=20)
    restored = sup2.restore(p2, o2)
    assert restored is not None and restored[2] == 20
    assert int(restored[1]["count"]) == 20


def test_gemma_smoke_restart_equals_clean_run(tmp_path):
    """The real train step (loss, backward, AdamW in place) of the gemma3-1b
    smoke model under the supervisor: a failure at step 5 after a
    checkpoint at step 3 replays steps 4-5 with the clean run's losses."""
    cfg = tconfigs.get_smoke("gemma3-1b")
    data = SyntheticLMData(cfg.vocab, 2, 16)

    def run(d, fail_at):
        params = TM.init_model(cfg, seed=0, device="cpu")
        opt = adamw_init(params, tsteps.optimizer_config(cfg))
        step = tsteps.make_train_step(cfg, base_lr=3e-3, total_steps=8)
        sup = Supervisor(step, data.batch_at,
                         TrainLoopConfig(total_steps=8, ckpt_every=3, ckpt_dir=str(d),
                                         log_every=1),
                         put_batch=lambda b: to_device(b, "cpu"), simulate_failure_at=fail_at)
        return sup.run(params, opt)

    clean, faulty = run(tmp_path / "a", None), run(tmp_path / "b", 5)
    assert faulty["restarts"] == 1 and int(faulty["opt_state"]["count"]) == 8
    want = _losses_by_step(clean["metrics"])
    for step, losses in _losses_by_step(faulty["metrics"]).items():
        assert all(x == want[step][0] for x in losses), step
    for a, b in zip(tree_lib.leaves(clean["params"]), tree_lib.leaves(faulty["params"])):
        assert torch.equal(a, b)


def _cli(tmp_path, name, *extra):
    return ttrain.main(["--device", "cpu", "--arch", "gemma3-1b", "--preset", "smoke",
                        "--steps", "40", "--batch", "4", "--seq", "32", "--ckpt-every", "1000",
                        "--ckpt-dir", str(tmp_path / name), "--lr", "3e-3", *extra])


def test_train_cli_loss_decreases_and_is_deterministic(tmp_path):
    a = _cli(tmp_path, "a")
    losses = [m["loss"] for m in a["metrics"]]
    assert [m["step"] for m in a["metrics"]] == [10, 20, 30, 40]
    assert losses[-1] < losses[0] - 0.2, losses
    b = _cli(tmp_path, "b")
    assert [m["loss"] for m in b["metrics"]] == losses
    for x, y in zip(tree_lib.leaves(a["params"]), tree_lib.leaves(b["params"])):
        assert torch.equal(x, y)
    assert latest_step(str(tmp_path / "a")) == 40


def test_train_cli_defaults_to_cuda_and_refuses_what_it_lacks(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--preset", "smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    # --model-parallel must divide the world (1 without a process group)
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        ttrain.main(["--device", "cpu", "--preset", "smoke", "--model-parallel", "2"])
    # --quant is parsed and read by nothing, as in the reference
    out = ttrain.main(["--device", "cpu", "--preset", "smoke", "--steps", "2", "--batch", "2",
                       "--seq", "8", "--quant", "int8", "--ckpt-dir", str(tmp_path / "q")])
    assert out["step"] == 2


def test_train_cli_fail_at_restores_and_resume_continues(tmp_path):
    """`--fail-at 3` after a checkpoint at step 2 replays step 3 with the
    clean run's loss (every step seen through `on_step`); `--resume` from
    the clean run's step-6 checkpoint runs steps 7 and 8 only."""
    base = ["--device", "cpu", "--preset", "smoke", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2"]

    def run(*extra):
        seen = []
        out = ttrain.main(base + list(extra),
                          on_step=lambda step, m, sec: seen.append((step, float(m["loss"]))))
        return out, seen

    clean, want = run("--steps", "6", "--ckpt-dir", str(tmp_path / "c"))
    faulty, got = run("--steps", "6", "--ckpt-dir", str(tmp_path / "f"), "--fail-at", "3")
    assert faulty["restarts"] == 1
    assert [s for s, _ in got] == [1, 2, 3, 3, 4, 5, 6]
    want = dict(want)
    assert all(loss == want[s] for s, loss in got)
    resumed, steps = run("--steps", "8", "--ckpt-dir", str(tmp_path / "c"), "--resume")
    assert resumed["step"] == 8 and [s for s, _ in steps] == [7, 8]


def test_opt_state_on_the_params_device_and_grad_free_serving():
    """After a step the parameters require grad; a no_grad forward (serving)
    still takes no backward path and launches no Function."""
    cfg = tconfigs.get_smoke("gemma3-1b")
    params = TM.init_model(cfg, seed=0, device="cpu")
    opt = adamw_init(params, tsteps.optimizer_config(cfg))
    assert opt["count"].device == params["embed"].device and opt["count"].dtype == torch.int32
    step = tsteps.make_train_step(cfg, base_lr=1e-3, total_steps=4)
    batch = to_device(SyntheticLMData(cfg.vocab, 2, 8).batch_at(0), "cpu")
    params, opt, m = step(params, opt, batch)
    assert np.isfinite(float(m["loss"])) and int(opt["count"]) == 1
    with torch.no_grad():
        logits = TM.forward(params, cfg, batch)
    assert logits.grad_fn is None and not logits.requires_grad
