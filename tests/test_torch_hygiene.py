"""The port stands alone: no JAX and nothing of the reference package in
`src/repro_torch` or `chip_smoke.py`, it imports with JAX unavailable, and
its entry points refuse to run without a card unless told to use the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_pairs.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_engine_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['repro'] = None; "
            "import repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.quant, repro_torch.kernels.quant, "
            "repro_torch.kernels.gemm_int8, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.gemm_pipelined, repro_torch.kernels.registry, "
            "repro_torch.quant.calibrate, repro_torch.quant.report, "
            "repro_torch.cluster.replica, repro_torch.cluster.router, "
            "repro_torch.cluster.traffic, repro_torch.cluster.metrics, "
            "repro_torch.launch.train, repro_torch.launch.steps, repro_torch.optim, "
            "repro_torch.optim.compression, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.runtime, repro_torch.tree, repro_torch.parallel, "
            "repro_torch.parallel.logical, repro_torch.parallel.sharding, "
            "repro_torch.parallel.fsdp, repro_torch.parallel.tensor, "
            "repro_torch.launch.mesh; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_smoke("gemma3-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--preset", "smoke", "--steps", "1"])
    eng = Engine(cfg, slots=1, max_seq=8, device="cpu")
    assert eng.device.type == "cpu"
