"""The port's calibrated w8a8 serving against the reference on the CPU: the
Engine under precision="w8a8-calibrated" (float and int8 KV) and the serve
CLI are greedy token-identical to the reference's on the gemma3-1b smoke
config (float32, bridged weights); the float Engine under the pipelined
GeMM backend gives the tiled backend's tokens."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import RequestSpec as TSpec

ARCH = "gemma3-1b"


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = rconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


PROMPT_LENS, GENS = [5, 3, 7, 4], [2, 5, 1, 3]
ENGINE_KW = dict(slots=2, max_seq=32, block_size=4, max_chunk=4)


def _prompts(vocab):
    rng = np.random.default_rng(2)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in PROMPT_LENS]


def _serve(Engine, Spec, cfg, params, **kw):
    eng = Engine(cfg, params, **ENGINE_KW, **kw)
    eng.warmup()
    for p, g in zip(_prompts(cfg.vocab), GENS):
        eng.submit(Spec(prompt=p, max_new=g))
    return eng, eng.run()


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
def test_engine_calibrated_token_identical_to_reference(models, kv_precision):
    """Slice acceptance: Engine(precision="w8a8-calibrated") calibrates in
    warmup over the default synthetic batches, then serves the reference
    Engine's greedy tokens, with slot refills; the mode is float after."""
    rcfg, rparams, tcfg, tparams = models
    kw = dict(precision="w8a8-calibrated", kv_precision=kv_precision)
    reng, want = _serve(REngine, RSpec, rcfg, rparams, **kw)
    teng, got = _serve(TEngine, TSpec, tcfg, tparams, device="cpu", **kw)
    assert quant.get_mode() == "float"
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    m, rm = teng.metrics, reng.metrics
    assert m.calib_sites == rm.calib_sites == 7 * tcfg.n_layers + 1
    assert m.cold_compiles == 0
    assert (m.weight_bytes, m.weight_bytes_float) == (rm.weight_bytes, rm.weight_bytes_float)
    assert teng.params["layers"][0]["mixer"]["wq"].act_scale is not None
    assert f"calib_sites={m.calib_sites}" in m.summary()


def test_serve_cli_calibrated_tokens_match_reference(models, capsys):
    _, _, _, tparams = models
    argv = ["--arch", ARCH, "--requests", "2", "--prompt-len", "6", "--gen-len", "3",
            "--chunk", "4", "--block-size", "4", "--precision", "w8a8-calibrated",
            "--kv-precision", "int8"]
    want = rserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(got, want)
    assert "calibrated 43 activation sites" in capsys.readouterr().out


def test_pipelined_backend_engine_tokens_equal_tiled(models):
    """Under set_default_backend("pipelined") every float projection takes
    K6's wrapper, which on the CPU runs the same plain GeMM, so the float
    Engine's tokens equal the "tiled" run's."""
    _, _, tcfg, tparams = models
    _, tiled = _serve(TEngine, TSpec, tcfg, tparams, device="cpu")
    tops.set_default_backend("pipelined")
    try:
        _, piped = _serve(TEngine, TSpec, tcfg, tparams, device="cpu")
    finally:
        tops.set_default_backend("tiled")
    assert sorted(piped) == sorted(tiled) == [0, 1, 2, 3]
    for rid in tiled:
        np.testing.assert_array_equal(piped[rid], tiled[rid])
