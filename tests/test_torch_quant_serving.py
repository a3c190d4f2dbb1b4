"""The port's int8 deployment serving against the reference on the CPU:
the Engine under w8a8 weights and/or an int8 KV pool is greedy
token-identical to the reference Engine on the gemma3-1b smoke config
(float32, the same bridged weights), the serve CLI prints the reference
CLI's tokens, and the precision mode never leaks out of the engine."""

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


@pytest.mark.parametrize("precision,kv_precision", [
    ("w8a8", "int8"), ("w8a8", "float"), ("float", "int8")])
def test_engine_int8_token_identical_to_reference(models, precision, kv_precision):
    """Slice acceptance: w8a8 weights and/or an int8 pool give the
    reference Engine's greedy tokens, with slot refills, and the same
    memory accounting; the precision mode is float after warmup and run."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    lens, gens = [5, 3, 7, 4], [2, 5, 1, 3]
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32) for n in lens]
    kw = dict(slots=2, max_seq=32, block_size=4, max_chunk=4, precision=precision,
              kv_precision=kv_precision)
    reng = REngine(rcfg, params=rparams, **kw)
    reng.warmup()
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    teng.warmup()
    assert quant.get_mode() == "float"
    for p, g in zip(prompts, gens):
        reng.submit(RSpec(prompt=p, max_new=g))
        teng.submit(TSpec(prompt=p, max_new=g))
    want, got = reng.run(), teng.run()
    assert quant.get_mode() == "float"
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    m, rm = teng.metrics, reng.metrics
    assert m.cold_compiles == 0
    assert (m.precision, m.kv_precision) == (rm.precision, rm.kv_precision) == \
        (precision, kv_precision)
    assert (m.weight_bytes, m.weight_bytes_float) == (rm.weight_bytes, rm.weight_bytes_float)
    assert m.kv_pool_bytes == rm.kv_pool_bytes
    s = m.summary()
    assert "kv_pool=" in s and kv_precision in s
    assert ("precision=w8a8" in s and "smaller" in s) == (precision == "w8a8")
    if precision == "w8a8":
        assert m.weight_bytes < m.weight_bytes_float
        assert quant.quantized_leaf_count(teng.params) == 7 * tcfg.n_layers + 1


def test_serve_cli_int8_tokens_match_reference(models, capsys):
    _, _, _, tparams = models
    argv = ["--arch", ARCH, "--requests", "2", "--prompt-len", "6",
            "--gen-len", "3", "--chunk", "4", "--block-size", "4",
            "--precision", "w8a8", "--kv-precision", "int8"]
    want = rserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(got, want)
    assert "precision=w8a8" in capsys.readouterr().out


def test_precision_mode_hygiene(models):
    _, _, tcfg, tparams = models
    with pytest.raises(RuntimeError):
        with quant.precision("w8a8"):
            assert quant.get_mode() == "w8a8"
            raise RuntimeError("boom")
    assert quant.get_mode() == "float"
    # "w8a8-calibrated" serves now: warmup calibrates in float mode, then
    # runs the calibrated steps, and leaves the mode float.
    eng = TEngine(tcfg, tparams, device="cpu", precision="w8a8-calibrated",
                  slots=1, max_seq=8, max_chunk=4)
    eng.warmup()
    assert eng.metrics.calib_sites == 7 * tcfg.n_layers + 1
    assert quant.get_mode() == "float"
    with pytest.raises(ValueError, match="precision"):
        TEngine(tcfg, tparams, device="cpu", precision="int4")
    with pytest.raises(ValueError, match="kv_precision"):
        TEngine(tcfg, tparams, device="cpu", kv_precision="fp8")
