"""The port's calibrated int8 path against the reference on the gemma3-1b
smoke config (float32, bridged weights): calibration tables for every
observer, static activation scales attached by `quantize_params`, the
calibrated paged steps, `eval_nll` / `quality_delta` and `layer_error_rows`.
(The calibrated Engine and CLI: tests/test_torch_calibrated_serving.py.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import quant as rquant
from repro.kernels import ops as rops
from repro.models import model as RM
from repro.serving.prefill import plan_chunks
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as tkvc

ARCH = "gemma3-1b"
LEAVES = (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"), ("mixer", "wo"),
          ("ffn", "w_gate"), ("ffn", "w_up"), ("ffn", "w_down"))


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


@pytest.fixture(scope="module")
def ref_table(models):
    rcfg, rparams, _, _ = models
    return rquant.collect_scales(rparams, rcfg, rquant.synthetic_batches(rcfg))


@pytest.mark.parametrize("observer", ["absmax", "moving_average", "percentile"])
def test_calibrate_matches_reference(models, observer):
    """The same synthetic batches give the same key set ("blocks.0.sub{i}.
    ...", "head") and every scale within 1e-5 relative."""
    rcfg, rparams, tcfg, tparams = models
    batches = rquant.synthetic_batches(rcfg, n=2, batch=2, seq=32, seed=0)
    for a, b in zip(batches, quant.synthetic_batches(tcfg, n=2, batch=2, seq=32, seed=0)):
        np.testing.assert_array_equal(a, b)
    want = rquant.collect_scales(rparams, rcfg, batches, observer=observer)
    got = quant.collect_scales(tparams, tcfg, batches, observer=observer)
    assert sorted(got.scales) == sorted(want.scales)
    assert len(got) == 7 * tcfg.n_layers + 1 and "head" in got.scales
    assert (got.observer, got.batches) == (want.observer, want.batches) == (observer, 2)
    for k, v in want.scales.items():
        np.testing.assert_allclose(got.scales[k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got.channel_scales[k], want.channel_scales[k],
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    again = quant.collect_scales(tparams, tcfg, batches, observer=observer)
    assert again.scales == got.scales                       # deterministic
    assert quant.get_mode() == "float"


def test_quantize_params_attaches_reference_scales(models, ref_table):
    """Each layer leaf takes its group's scale under the reference's key,
    as f32, and the head_q takes "head"; codes are unchanged."""
    rcfg, rparams, tcfg, tparams = models
    rq = rquant.quantize_params(rparams, cfg=rcfg, scales=ref_table)
    tq = quant.quantize_params(tparams, cfg=tcfg,
                               scales=bridge.scales_from_reference(ref_table))
    for L, layer in enumerate(tq["layers"]):
        g, i = divmod(L, tcfg.group_size)
        for part, key in LEAVES:
            t, r = layer[part][key], rq["blocks"][f"sub{i}"][part][key]
            assert t.act_scale.dtype == torch.float32
            assert t.act_scale.item() == np.asarray(r.act_scale)[g].item()
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q)[g])
    assert tq["head_q"].act_scale.item() == np.asarray(rq["head_q"].act_scale).item()
    assert quant.weight_bytes(tq) == rquant.weight_bytes(rq)


def test_partially_calibrated_leaf_stays_dynamic():
    """A stacked leaf is calibrated for all groups or none: with group 1's
    entry for sub0.mixer.wq missing, no layer's sub0 wq takes a scale."""
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCH), group_size=3)   # 2 groups
    params = TM.init_model(cfg, seed=0, device="cpu")
    table = {f"blocks.{g}.sub{i}.{p}.{k}": 0.5 + g
             for g in range(2) for i in range(3) for p, k in LEAVES}
    del table["blocks.1.sub0.mixer.wq"]
    q = quant.quantize_params(params, cfg=cfg, scales=table)
    assert q["layers"][0]["mixer"]["wq"].act_scale is None
    assert q["layers"][3]["mixer"]["wq"].act_scale is None
    assert q["layers"][4]["mixer"]["wq"].act_scale.item() == 1.5     # sub1 of group 1
    assert q["head_q"].act_scale is None                             # no "head" entry
    with pytest.raises(ValueError, match="cfg"):
        quant.quantize_params(params, scales=table)


def test_static_activation_quantization_divides_as_reference():
    """Static scales quantize as round(x / s) with a true division in both
    packages: the reference's jitted step takes `s` as a traced leaf, which
    XLA does not rewrite into a multiply.  Inputs sit on and beside the
    rounding ties, where a multiply by 1/s would move codes."""
    rng = np.random.default_rng(11)
    s = np.float32(0.0137)
    codes = np.arange(-126, 126, dtype=np.float32) + np.float32(0.5)
    ties = (codes * s).astype(np.float32)
    x = np.stack([np.nextafter(ties, np.float32(sign * np.inf)) if sign else ties
                  for sign in (-1, 0, 1)] * 2).astype(np.float32)      # (6, 252)
    x[3:] *= rng.uniform(0.9, 1.1, size=(3, 252)).astype(np.float32)
    K = x.shape[1]
    w_q = np.eye(K, dtype=np.int8)
    w_s = np.ones((1, K), np.float32)
    want = np.asarray(jax.jit(rops.gemm_w8a8)(jnp.asarray(x), jnp.asarray(w_q),
                                              jnp.asarray(w_s), act_scale=jnp.asarray(s)))
    got = tops.gemm_w8a8(torch.from_numpy(x), torch.from_numpy(w_q),
                         torch.from_numpy(w_s), act_scale=torch.tensor(s))
    np.testing.assert_array_equal(got.numpy(), want)


def test_calibrated_paged_steps_match_reference(models, ref_table):
    """Chunked prefill then paged decode under "w8a8-calibrated" with the
    reference's table in both packages: logits within 1e-3 x max|logit|."""
    rcfg, rparams, tcfg, tparams = models
    rq = rquant.quantize_params(rparams, cfg=rcfg, scales=ref_table)
    tq = quant.quantize_params(tparams, cfg=tcfg,
                               scales=bridge.scales_from_reference(ref_table))
    slots, prompt_len, gen, bs, mb = 2, 6, 2, 4, 8
    nb = 1 + slots * mb
    rstate = RM.init_paged_decode_state(rcfg, slots, num_blocks=nb, block_size=bs,
                                        max_blocks_per_slot=mb)
    tstate = TM.init_paged_decode_state(tcfg, slots, num_blocks=nb, block_size=bs,
                                        max_blocks_per_slot=mb, device="cpu")
    tables, alloc = tkvc.BlockTables(slots, mb), tkvc.BlockAllocator(nb, bs)
    for s in range(slots):
        tables.ensure(s, prompt_len + gen + 1, alloc)
    rstate = rstate._replace(block_tables=jnp.asarray(tables.table))
    tstate.block_tables = tables.array("cpu")
    prompts = np.random.default_rng(1).integers(
        0, rcfg.vocab, size=(slots, prompt_len)).astype(np.int32)

    def close(t, r):
        r = np.asarray(r)
        assert np.abs(t.numpy() - r).max() <= 1e-3 * np.abs(r).max()

    mode = "w8a8-calibrated"
    with rquant.precision(mode), quant.precision(mode):
        for s in range(slots):
            pos = 0
            for c in plan_chunks(prompt_len, max_chunk=4):
                chunk = prompts[s:s + 1, pos:pos + c]
                rl, rstate = RM.prefill_chunk(rq, rcfg, rstate, jnp.asarray(chunk),
                                              jnp.int32(s))
                tl, tstate = TM.prefill_chunk(tq, tcfg, tstate,
                                              torch.from_numpy(chunk).long(), s)
                close(tl, rl)
                pos += c
        tok = np.full((slots, 1), np.argmax(np.asarray(rl)[0, -1]), np.int32)
        for _ in range(gen):
            rl, rstate = RM.paged_decode_step(rq, rcfg, rstate, jnp.asarray(tok))
            tl, tstate = TM.paged_decode_step(tq, tcfg, tstate, torch.from_numpy(tok).long())
            close(tl, rl)
            tok = np.argmax(np.asarray(rl)[:, -1], -1)[:, None].astype(np.int32)
    assert quant.get_mode() == "float"


@pytest.fixture(scope="module")
def eval_batches(models):
    rcfg = models[0]
    rng = np.random.default_rng(9)
    toks = [rng.integers(0, rcfg.vocab, size=(2, 33)).astype(np.int32) for _ in range(2)]
    return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]


@pytest.mark.parametrize("mode", ["float", "w8a8", "w8a8-calibrated"])
def test_eval_nll_and_quality_delta_match_reference(models, ref_table, eval_batches, mode):
    """`forward` under each precision mode gives the reference's NLL within
    1e-4 relative, and `quality_delta` the same report."""
    rcfg, rparams, tcfg, tparams = models
    rq = rquant.quantize_params(rparams, cfg=rcfg, scales=ref_table)
    tq = quant.quantize_params(tparams, cfg=tcfg,
                               scales=bridge.scales_from_reference(ref_table))
    if mode == "float":
        want = rquant.eval_nll(rparams, rcfg, eval_batches, mode=mode)
        got = quant.eval_nll(tparams, tcfg, eval_batches, mode=mode)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:                                   # both NLLs, through eval_nll
        rd = rquant.quality_delta(rparams, rq, rcfg, eval_batches, mode=mode)
        td = quant.quality_delta(tparams, tq, tcfg, eval_batches, mode=mode)
        assert td["mode"] == mode
        for k in ("float_nll", "quant_nll"):
            np.testing.assert_allclose(td[k], rd[k], rtol=1e-4)
        np.testing.assert_allclose(td["delta_nll"], rd["delta_nll"],
                                   atol=1e-4 * abs(rd["float_nll"]))
    assert quant.get_mode() == "float"


def test_layer_error_rows_match_reference(models, ref_table):
    """One port row per layer; with the smoke config's single group each
    reference row (one stacked leaf, its group slice) is one port row:
    layers.{i}.… <-> blocks.sub{i}.…, head_q <-> head_q."""
    rcfg, rparams, tcfg, tparams = models
    assert tcfg.n_groups == 1
    rq = rquant.quantize_params(rparams, cfg=rcfg, scales=ref_table)
    tq = quant.quantize_params(tparams, cfg=tcfg,
                               scales=bridge.scales_from_reference(ref_table))
    want = {r["path"]: r for r in rquant.layer_error_rows(rparams, rq)}
    rows = quant.layer_error_rows(tparams, tq)
    assert len(rows) == len(want) == 7 * tcfg.n_layers + 1
    assert [r["rel_err"] for r in rows] == sorted((r["rel_err"] for r in rows), reverse=True)
    for r in rows:
        parts = r["path"].split(".")
        key = r["path"] if parts[0] == "head_q" else ".".join(["blocks", f"sub{parts[1]}"] + parts[2:])
        w = want[key]
        assert r["shape"] == w["shape"][-2:] and r["calibrated"] == w["calibrated"] is True
        for f in ("rel_err", "max_abs_err", "scale_spread"):
            np.testing.assert_allclose(r[f], w[f], rtol=1e-5, err_msg=f"{key} {f}")
    table = quant.format_error_table(rows, top=5)
    assert table.splitlines()[0].startswith("layer") and "more layers" in table
