"""The port's gemma3-1b model against the reference on the smoke config
(float32), with the reference's `init_model(PRNGKey(0))` parameters carried
over by the bridge: parameter count, layers, and the paged serving steps
(chunked prefill, then decode) logit for logit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels import ops as rops
from repro.models import layers as rlayers
from repro.models import model as RM
from repro.serving import kv_cache as rkvc
from repro.serving.prefill import plan_chunks
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as tkvc

ARCH = "gemma3-1b"
TOL = dict(rtol=3e-4, atol=3e-4)      # tests/test_serving.py's bar


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


def test_config_mirrors_reference():
    for get in ("get", "get_smoke"):
        r, t = getattr(rconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
        assert t.layer_kinds() == r.layer_kinds()
        assert t.param_count() == r.param_count()
        assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff,
                t.vocab, t.resolved_head_dim, t.local_window) == \
            (r.n_layers, r.d_model, r.n_heads, r.n_kv_heads, r.d_ff, r.vocab,
             r.resolved_head_dim, r.local_window)
    full = tconfigs.get(ARCH)
    assert full.all_layer_kinds().count("attn") == 4        # globals at 5, 11 per group
    assert full.layer_kinds()[5] == full.layer_kinds()[11] == "attn"


def test_bridged_parameter_count(models):
    rcfg, rparams, tcfg, tparams = models
    # ArchConfig.param_count counts the matrices; the norm vectors
    # (4 per layer + the final norm) come on top.
    assert bridge.param_count(tparams, min_dim=2) == tcfg.param_count()
    assert bridge.param_count(tparams) == tcfg.param_count() \
        + (4 * tcfg.n_layers + 1) * tcfg.d_model
    assert bridge.param_count(tparams) == sum(
        x.size for x in jax.tree_util.tree_leaves(rparams))
    assert len(tparams["layers"]) == tcfg.n_layers


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(rlayers.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 900]], np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(rlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        rtol=1e-5, atol=1e-5)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.25 for k, s in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)))}
    np.testing.assert_allclose(
        tlayers.mlp(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in p.items()},
                    "swiglu").numpy(),
        np.asarray(rlayers.mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in p.items()},
                               "swiglu")),
        rtol=1e-5, atol=1e-5)


def _states(rcfg, tcfg, slots, block_size, max_blocks, need_tokens):
    num_blocks = 1 + slots * max_blocks
    rstate = RM.init_paged_decode_state(
        rcfg, slots, num_blocks=num_blocks, block_size=block_size,
        max_blocks_per_slot=max_blocks)
    tstate = TM.init_paged_decode_state(
        tcfg, slots, num_blocks=num_blocks, block_size=block_size,
        max_blocks_per_slot=max_blocks, device="cpu")
    alloc = tkvc.BlockAllocator(num_blocks, block_size)
    tables = tkvc.BlockTables(slots, max_blocks)
    for s in range(slots):
        tables.ensure(s, need_tokens, alloc)
    rstate = rstate._replace(block_tables=jnp.asarray(tables.table))
    tstate.block_tables = tables.array("cpu")
    return rstate, tstate


def _prefill_then_decode(models, interpret: bool):
    rcfg, rparams, tcfg, tparams = models
    slots, prompt_len, gen = 2, 6, 3
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, rcfg.vocab, size=(slots, prompt_len)).astype(np.int32)
    rstate, tstate = _states(rcfg, tcfg, slots, 4, 8, prompt_len + gen + 1)
    try:
        for s in range(slots):
            pos = 0
            for c in plan_chunks(prompt_len, max_chunk=4):
                rl, rstate = RM.prefill_chunk(
                    rparams, rcfg, rstate, jnp.asarray(prompts[s:s + 1, pos:pos + c]),
                    jnp.int32(s))
                tl, tstate = TM.prefill_chunk(
                    tparams, tcfg, tstate,
                    torch.from_numpy(prompts[s:s + 1, pos:pos + c]).long(), s)
                np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
                pos += c
        # both slots continue with the last prefilled slot's greedy token
        tok = np.full((slots, 1), np.argmax(np.asarray(rl)[0, -1]), np.int32)
        steps = 1 if interpret else gen
        if interpret:
            rops.set_default_backend("interpret")   # reference through K1 and K2
        for _ in range(steps):
            rl, rstate = RM.paged_decode_step(rparams, rcfg, rstate, jnp.asarray(tok))
            tl, tstate = TM.paged_decode_step(tparams, tcfg, tstate,
                                              torch.from_numpy(tok).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
            tok = np.argmax(np.asarray(rl)[:, -1], -1)[:, None].astype(np.int32)
    finally:
        rops.set_default_backend("auto")
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(rstate.lengths))
    assert tstate.lengths.tolist() == [prompt_len + steps] * slots
    return rstate, tstate


def test_prefill_and_decode_logits_match_reference(models):
    """Chunked prefill per slot, then paged decode: logits step for step
    within 3e-4, and equal per-slot lengths."""
    _prefill_then_decode(models, interpret=False)


def test_reference_through_pallas_kernels_matches(models):
    """A decode step with the reference forced through its Pallas kernels
    (GeMM and paged flash-decode under the interpreter)."""
    _prefill_then_decode(models, interpret=True)


def test_reset_slots_and_per_slot_lengths_match(models):
    rcfg, rparams, tcfg, tparams = models
    rstate, tstate = _states(rcfg, tcfg, 3, 4, 4, 12)
    rng = np.random.default_rng(1)
    for slot, n in ((0, 4), (2, 2), (2, 1)):
        toks = rng.integers(0, rcfg.vocab, size=(1, n)).astype(np.int32)
        _, rstate = RM.prefill_chunk(rparams, rcfg, rstate, jnp.asarray(toks),
                                     jnp.int32(slot))
        _, tstate = TM.prefill_chunk(tparams, tcfg, tstate,
                                     torch.from_numpy(toks).long(), slot)
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(rstate.lengths))
    assert tstate.lengths.tolist() == [4, 0, 3]
    mask = np.array([True, False, False])
    rstate = RM.reset_slots(rcfg, rstate, jnp.asarray(mask))
    tstate = TM.reset_slots(tcfg, tstate, torch.from_numpy(mask))
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(rstate.lengths))
    assert tstate.lengths.tolist() == [0, 0, 3]
    # a decode step with slot 2 active only advances slot 2
    tok = np.zeros((3, 1), np.int32)
    active = np.array([False, False, True])
    rl, rstate = RM.paged_decode_step(rparams, rcfg, rstate, jnp.asarray(tok),
                                      jnp.asarray(active))
    tl, tstate = TM.paged_decode_step(tparams, tcfg, tstate,
                                      torch.from_numpy(tok).long(),
                                      torch.from_numpy(active))
    np.testing.assert_allclose(tl.numpy()[2], np.asarray(rl)[2], **TOL)
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(rstate.lengths))


def test_reference_pool_routing_matches():
    """Both packages put the same K/V at the same pool rows, including the
    null-block routing of past-capacity positions."""
    rng = np.random.default_rng(2)
    bt = np.array([[3, 1], [0, 0]], np.int32)
    k = rng.normal(size=(2, 5, 1, 4)).astype(np.float32)
    r = rkvc.write_kv(rkvc.init_paged_kv(4, 2, 1, 4, jnp.float32), jnp.asarray(bt),
                      jnp.asarray(k), jnp.asarray(k), jnp.asarray([1, 0], jnp.int32))
    t = tkvc.write_kv(tkvc.init_paged_kv(4, 2, 1, 4, torch.float32, "cpu"),
                      torch.from_numpy(bt), torch.from_numpy(k), torch.from_numpy(k),
                      torch.tensor([1, 0], dtype=torch.int32))
    # blocks 1..3 are live rows; the null block (0) holds colliding garbage
    np.testing.assert_array_equal(t.k.numpy()[1:], np.asarray(r.k)[1:])
