"""The recurrent, hybrid and MoE families in the port against the reference
on the CPU, model level: the configs (layer kinds, parameter counts), the
unpaged `forward`, chunked prefill and paged decode over per-slot
recurrent states (and the states themselves), the slot reset, the verify
step's commit at the accepted position, w8a8 steps on the reference's
w8a8, the calibration table, and the weight bytes the serve CLI sizes.
Archs: jamba-1.5-large-398b (hybrid: Mamba + attention, MoE on alternate
layers), xlstm-1.3b (ssm: mLSTM + sLSTM), dbrx-132b and arctic-480b (moe,
arctic with its dense residual), smoke configs in float32 with the
reference's weights bridged.

Tolerances (float32): logits within 5e-5 (absolute and relative) of the
reference's, tighter than tests/test_serving.py's 3e-4 family bar, which
they also meet; recurrent states within 5e-5; greedy tokens, accepted
counts and lengths exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import quant as rquant
from repro.models import model as RM
from repro.quant import modes as rmodes
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.engine import Engine

ARCHS = ["jamba-1.5-large-398b", "xlstm-1.3b", "dbrx-132b", "arctic-480b"]
TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(arch):
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = build(arch)
        return cache[arch]
    return get


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Layer kinds, groups and both parameter counts of the published and
    smoke configs equal the reference's (its mLSTM term included)."""
    for rcfg, tcfg in ((rconfigs.get(arch), tconfigs.get(arch)),
                       (rconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        assert tcfg.layer_kinds() == rcfg.layer_kinds()
        assert (tcfg.family, tcfg.n_groups) == (rcfg.family, rcfg.n_groups)
        assert tcfg.param_count() == rcfg.param_count()
        assert tcfg.active_param_count() == rcfg.active_param_count()
    assert len(tconfigs.get(arch).all_layer_kinds()) == tconfigs.get(arch).n_layers


def test_config_refuses_unported_families():
    """ArchConfig accepts the encdec and vlm families (they decode through
    the unpaged path); the paged state and the engine refuse both, naming
    the family, as the reference's do; hybrid without its config still
    raises."""
    base = tconfigs.get_smoke("gemma3-1b")
    for arch in ("whisper-medium", "paligemma-3b"):
        cfg = tconfigs.get_smoke(arch)
        assert dataclasses.replace(base, family=cfg.family).family == cfg.family
        with pytest.raises(NotImplementedError, match=f"family {cfg.family!r}"):
            TM.init_paged_decode_state(cfg, 2, num_blocks=5, block_size=4,
                                       max_blocks_per_slot=2, device="cpu")
        with pytest.raises(NotImplementedError, match=f"family {cfg.family!r}"):
            Engine(cfg, slots=2, max_seq=16, device="cpu")
        with pytest.raises(NotImplementedError, match=f"family {cfg.family!r}"):
            RM.init_paged_decode_state(rconfigs.get_smoke(arch), 2, num_blocks=5,
                                       block_size=4, max_blocks_per_slot=2)
    with pytest.raises(ValueError, match="hybrid needs"):
        dataclasses.replace(base, family="hybrid")


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_published_weight_bytes_equal_reference_leaves(arch):
    """The serve CLI sizes the weights on the meta device: the bytes of the
    reference's parameter leaves (`jax.eval_shape`, bf16 matrices, the
    float32 biases / A_log / D / router) at published widths, xlstm-1.3b
    whole (7.41 GB) and jamba cut to one group."""
    rcfg, tcfg = rconfigs.get(arch), tconfigs.get(arch)
    if arch.startswith("jamba"):
        rcfg = dataclasses.replace(rcfg, n_layers=rcfg.group_size)
        tcfg = dataclasses.replace(tcfg, n_layers=tcfg.group_size)
    shapes = jax.eval_shape(lambda: RM.init_model(jax.random.PRNGKey(0), rcfg))
    want = sum(a.size * a.dtype.itemsize for a in jax.tree_util.tree_leaves(shapes))
    assert tserve.check_weights_fit(tcfg, "cpu") == want
    if arch == "xlstm-1.3b":
        assert want == 7_410_799_936


# -- forward and the paged steps ---------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(built, arch):
    """The unpaged forward (recurrent layers from their init state; mLSTM
    chunkwise), 2 x 24 tokens."""
    rcfg, rparams, tcfg, tparams = built(arch)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab, size=(2, 24)).astype(np.int32)
    want = RM.forward(rparams, rcfg, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks).long()})
        last = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks).long()},
                          last_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(last, got[:, -1:], rtol=0, atol=0)


def _states(rcfg, tcfg, slots=3, block_size=4, max_blocks=6):
    num_blocks = 1 + slots * max_blocks
    rstate = RM.init_paged_decode_state(rcfg, slots, num_blocks=num_blocks,
                                        block_size=block_size, max_blocks_per_slot=max_blocks)
    tstate = TM.init_paged_decode_state(tcfg, slots, num_blocks=num_blocks,
                                        block_size=block_size, max_blocks_per_slot=max_blocks,
                                        device="cpu")
    alloc = tkvc.BlockAllocator(num_blocks, block_size)
    tables = tkvc.BlockTables(slots, max_blocks)
    for s in range(slots):
        tables.ensure(s, max_blocks * block_size, alloc)
    tables.copy_to(tstate.block_tables)
    return rstate._replace(block_tables=jnp.asarray(tables.table)), tstate


def _assert_states(rstate, tstate, cfg, **tol):
    """Every recurrent layer's state (the reference's group-stacked leaf g
    against the port's layer g * group_size + i) and the lengths."""
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(rstate.lengths))
    kinds = cfg.layer_kinds()
    n = 0
    for g in range(cfg.n_groups):
        for i, kind in enumerate(kinds):
            got = tstate.caches[g * cfg.group_size + i]
            if kind in ("attn", "attn_local"):
                assert isinstance(got, tkvc.PagedKVCache)
                continue
            want = rstate.caches[i]
            for name, a, b in zip(got._fields, got, want):
                np.testing.assert_allclose(a.float().numpy(), np.asarray(b[g], np.float32),
                                           err_msg=f"layer {g}/{i} {kind}.{name}",
                                           **(tol or TOL))
            n += 1
    return n


def _lived(built, arch):
    """Both packages' states after chunked prefill of slots 0 and 2 (5 and
    7 tokens, chunks of 4 and 1 / 4, 2 and 1) and two decode steps with
    slot 1 idle; the logits checked at every step."""
    rcfg, rparams, tcfg, tparams = built(arch)
    rstate, tstate = _states(rcfg, tcfg)
    rng = np.random.default_rng(1)
    for slot, chunks in ((0, (4, 1)), (2, (4, 2, 1))):
        for c in chunks:
            toks = rng.integers(0, rcfg.vocab, size=(1, c)).astype(np.int32)
            rl, rstate = RM.prefill_chunk(rparams, rcfg, rstate, jnp.asarray(toks),
                                          jnp.int32(slot))
            with torch.no_grad():
                tl, tstate = TM.prefill_chunk(tparams, tcfg, tstate,
                                              torch.from_numpy(toks).long(),
                                              torch.tensor([slot]))
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    active = np.array([True, False, True])
    tok = rng.integers(0, rcfg.vocab, size=(3, 1)).astype(np.int32)
    for _ in range(2):
        rl, rstate = RM.paged_decode_step(rparams, rcfg, rstate, jnp.asarray(tok),
                                          jnp.asarray(active))
        with torch.no_grad():
            tl, new = TM.paged_decode_step(tparams, tcfg, tstate, torch.from_numpy(tok).long(),
                                           torch.from_numpy(active))
        tstate.lengths = new.lengths
        np.testing.assert_allclose(tl.numpy()[active], np.asarray(rl)[active], **TOL)
        tok = np.argmax(np.asarray(rl)[:, -1], -1)[:, None].astype(np.int32)
    return rstate, tstate


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_prefill_and_decode_match_reference(built, arch):
    """Chunked prefill per slot (a device slot index) and decode steps with
    an idle slot: logits step for step, and afterwards every recurrent
    layer's per-slot state (the idle slot's still at its init) and the
    lengths."""
    rstate, tstate = _lived(built, arch)
    tcfg = built(arch)[2]
    n = _assert_states(rstate, tstate, tcfg)
    assert n == sum(k not in ("attn", "attn_local") for k in tcfg.all_layer_kinds())
    for c in tstate.caches:
        if not isinstance(c, tkvc.PagedKVCache):
            fresh = TS.init_state_for_kind(tcfg, {
                TS.MambaState: "mamba", TS.MLSTMState: "mlstm",
                TS.SLSTMState: "slstm"}[type(c)], 1, "cpu")
            for a, b in zip(c, fresh):
                torch.testing.assert_close(a[1:2], b, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_reset_slots_matches_reference(built, arch):
    """The reset returns masked slots' recurrent states to the batch-1
    template (m = -1e30, not 0) and zeroes their lengths, in place; the
    other slots keep theirs."""
    rcfg, _, tcfg, _ = built(arch)
    rstate, tstate = _lived(built, arch)
    ptrs = [t.data_ptr() for c in tstate.caches for t in c if t is not None]
    mask = np.array([True, False, False])
    rstate = RM.reset_slots(rcfg, rstate, jnp.asarray(mask))
    tstate.lengths = TM.reset_slots(tcfg, tstate, torch.from_numpy(mask)).lengths
    assert [t.data_ptr() for c in tstate.caches for t in c if t is not None] == ptrs
    _assert_states(rstate, tstate, tcfg)
    ms = [c.m for c in tstate.caches if hasattr(c, "m")]
    assert all(torch.all(m[0] == -1e30) for m in ms)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_verify_step_commits_recurrent_state_as_reference(built, arch, S):
    """`paged_verify_step` over lived states: greedy tokens, accepted
    counts and lengths equal the reference's, and each slot's recurrent
    state is the one after its last committed token (the idle slot's
    unchanged)."""
    rcfg, rparams, tcfg, tparams = built(arch)
    rstate, tstate = _lived(built, arch)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, rcfg.vocab, size=(3, S)).astype(np.int32)
    with torch.no_grad():
        for j in range(1, S):       # slot 0's drafts: its greedy continuation
            probe = TM._verify_trunk(tparams, tcfg, tstate, torch.from_numpy(tokens).long())
            tokens[0, j] = int(probe[0, j - 1].argmax())
    active = np.array([True, False, True])
    limits = np.array([S, 1, S], np.int32)
    eos = np.full((3,), -1, np.int32)
    greedy, n_new, rstate = RM.paged_verify_step(
        rparams, rcfg, rstate, jnp.asarray(tokens), jnp.asarray(active),
        jnp.asarray(limits), jnp.asarray(eos))
    with torch.no_grad():
        tg, tn, new = TM.paged_verify_step(
            tparams, tcfg, tstate, torch.from_numpy(tokens).long(), torch.from_numpy(active),
            torch.from_numpy(limits), torch.from_numpy(eos))
    tstate.lengths = new.lengths
    np.testing.assert_array_equal(tg.numpy(), np.asarray(greedy))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n_new))
    assert tn.tolist()[:2] == [S, 0]
    _assert_states(rstate, tstate, tcfg)


# -- w8a8 -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_w8a8_paged_steps_match_reference_w8a8(built, arch):
    """Under w8a8 (weights int8-resident, the router and the recurrences'
    gate / dt projections float or quantized on the fly as the reference
    runs them) with an int8 KV pool: a prefill chunk and two decode steps
    give the reference's w8a8 logits within 1e-4, and the same greedy
    tokens.  (The bar is the reference's w8a8 run, not float: the
    reference's own jamba w8a8-vs-float test fails.)"""
    rcfg, rparams, tcfg, tparams = built(arch)
    rq = rquant.quantize_params(rparams, cfg=rcfg)
    tq = quant.quantize_params(tparams, cfg=tcfg)
    nb, bs = 13, 4
    rstate = RM.init_paged_decode_state(rcfg, 2, num_blocks=nb, block_size=bs,
                                        max_blocks_per_slot=6, kv_precision="int8")
    tstate = TM.init_paged_decode_state(tcfg, 2, num_blocks=nb, block_size=bs,
                                        max_blocks_per_slot=6, device="cpu",
                                        kv_precision="int8")
    tables = np.arange(1, 13, dtype=np.int32).reshape(2, 6)
    rstate = rstate._replace(block_tables=jnp.asarray(tables))
    tstate.block_tables.copy_(torch.from_numpy(tables))
    toks = np.random.default_rng(4).integers(0, rcfg.vocab, size=(1, 6)).astype(np.int32)
    with rmodes.precision("w8a8"):
        rl, rstate = RM.prefill_chunk(rq, rcfg, rstate, jnp.asarray(toks), jnp.int32(1))
    with quant.precision("w8a8"), torch.no_grad():
        tl, tstate = TM.prefill_chunk(tq, tcfg, tstate, torch.from_numpy(toks).long(), 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4, atol=1e-4)
    tok = np.array([[3], [int(np.argmax(np.asarray(rl)[0, -1]))]], np.int32)
    for _ in range(2):
        with rmodes.precision("w8a8"):
            rl, rstate = RM.paged_decode_step(rq, rcfg, rstate, jnp.asarray(tok))
        with quant.precision("w8a8"), torch.no_grad():
            tl, new = TM.paged_decode_step(tq, tcfg, tstate, torch.from_numpy(tok).long())
        tstate.lengths = new.lengths
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4, atol=1e-4)
        tok = np.argmax(np.asarray(rl)[:, -1], -1)[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1), tok[:, 0])
    _assert_states(rstate, tstate, tcfg, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_quantized_leaves_follow_reference(built, arch):
    """QUANT_KEYS quantize (mLSTM w_up / w_q / w_k / w_v / w_down, sLSTM
    w_ff_up / w_ff_down, Mamba w_in / w_out, attention, the dense MLPs, the
    head); the gates, dt / x projections, convs, recurrent matrices and
    every MoE dict stay float; counted per layer as (reference - 1) x
    n_groups + 1."""
    rcfg, rparams, tcfg, tparams = built(arch)
    rq = rquant.quantize_params(rparams, cfg=rcfg)
    tq = quant.quantize_params(tparams, cfg=tcfg)
    assert quant.quantized_leaf_count(tq) == \
        (rquant.quantized_leaf_count(rq) - 1) * tcfg.n_groups + 1
    for layer in tq["layers"]:
        mixer = layer["mixer"]
        for name in ("w_i", "w_f", "w_x", "w_dt", "conv_w", "r_i", "w_z", "w_o"):
            if name in mixer:
                assert isinstance(mixer[name], torch.Tensor), name
        for name in ("w_q", "w_up", "w_in", "w_ff_up", "wq"):
            if name in mixer:
                assert isinstance(mixer[name], quant.QuantTensor), name


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_calibration_table_matches_reference(built, arch):
    """The calibration table over the unpaged forward: the same sites (the
    reference's tap sees every `ops.linear` call, the router and the
    quant="none" gate projections among them, though only QUANT_KEYS
    leaves ever take their scale) and scales within 1e-5."""
    rcfg, rparams, tcfg, tparams = built(arch)
    batches = quant.synthetic_batches(tcfg, n=2, batch=2, seq=16, seed=3)
    want = rquant.collect_scales(rparams, rcfg, batches)
    got = quant.collect_scales(tparams, tcfg, batches)
    assert sorted(got.scales) == sorted(want.scales)
    for k, v in want.scales.items():
        assert got.scales[k] == pytest.approx(v, rel=1e-5, abs=1e-8), k
    q = quant.quantize_params(tparams, cfg=tcfg, scales=got)
    for layer in q["layers"]:
        for name, leaf in layer["mixer"].items():
            if isinstance(leaf, quant.QuantTensor):
                assert leaf.act_scale is not None, name
            elif name in ("w_i", "w_f", "w_x", "w_dt"):
                assert torch.is_tensor(leaf)
