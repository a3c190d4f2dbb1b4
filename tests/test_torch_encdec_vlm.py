"""The encoder-decoder (whisper-medium) and VLM (paligemma-3b) families in
the port against the reference on the CPU: the configs and parameter
counts, whisper's encoder, `forward` and `trunk` (the cross-attention over
the encoder's frames; the projected patch prefix under the prefix-LM mask),
the prefix-LM attention itself, `prefill` with greedy `decode_step`
(whisper's cross caches; paligemma's prefix-less decode cache, which the
port reproduces as the reference has it), w8a8 against the reference's
`quantize_params` run, and the refusals (calibration, the paged state, the
engine, the serve CLI).  Smoke configs in float32 with the reference's
weights bridged; frames and patches drawn with numpy.

Tolerances (float32): the family tests' bars, logits within 2e-5
(whisper's encoder output and paligemma's logits) or 5e-5 (decode steps after
prefill, and whisper's logits of |x| ~ 4) absolute and relative; w8a8
within 1e-4 of the reference's w8a8 run, as the family w8a8 tests hold;
greedy tokens exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import quant as rquant
from repro.models import attention as rattn
from repro.models import model as RM
from repro.quant import modes as rmodes
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM

ARCHS = ["whisper-medium", "paligemma-3b"]
TOL = dict(rtol=2e-5, atol=2e-5)
STEP_TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
            rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
            tparams = bridge.params_from_reference(
                jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
            cache[arch] = (rcfg, rparams, tcfg, tparams)
        return cache[arch]
    return get


def batches(cfg, B=2, S=8, seed=0):
    """The same batch for both packages: tokens, and whisper's frames or
    paligemma's patches, drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks).long()}
    if cfg.family == "encdec":
        x = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        rb["frames"], tb["frames"] = jnp.asarray(x), torch.from_numpy(x)
    if cfg.family == "vlm":
        x = rng.normal(size=(B, cfg.prefix_len, RM.VISION_DIM)).astype(np.float32)
        rb["patches"], tb["patches"] = jnp.asarray(x), torch.from_numpy(x)
    return rb, tb


# -- configs and parameters ---------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Family, encoder / prefix fields, layer kinds (all "attn"), groups
    and the parameter count (with whisper's encoder and cross term) equal
    the reference's, published and smoke."""
    for rcfg, tcfg in ((rconfigs.get(arch), tconfigs.get(arch)),
                       (rconfigs.get_smoke(arch), tconfigs.get_smoke(arch))):
        for f in ("family", "encoder_layers", "encoder_seq", "prefix_len", "n_groups",
                  "d_model", "vocab", "tie_embeddings", "mlp_variant", "norm"):
            assert getattr(tcfg, f) == getattr(rcfg, f), f
        assert tcfg.layer_kinds() == rcfg.layer_kinds() == ("attn",) * rcfg.group_size
        assert tcfg.param_count() == rcfg.param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_holds_the_reference_leaves(built, arch):
    """init_model's tree has the reference's leaves (encoder blocks as a
    flat list of the stacked leaves, the projector, every layer's cross
    attention without QKV bias), with their shapes; the bridge fills it."""
    rcfg, rparams, tcfg, tparams = built(arch)
    mine = TM.init_model(tcfg, seed=0, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(mine) == shapes(tparams)
    assert len(mine["layers"]) == tcfg.n_layers
    if arch == "whisper-medium":
        assert len(mine["encoder_blocks"]) == tcfg.encoder_layers
        assert all("cross" in p and "norm_cross" in p for p in mine["layers"])
        assert all("cross" not in p for p in mine["encoder_blocks"])
        enc = jax.tree_util.tree_map(np.asarray, rparams["encoder_blocks"])
        np.testing.assert_array_equal(tparams["encoder_blocks"][1]["mixer"]["wq"].numpy(),
                                      enc["mixer"]["wq"][1])
    else:
        assert mine["projector"].shape == (TM.VISION_DIM, tcfg.d_model)
        np.testing.assert_array_equal(tparams["projector"].numpy(),
                                      np.asarray(rparams["projector"]))
    assert bridge.param_count(tparams) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(rparams))


# -- the encoder, forward and trunk --------------------------------------------------


def test_run_encoder_matches_reference(built):
    """Whisper's encoder: non-causal blocks with RoPE at the frames'
    positions through K5's plain version, then the encoder norm."""
    rcfg, rparams, tcfg, tparams = built("whisper-medium")
    rb, tb = batches(tcfg)
    want = np.asarray(RM._run_encoder(rb["frames"], rparams, rcfg))
    with torch.no_grad():
        got = TM._run_encoder(tb["frames"], tparams, tcfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_match_reference(built, arch, last_only):
    rcfg, rparams, tcfg, tparams = built(arch)
    rb, tb = batches(tcfg)
    want = np.asarray(RM.forward(rparams, rcfg, rb, last_only=last_only))
    with torch.no_grad():
        got = TM.forward(tparams, tcfg, tb, last_only=last_only).numpy()
    assert got.shape == want.shape == (2, 1 if last_only else 8, tcfg.vocab)
    np.testing.assert_allclose(got, want, **(STEP_TOL if arch == "whisper-medium" else TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_trunk_matches_reference(built, arch):
    """Final hidden states (B, S, d), paligemma's prefix dropped."""
    rcfg, rparams, tcfg, tparams = built(arch)
    rb, tb = batches(tcfg, seed=1)
    want = np.asarray(RM.trunk(rparams, rcfg, rb))
    with torch.no_grad():
        got = TM.trunk(tparams, tcfg, tb).numpy()
    assert got.shape == (2, 8, tcfg.d_model)
    np.testing.assert_allclose(got, want, **STEP_TOL)


def test_prefix_lm_bidirectional_prefix():
    """The port's version of tests/test_models.py's test: prefix queries see
    the whole prefix, a suffix key stays hidden from earlier suffix
    queries; and the output equals the reference's blockwise attention on
    the same inputs."""
    B, S, H, D = 1, 16, 2, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(3))

    def port(vv):
        return tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(vv), causal=True,
                                         prefix_len=6, block_kv=4).numpy()
    out = port(v)
    want = np.asarray(rattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                                jnp.asarray(v), causal=True,
                                                prefix_len=6, block_kv=4))
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    v2 = v.copy()
    v2[:, 5] += 10.0
    assert float(np.abs(port(v2)[:, 0] - out[:, 0]).max()) > 1e-4
    v3 = v.copy()
    v3[:, 15] += 10.0
    np.testing.assert_allclose(port(v3)[:, 10], out[:, 10], rtol=1e-6)


# -- prefill and greedy decode ---------------------------------------------------------


def _greedy(M, params, cfg, state, logits, steps, torch_side):
    """`steps` greedy decode steps from `logits`: (tokens (B, steps),
    per-step logits)."""
    toks, outs = [], []
    for _ in range(steps):
        if torch_side:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            with torch.no_grad():
                logits, state = M.decode_step(params, cfg, state, tok)
            toks.append(tok.numpy())
            outs.append(logits.numpy())
        else:
            tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
            logits, state = M.decode_step(params, cfg, state, tok)
            toks.append(np.asarray(tok))
            outs.append(np.asarray(logits))
    return np.concatenate(toks, axis=1), outs, state


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_reference(built, arch):
    """prefill's last logits and six greedy decode steps: tokens equal, logits
    within the step bar, the index advanced in place.  For paligemma this
    pins the prefix-less decode cache: its decode logits are the
    reference's, which differ from the teacher-forced `forward` with the
    image prefix."""
    rcfg, rparams, tcfg, tparams = built(arch)
    rb, tb = batches(tcfg, B=2, S=7, seed=2)
    rl, rstate = RM.prefill(rparams, rcfg, rb, 16)
    with torch.no_grad():
        tl, tstate = TM.prefill(tparams, tcfg, tb, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **STEP_TOL)
    assert int(tstate.index) == int(rstate.index) == 7
    rt, routs, _ = _greedy(RM, rparams, rcfg, rstate, rl, 6, False)
    tt, touts, tstate = _greedy(TM, tparams, tcfg, tstate, tl, 6, True)
    np.testing.assert_array_equal(tt, rt)
    for g, w in zip(touts, routs):
        np.testing.assert_allclose(g, w, **STEP_TOL)
    assert int(tstate.index) == 13
    if arch == "paligemma-3b":
        # The reference's behaviour, reproduced: the next decode step after
        # a prefix-less cache is not forward's next position with the prefix.
        toks = np.concatenate([np.asarray(rb["tokens"]), rt[:, :1]], axis=1)
        rb2 = dict(rb, tokens=jnp.asarray(toks))
        full = np.asarray(RM.forward(rparams, rcfg, rb2))[:, -1]
        assert float(np.abs(full - routs[0][:, -1]).max()) > 1e-3


# -- w8a8 -------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_logits_match_reference_w8a8(built, arch):
    """Under w8a8 (the encoder's projections, the cross projections, the
    projector, the layers and the head int8-resident): forward logits,
    and prefill with two greedy decode steps (whisper's cross caches
    projected by the int8 wk / wv), within 1e-4 of the reference's
    `quantize_params` run, tokens equal."""
    rcfg, rparams, tcfg, tparams = built(arch)
    rq = rquant.quantize_params(rparams, cfg=rcfg)
    tq = quant.quantize_params(tparams, cfg=tcfg)
    if arch == "whisper-medium":
        assert isinstance(tq["encoder_blocks"][0]["mixer"]["wq"], quant.QuantTensor)
        assert all(isinstance(p["cross"][n], quant.QuantTensor)
                   for p in tq["layers"] for n in ("wq", "wk", "wv", "wo"))
        assert isinstance(tq["head"], quant.QuantTensor)
    else:
        assert isinstance(tq["projector"], quant.QuantTensor)
        assert isinstance(tq["head_q"], quant.QuantTensor)
    rb, tb = batches(tcfg, seed=3)
    with rmodes.precision("w8a8"):
        want = np.asarray(RM.forward(rq, rcfg, rb))
        rl, rstate = RM.prefill(rq, rcfg, rb, 12)
        rt, routs, _ = _greedy(RM, rq, rcfg, rstate, rl, 2, False)
    with quant.precision("w8a8"), torch.no_grad():
        got = TM.forward(tq, tcfg, tb).numpy()
        tl, tstate = TM.prefill(tq, tcfg, tb, 12)
        tt, touts, _ = _greedy(TM, tq, tcfg, tstate, tl, 2, True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tt, rt)
    for g, w in zip(touts, routs):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_act_scales_take_the_reference_keys(built):
    """A reference-keyed scale table reaches the encoder blocks (one entry
    for the stack, "encoder_blocks.mixer.wq"), the cross projections
    (per group) and the projector."""
    _, _, tcfg, tparams = built("whisper-medium")
    table = {"encoder_blocks.mixer.wq": 0.5, "blocks.0.sub0.cross.wk": 0.25,
             "blocks.1.sub0.cross.wk": 0.125}
    tq = quant.quantize_params(tparams, cfg=tcfg, scales=table)
    assert [float(b["mixer"]["wq"].act_scale) for b in tq["encoder_blocks"]] == [0.5, 0.5]
    assert [float(p["cross"]["wk"].act_scale) for p in tq["layers"]] == [0.25, 0.125]
    assert tq["layers"][0]["cross"]["wq"].act_scale is None
    _, _, vcfg, vparams = built("paligemma-3b")
    vq = quant.quantize_params(vparams, cfg=vcfg, scales={"projector": 0.75})
    assert float(vq["projector"].act_scale) == 0.75


# -- refusals ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_refuses_the_family(built, arch):
    """As the reference's `calibrate` does (src/repro/quant/calibrate.py:201)."""
    rcfg, rparams, tcfg, tparams = built(arch)
    batch = np.zeros((1, 4), np.int32)
    with pytest.raises(NotImplementedError, match=tcfg.family):
        quant.collect_scales(tparams, tcfg, [batch])
    with pytest.raises(NotImplementedError, match=rcfg.family):
        rquant.collect_scales(rparams, rcfg, [batch])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_refuses_the_family(arch):
    """The serve CLI's engine path refuses whisper and paligemma, naming
    the family, before it makes any weight."""
    family = tconfigs.get(arch).family
    with pytest.raises(NotImplementedError, match=f"family {family!r}"):
        tserve.main(["--arch", arch, "--device", "cpu", "--requests", "1"])


def test_encdec_decode_state_needs_the_encoder(built):
    rcfg, rparams, tcfg, tparams = built("whisper-medium")
    with pytest.raises(ValueError, match="encoder_out"):
        TM.init_decode_state(tparams, tcfg, 2, 8)
    enc = torch.zeros((2, tcfg.encoder_seq, tcfg.d_model))
    state = TM.init_decode_state(tparams, tcfg, 2, 8, encoder_out=enc)
    assert len(state.cross_caches) == tcfg.n_layers
    assert state.cross_caches[0].k.shape == (2, tcfg.encoder_seq, tcfg.n_kv_heads,
                                             tcfg.resolved_head_dim)
    assert dataclasses.is_dataclass(state) and state.index.dtype == torch.int32
