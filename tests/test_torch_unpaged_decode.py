"""The port's unpaged decode path against the reference on the CPU, for every
family: `init_decode_state` / `decode_step` (the dense `KVCache` written in
place at the device-held index, recurrent states committed in place),
teacher-forced decode against `forward`, `prefill`, the serve step and the
token-by-token prefill of the serve CLI (`warm_token_by_token`,
`token_by_token_prefill`, `compare_prefill`, `--compare-prefill`), and the
properties a CUDA graph of the step rests on (addresses kept, the state
cleared in place).  Smoke configs in float32 with the reference's weights
bridged; inputs drawn with numpy.

Tolerances (float32): logits within 5e-5 (absolute and relative) of the
reference's, the family tests' bar; teacher-forced decode against the
port's own `forward` within 5e-5 too (the reference's test holds its own
at 2e-2 / 2e-3); greedy tokens and indices exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import attention as rattn
from repro.models import model as RM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS

ALL_ARCHS = rconfigs.list_archs()
TOL = dict(rtol=5e-5, atol=5e-5)


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


def _encoder_out(rcfg, rparams, tcfg, tparams, B, seed=1):
    """Whisper's encoder output on numpy frames, from both packages."""
    if rcfg.family != "encdec":
        return None, None
    frames = np.random.default_rng(seed).normal(
        size=(B, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    with torch.no_grad():
        tenc = TM._run_encoder(torch.from_numpy(frames), tparams, tcfg)
    return RM._run_encoder(jnp.asarray(frames), rparams, rcfg), tenc


def _batch(cfg, B, S, seed=0):
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


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_smoke_decode_shapes(built, name):
    """The port's version of tests/test_models.py's test, over every arch:
    one decode step from a fresh state gives (B, 1, vocab) finite logits,
    the reference's within the bar, and index 1."""
    rcfg, rparams, tcfg, tparams = built(name)
    B = 2
    renc, tenc = _encoder_out(rcfg, rparams, tcfg, tparams, B)
    rstate = RM.init_decode_state(rparams, rcfg, B, 24, encoder_out=renc)
    tstate = TM.init_decode_state(tparams, tcfg, B, 24, encoder_out=tenc)
    want, rstate = RM.decode_step(rparams, rcfg, rstate, jnp.zeros((B, 1), jnp.int32))
    with torch.no_grad():
        got, tstate = TM.decode_step(tparams, tcfg, tstate,
                                     torch.zeros((B, 1), dtype=torch.int64))
    assert got.shape == (B, 1, tcfg.vocab)
    assert bool(torch.isfinite(got).all())
    assert int(tstate.index) == int(rstate.index) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["qwen3-14b", "gemma3-1b", "xlstm-1.3b",
                                  "jamba-1.5-large-398b", "dbrx-132b", "whisper-medium"])
def test_decode_matches_forward(built, name):
    """Teacher-forced decode reproduces the port's `forward` logits, and each
    step's logits equal the reference's decode step's."""
    rcfg, rparams, tcfg, tparams = built(name)
    B, S = 2, 8
    rb, tb = _batch(tcfg, B, S)
    with torch.no_grad():
        full = TM.forward(tparams, tcfg, tb).numpy()
    renc = tenc = None
    if tcfg.family == "encdec":
        renc = RM._run_encoder(rb["frames"], rparams, rcfg)
        with torch.no_grad():
            tenc = TM._run_encoder(tb["frames"], tparams, tcfg)
    rstate = RM.init_decode_state(rparams, rcfg, B, S + 2, encoder_out=renc)
    tstate = TM.init_decode_state(tparams, tcfg, B, S + 2, encoder_out=tenc)
    outs = []
    for t in range(S):
        rl, rstate = RM.decode_step(rparams, rcfg, rstate, rb["tokens"][:, t:t + 1])
        with torch.no_grad():
            tl, tstate = TM.decode_step(tparams, tcfg, tstate, tb["tokens"][:, t:t + 1])
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
        outs.append(tl[:, 0].numpy())
    np.testing.assert_allclose(np.stack(outs, axis=1), full, **TOL)


@pytest.mark.parametrize("name", ["gemma3-1b", "dbrx-132b", "jamba-1.5-large-398b",
                                  "xlstm-1.3b"])
def test_prefill_matches_reference(built, name):
    """prefill (forward's last logits, the caches built through decode_step)
    and four greedy decode steps after it, for the dense, moe, hybrid and
    ssm families: logits within the bar, tokens and index equal, the
    recurrent states the reference's."""
    rcfg, rparams, tcfg, tparams = built(name)
    rb, tb = _batch(tcfg, 2, 9, seed=5)
    rl, rstate = RM.prefill(rparams, rcfg, rb, 16)
    with torch.no_grad():
        tl, tstate = TM.prefill(tparams, tcfg, tb, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    for _ in range(4):
        tok = np.asarray(jnp.argmax(rl[:, -1], axis=-1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        rl, rstate = RM.decode_step(rparams, rcfg, rstate, jnp.asarray(tok))
        with torch.no_grad():
            tl, tstate = TM.decode_step(tparams, tcfg, tstate, torch.from_numpy(tok).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
    assert int(tstate.index) == int(rstate.index) == 13
    kinds = tcfg.all_layer_kinds()
    for i, (kind, tc) in enumerate(zip(kinds, tstate.caches)):
        g, sub = divmod(i, tcfg.group_size)
        rc = jax.tree_util.tree_map(lambda a: np.asarray(a[g]), rstate.caches[sub])
        for tleaf, rleaf in zip(tc, rc):
            np.testing.assert_allclose(tleaf.numpy(), rleaf, **TOL)


def test_dense_cache_write_matches_reference_clamp():
    """The dense branch writes k/v at `cache_index` in place and attends
    over the cache; past the end the start clamps to S_max - S, as the
    reference's `dynamic_update_slice` does, while the mask keeps the
    unclamped index."""
    cfg = tconfigs.get_smoke("qwen3-14b")
    rcfg = rconfigs.get_smoke("qwen3-14b")
    rp = RM.init_model(jax.random.PRNGKey(1), rcfg)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a[0]), rp["blocks"]["sub0"]["mixer"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(0)
    B, S_max, hkv, hd = 2, 6, cfg.n_kv_heads, cfg.resolved_head_dim
    k0 = rng.normal(size=(B, S_max, hkv, hd)).astype(np.float32)
    v0 = rng.normal(size=(B, S_max, hkv, hd)).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    for index in (0, 3, 6, 9):
        pos = np.full((B, 1), index, np.int32)
        want, rcache = rattn.attention(
            jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p), rcfg,
            positions=jnp.asarray(pos), cache=rattn.KVCache(jnp.asarray(k0), jnp.asarray(v0)),
            cache_index=jnp.int32(index))
        cache = tattn.KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
        addr = cache.k.data_ptr()
        with torch.no_grad():
            got = tattn.attention(torch.from_numpy(x), tp, cfg, positions=torch.from_numpy(pos),
                                  cache=cache, cache_index=torch.tensor(index, dtype=torch.int32))
        assert cache.k.data_ptr() == addr
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache.k.numpy(), np.asarray(rcache.k), **TOL)
        np.testing.assert_allclose(cache.v.numpy(), np.asarray(rcache.v), **TOL)


@pytest.mark.parametrize("name", ["gemma3-1b", "jamba-1.5-large-398b", "whisper-medium"])
def test_decode_state_in_place_and_cleared(built, name):
    """What a captured step rests on: `decode_step` keeps every tensor of
    the state at its address (caches, recurrent states, cross caches, the
    index); `clear_decode_state` returns it to a fresh state's contents in
    place, so the same steps give the same logits again."""
    _, _, tcfg, tparams = built(name)
    B = 2
    tenc = None
    if tcfg.family == "encdec":
        with torch.no_grad():
            tenc = TM._run_encoder(torch.ones((B, tcfg.encoder_seq, tcfg.d_model)), tparams,
                                   tcfg)
    state = TM.init_decode_state(tparams, tcfg, B, 8, encoder_out=tenc)
    fresh = TM.init_decode_state(tparams, tcfg, B, 8, encoder_out=tenc)

    def leaves(st):
        out = [st.index]
        for c in st.caches + (st.cross_caches or []):
            out.extend(c)
        return out
    addrs = [t.data_ptr() for t in leaves(state)]
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab, size=(B, 3)))
    runs = []
    for _ in range(2):
        with torch.no_grad():
            out = [TM.decode_step(tparams, tcfg, state, toks[:, t:t + 1])[0].clone()
                   for t in range(3)]
        runs.append(torch.stack(out))
        assert int(state.index) == 3
        assert [t.data_ptr() for t in leaves(state)] == addrs
        TM.clear_decode_state(state)
        for a, b in zip(leaves(state), leaves(fresh)):
            assert torch.equal(a, b)
    assert torch.equal(runs[0], runs[1])
    assert any(isinstance(c, TS.RECURRENT_STATES) for c in state.caches) == \
        (name == "jamba-1.5-large-398b")


@pytest.mark.parametrize("name", ["gemma3-1b", "xlstm-1.3b"])
def test_token_by_token_prefill_matches_reference(built, name):
    """The serve CLI's baseline: prompts padded to the longest, fed through
    the serve step one position at a time (warmed first, run twice on the
    same warmed state): last logits and greedy tokens equal the
    reference's."""
    rcfg, rparams, tcfg, tparams = built(name)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, size=n) for n in (5, 9, 3)]
    want, _, n_ref = rserve.token_by_token_prefill(rcfg, rparams, prompts, max_seq=16)
    warmed = tserve.warm_token_by_token(tcfg, tparams, 3, 16)
    assert int(warmed[1].index) == 0
    for _ in range(2):
        got, state, n = tserve.token_by_token_prefill(tcfg, tparams, prompts, max_seq=16,
                                                      warmed=warmed)
        assert n == n_ref == 9 and int(state.index) == 9
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(got[:, -1].argmax(-1).numpy(),
                                      np.asarray(want)[:, -1].argmax(-1))


def test_serve_step_and_graphs_need_the_card(built):
    """make_serve_step is decode_step; a CUDA graph of it refuses a CPU
    state, and the CPU baseline runs eager."""
    _, _, tcfg, tparams = built("gemma3-1b")
    state = TM.init_decode_state(tparams, tcfg, 2, 8)
    step = tsteps.make_serve_step(tcfg)
    with torch.no_grad():
        logits, out = step(tparams, state, torch.zeros((2, 1), dtype=torch.int64))
    assert out is state and logits.shape == (2, 1, tcfg.vocab) and int(state.index) == 1
    with pytest.raises(ValueError, match="CUDA"):
        tsteps.GraphedServeStep(tcfg, tparams, state, 2)
    step, _ = tserve.warm_token_by_token(tcfg, tparams, 2, 8)
    assert not isinstance(step, tsteps.GraphedServeStep)


def test_compare_prefill_cli(capsys):
    """`--compare-prefill` on the CPU: the engine serves, then both prefill
    paths are timed on the same prompts and printed."""
    gen = tserve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "6",
                       "--gen-len", "2", "--compare-prefill"])
    assert gen.shape == (2, 2)
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("prefill:")]
    assert len(line) == 1 and "token-by-token" in line[0] and "chunked" in line[0]
    t_legacy, t_chunked = tserve.compare_prefill(
        tconfigs.get_smoke("gemma3-1b"), None, [np.arange(5), np.arange(3)], slots=2,
        max_seq=8, iters=1, device="cpu")
    assert t_legacy > 0 and t_chunked > 0
