"""K5 and K5b with a q offset (a sequence-parallel rank's chunk of the
queries over the whole key sequence), on the CPU: the plain versions
against the reference's XLA blockwise attention and `jax.vjp` of it, the
autograd Function, the model's routing of an int offset to the kernel,
K5b's tile walks and launch plan under an offset, the zero dK / dV of the
key tiles no query sees, and the offset's pair counts.  The card's kernels
at these offsets: tests/test_torch_gpu.py (`gpu`-marked) and chip_smoke.py
phase 2 (18c)."""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as rattn
from repro_torch.kernels import cost as kcost
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

# (B, Sq, Skv, Hq, Hkv, D, causal, window, q_offset): queries at offset ..
# offset + Sq - 1 over keys 0 .. Skv - 1; GQA 4 / 2 and 4 / 1; Sq < Skv.
OFFSET_CASES = [
    (2, 16, 40, 4, 2, 16, True, None, 0),
    (2, 16, 40, 4, 2, 16, True, None, 8),
    (2, 16, 40, 4, 2, 16, True, None, 24),
    (2, 16, 40, 4, 1, 16, True, 8, 0),
    (2, 16, 40, 4, 1, 16, True, 8, 8),
    (2, 16, 40, 4, 1, 16, True, 8, 24),
    (1, 13, 50, 4, 2, 32, True, 8, 37),      # an offset that is no multiple of a tile
    (1, 8, 32, 4, 1, 16, False, 8, 24),     # windowed, not causal
]
TOL = 2e-5                   # of each output's or gradient's largest element, f32


def _arrays(case):
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(sum(case[:6]) + case[8])
    return [rng.normal(size=s).astype(np.float32) for s in
            ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D), (B, Sq, Hq, D))]


@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_plain_forward_and_backward_at_an_offset_match_reference(case):
    """`flash_attention_plain` and `flash_attention_bwd_plain` at a q offset
    against the reference's `_blockwise_attention` (its XLA path, kv blocks
    of 8) and `jax.vjp` of it; the autograd Function runs the same plain
    backward; f32 within 2e-5 of each result's largest element."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, off = case
    q, k, v, do = _arrays(case)

    def ref_fn(q, k, v):
        return rattn._blockwise_attention(q, k, v, off, causal=causal, window=window,
                                          prefix_len=0, block_kv=8, softcap=None)

    rout, vjp = jax.vjp(ref_fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                         q_offset=off, return_lse=True)
    rout = np.asarray(rout)
    np.testing.assert_allclose(out.numpy(), rout, rtol=0,
                               atol=TOL * float(np.abs(rout).max()))
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal,
                                        window=window, q_offset=off)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    fn = torch.autograd.grad(tfa.flash_attention(*leaves, causal=causal, window=window,
                                                 q_offset=off), leaves, tdo)
    for g, w, f in zip(got, want, fn):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL * float(np.abs(w).max()))
        assert torch.equal(f, g)          # the Function runs the plain backward


@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_unseen_keys_get_zero_gradients(case):
    """Keys past the last query's position (causal), or before the first
    query's window, get dK = dV = 0 exactly."""
    B, Sq, Skv, Hq, Hkv, D, causal, window, off = case
    tq, tk, tv, tdo = map(torch.from_numpy, _arrays(case))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                         q_offset=off, return_lse=True)
    _, dk, dv = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal,
                                              window=window, q_offset=off)
    kpos = np.arange(Skv)
    seen = np.ones(Skv, dtype=bool)
    if causal:
        seen &= kpos <= off + Sq - 1
    if window is not None:
        seen &= kpos > off - window
    for g in (dk, dv):
        assert bool((g[:, ~seen] == 0).all())
        assert bool((g[:, seen].abs().amax(dim=(0, 2, 3)) > 0).all())
    assert (~seen).any() == (causal and off + Sq < Skv or window is not None and off >= window)


def test_chunks_at_their_offsets_make_the_whole_attention():
    """The ranks' chunks of the queries at their offsets give the whole
    sequence's output and lse bit for bit (the plain version), and their
    dK / dV sum to the whole call's within f32 rounding."""
    rng = np.random.default_rng(3)
    B, S, Hq, Hkv, D = 2, 32, 4, 1, 16
    q, do = (torch.from_numpy(rng.normal(size=(B, S, Hq, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, Hkv, D)).astype(np.float32))
            for _ in range(2))
    for window in (None, 8):
        whole, lse = tfa.flash_attention_plain(q, k, v, window=window, return_lse=True)
        _, wdk, wdv = tfa.flash_attention_bwd_plain(q, k, v, whole, lse, do, window=window)
        for M in (2, 4):
            s = S // M
            dk, dv = torch.zeros_like(k), torch.zeros_like(v)
            for r in range(M):
                c = slice(r * s, (r + 1) * s)
                o, l = tfa.flash_attention_plain(q[:, c], k, v, window=window,
                                                 q_offset=r * s, return_lse=True)
                assert torch.equal(o, whole[:, c]) and torch.equal(l, lse[..., c])
                _, a, b = tfa.flash_attention_bwd_plain(q[:, c], k, v, o, l, do[:, c],
                                                        window=window, q_offset=r * s)
                dk, dv = dk + a, dv + b
            torch.testing.assert_close(dk, wdk, rtol=0, atol=1e-5)
            torch.testing.assert_close(dv, wdv, rtol=0, atol=1e-5)


def test_model_routes_an_int_offset_to_the_kernel(monkeypatch):
    """`models.attention.blockwise_attention` sends an int q offset (no
    prefix, no softcap) to `kernels.flash_attention`, K5 on the card; a
    tensor offset, a prefix or a softcap stays on the plain blockwise path,
    as the reference keeps them on its XLA path."""
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append(k["q_offset"]) or real(*a, **k))
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 8, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(1, 24, 2, 16)).astype(np.float32))
            for _ in range(2))
    out = tattn.blockwise_attention(q, k, v, causal=True, q_offset=16, window=8)
    assert calls == [16]
    torch.testing.assert_close(out, tfa.flash_attention_plain(q, k, v, window=8, q_offset=16),
                               rtol=0, atol=0)
    for kw in ({"q_offset": torch.tensor(16)}, {"q_offset": 16, "prefix_len": 4},
               {"q_offset": 16, "softcap": 30.0}):
        want = tref.blockwise_attention_ref(q, k, v, causal=True, window=8, block_kv=1024,
                                            scale_in_f32=False, **kw)
        assert torch.equal(tattn.blockwise_attention(q, k, v, causal=True, window=8, **kw),
                           want)
    assert calls == [16]
    with pytest.raises(ValueError, match="q_offset"):
        tfa.flash_attention(q, k, v, q_offset=-1)


# K5b's walks under an offset: a rank's chunk of 512 queries over 1024 keys
# at offsets 0 and 512 (40 / 8 heads, causal, and a 512 window), gemma3-1b's
# 4 / 1 at D 256, and an offset that is no multiple of a tile.
PLAN_CASES = [  # (Sq, Skv, Hq, Hkv, causal, window, q_offset)
    (512, 1024, 40, 8, True, None, 0), (512, 1024, 40, 8, True, None, 512),
    (512, 1024, 40, 8, True, 512, 0), (512, 1024, 40, 8, True, 512, 512),
    (512, 1024, 4, 1, True, 512, 512), (100, 137, 4, 1, True, None, 37),
    (100, 300, 4, 1, True, 64, 37), (64, 256, 4, 2, False, 40, 150),
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_backward_walks_at_an_offset_cover_each_live_pair_once(case):
    """Under a q offset the dK / dV kernel's walk covers every query row
    that sees a key tile exactly once with tiles that each hold a live
    pair (its tiles start where the tile's first live row is, not on the
    64-row grid), and is empty for a tile no row sees; the dQ kernel's walk
    visits every key tile with a live entry for its query tile once; the
    plan launches a heaviest tile first where the work is a ramp."""
    Sq, Skv, Hq, Hkv, causal, window, off = case
    T = tfa.BWD_TILE
    qpos, kpos = off + np.arange(Sq), np.arange(Skv)
    live = np.ones((Sq, Skv), dtype=bool)
    if causal:
        live &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        live &= qpos[:, None] - kpos[None, :] < window
    kv_work = []
    for k0 in range(0, Skv, T):
        rows = Counter()
        walk = tfa.q_tiles_of_key_tile(k0, Sq, Skv, causal, window, off)
        for q0 in walk:
            r = range(q0, min(q0 + T, Sq))
            rows.update(r)
            assert live[r.start:r.stop, k0:k0 + T].any(), (k0, q0)
        want = np.flatnonzero(live[:, k0:k0 + T].any(axis=1))
        assert all(rows[i] == 1 for i in want) and max(rows.values(), default=1) == 1
        assert (len(walk) == 0) == (len(want) == 0)
        kv_work.append(len(walk))
    q_work = []
    for q0 in range(0, Sq, T):
        tiles = list(tfa.key_tiles_of_q_tile(q0, Sq, Skv, causal, window, off))
        want = [j * T for j in range(-(-Skv // T)) if live[q0:q0 + T, j * T:(j + 1) * T].any()]
        assert tiles == want, q0
        q_work.append(len(tiles))
    # The plan reverses a walk where its last tile has more work than its
    # first.  Under a window and an offset the dK / dV work can peak inside
    # the key range (a hump, not a ramp), so the rule promises only that
    # the first tile launched is no lighter than the last.
    plan = tfa.bwd_plan(Sq, Skv, Hq, Hkv, causal, window, off)
    for work, rev in ((kv_work, plan.kv_reverse), (q_work, plan.q_reverse)):
        order = work[::-1] if rev else work
        assert order[0] >= order[-1]
        if window is None:
            assert order[0] == max(work)


def test_offset_pair_counts():
    """A rank of two at 40 / 8 heads scores, a head, 131,328 (rank 0) and
    393,472 (rank 1) query-key pairs of S 1024, causal, which sum to the
    whole sequence's; the meta routes count them."""
    pairs = [kcost.attention_pairs(512, 1024, True, None, off) for off in (0, 512)]
    assert pairs == [131_328, 393_472]
    assert sum(pairs) == kcost.attention_pairs(1024, 1024, True, None)
    for window in (None, 512):
        for off in (0, 512):
            seen = []
            q = torch.empty((2, 512, 40, 128), dtype=torch.bfloat16, device="meta")
            k = torch.empty((2, 1024, 8, 128), dtype=torch.bfloat16, device="meta")
            with kcost.recording(lambda name, c: seen.append((name, c.ops))):
                out, lse = tfa._forward(q, k, k, True, window, True, off)
                tfa.flash_attention_bwd(q, k, k, out, lse, out, window=window, q_offset=off)
            n = kcost.attention_pairs(512, 1024, True, window, off)
            assert seen == [("flash_attention", 4 * 2 * 40 * 128 * n),
                            ("flash_attention_bwd", 10 * 2 * 40 * 128 * n)]
