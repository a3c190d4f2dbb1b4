"""K2's split rule and its split-K arithmetic on the CPU.

`decode_splits` picks the split count the CUDA wrapper launches with when
no spec is given; `split_decode_plain` is the kernel's split partials and
merge in plain PyTorch.  The plain split version is held against the
reference's Pallas kernel in interpret mode at the same split count,
including splits that see no live column of a slot, on float and int8
pools.  (The kernel itself is held against these on the card:
tests/test_torch_gpu.py and chip_smoke.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro.serving import kv_cache as rkvc
from repro_torch.kernels import flash_decode as tfd
from repro_torch.serving import kv_cache as tkvc


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the rule
# ---------------------------------------------------------------------------

RULE_CASES = [  # (B, Hkv, row_tiles, max_blocks, n_sm)
    (8, 1, 1, 75, 132),      # gemma3-1b decode step, 8 slots
    (1, 1, 16, 75, 132),     # gemma3-1b prefill chunk (256 packed rows)
    (1, 1, 1, 75, 132),      # one slot decoding
    (8, 1, 1, 3, 132),       # a short table: the columns cap the splits
    (8, 1, 1, 1, 132),       # one column
    (64, 8, 1, 512, 132),    # already more blocks than SMs
    (3, 2, 1, 6, 132),       # the CPU tests' pool
    (4, 2, 2, 40, 16),       # a small card
    (2, 1, 1, 1000, 132),
]


@pytest.mark.parametrize("B,Hkv,row_tiles,max_blocks,n_sm", RULE_CASES)
def test_decode_splits_properties(B, Hkv, row_tiles, max_blocks, n_sm):
    """Fills two blocks per SM where the columns allow it, keeps two
    columns per split and never more splits than columns; deterministic."""
    splits = tfd.decode_splits(B, Hkv, row_tiles, max_blocks, n_sm)
    base = B * Hkv * row_tiles
    assert 1 <= splits <= max_blocks
    cols = tfd.split_columns(max_blocks, splits)
    assert cols[0][0] == 0 and cols[-1][1] == max_blocks
    assert all(a[1] == b[0] for a, b in zip(cols, cols[1:]))
    if max_blocks >= 2:
        assert min(c1 - c0 for c0, c1 in cols) >= 2
    if base * (max_blocks // 2) >= 2 * n_sm:
        assert base * splits >= 2 * n_sm                 # the card is filled
        assert base * (splits - 1) < 2 * n_sm or splits == 1   # and no more than that
    else:
        assert splits == max(1, max_blocks // 2)         # as many as the columns allow
    tfd.decode_splits.cache_clear()
    assert tfd.decode_splits(B, Hkv, row_tiles, max_blocks, n_sm) == splits


def test_decode_splits_gemma3_shapes():
    """The counts gemma3-1b's serving run launches with on 132 SMs."""
    assert tfd.decode_splits(8, 1, 1, 75, 132) == 33     # 264 blocks
    assert tfd.decode_splits(1, 1, 16, 75, 132) == 17    # 272 blocks
    assert tfd.decode_splits(1, 1, 1, 75, 132) == 37     # capped at 2 columns
    assert tfd.decode_splits(8, 1, 1, 3, 132) == 1


@pytest.mark.parametrize("max_blocks,splits", [(6, 4), (75, 33), (7, 3), (5, 5), (1, 1)])
def test_split_columns_cover_the_table(max_blocks, splits):
    cols = tfd.split_columns(max_blocks, splits)
    covered = [c for c0, c1 in cols for c in range(c0, c1)]
    assert covered == list(range(max_blocks))
    widths = {c1 - c0 for c0, c1 in cols}
    assert widths <= {max_blocks // splits, -(-max_blocks // splits)}


# ---------------------------------------------------------------------------
# the plain split version against the reference's Pallas kernel
# ---------------------------------------------------------------------------

B, BS, MAX_BLOCKS, HKV, GROUPS, D = 4, 4, 8, 2, 2, 16
LENGTHS = np.array([1, 5, 13, MAX_BLOCKS * BS], np.int32)   # a 1-token slot, one at cap


def _pools(kv_precision, seed=0):
    rng = np.random.default_rng(seed)
    nb = 1 + B * MAX_BLOCKS
    L = int(LENGTHS.max())
    k_new = rng.normal(size=(B, L, HKV, D)).astype(np.float32)
    v_new = rng.normal(size=(B, L, HKV, D)).astype(np.float32)
    rcache = rkvc.init_paged_kv(nb, BS, HKV, D, jnp.float32, kv_precision=kv_precision)
    tcache = tkvc.init_paged_kv(nb, BS, HKV, D, torch.float32, "cpu",
                                kv_precision=kv_precision)
    alloc, tables = tkvc.BlockAllocator(nb, BS), tkvc.BlockTables(B, MAX_BLOCKS)
    for s in range(B):
        tables.ensure(s, int(LENGTHS[s]), alloc)
    rbt, tbt = jnp.asarray(tables.table), tables.array("cpu")
    rcache = jax.jit(rkvc.write_kv)(rcache, rbt, jnp.asarray(k_new), jnp.asarray(v_new), 0)
    tkvc.write_kv(tcache, tbt, torch.from_numpy(k_new), torch.from_numpy(v_new), 0)
    return (rcache, rbt), (tcache, tbt)


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
@pytest.mark.parametrize("sq,window,splits", [
    (1, None, 1),
    (1, None, 3),     # uneven columns
    (1, None, 8),     # one column per split: the short slots' later splits are dead
    (3, None, 4),     # Sq > 1
    (1, 6, 4),        # the window empties the first splits of the long slots
    (3, 6, 8),        # everything at once
])
def test_split_decode_plain_matches_reference_kernel(kv_precision, sq, window, splits):
    """`split_decode_plain` reproduces the Pallas kernel (interpret mode) at
    the same split count within 1e-5 in f32, and agrees with the port's
    plain walk: the merge of per-split partials is exact whichever splits
    are dead."""
    (rcache, rbt), (tcache, tbt) = _pools(kv_precision)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, sq, HKV * GROUPS, D)).astype(np.float32)
    idx = np.maximum(LENGTHS - sq, 0).astype(np.int32)
    want = np.asarray(rfd.flash_decode_attention(
        jnp.asarray(q), rcache, rbt, jnp.asarray(idx), window=window,
        spec=rfd.FlashDecodeSpec(num_splits=splits), interpret=True))
    tq, tidx = torch.from_numpy(q), torch.from_numpy(idx)
    got = tfd.split_decode_plain(tq, tcache, tbt, tidx, splits, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    walk = tfd.ref_paged_decode(tq, tcache, tbt, tidx, window=window)
    np.testing.assert_allclose(got.numpy(), walk.numpy(), rtol=1e-5, atol=1e-5)


def test_split_decode_plain_dead_splits_carry_no_weight():
    """A slot whose live columns are all in split 0 gives the same output
    at every split count: the dead splits' partials are skipped."""
    _, (tcache, tbt) = _pools("float")
    rng = np.random.default_rng(2)
    tq = torch.from_numpy(rng.normal(size=(B, 1, HKV * GROUPS, D)).astype(np.float32))
    tidx = torch.from_numpy((LENGTHS - 1).astype(np.int32))
    base = tfd.split_decode_plain(tq, tcache, tbt, tidx, 1)
    for splits in (2, 4, 8):
        got = tfd.split_decode_plain(tq, tcache, tbt, tidx, splits)
        torch.testing.assert_close(got[:2], base[:2], rtol=1e-6, atol=1e-6)  # slots of 1 and 5 tokens
        torch.testing.assert_close(got, base, rtol=1e-5, atol=1e-5)
