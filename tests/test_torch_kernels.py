"""Port kernels against the reference: the plain GeMM and plain paged
decode against the Pallas kernels in interpret mode and the reference's
oracles, on the same numpy-made inputs; CPU tensors never launch a CUDA
kernel.  (The int8 kernels' plain versions: tests/test_torch_quant.py.)  (The CUDA kernels themselves are held against these plain
versions on the card: tests/test_torch_gpu.py and chip_smoke.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models.attention import decode_attention as r_decode_attention
from repro.serving import kv_cache as rkvc
from repro_torch import quant
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import gemm_int8 as tgemm8
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tkquant
from repro_torch.serving import kv_cache as tkvc


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# GeMM
# ---------------------------------------------------------------------------

# f32 out in both dtypes: bf16 products are exact in f32, so either way the
# packages differ only in the order of the f32 sums -> 1e-5 for both.
GEMM_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=1e-5, atol=1e-5)}
GEMM_CASES = [  # (M, K, N, transposed B view)
    (8, 64, 96, False),
    (13, 70, 45, False),      # ragged everywhere
    (1, 33, 129, True),       # the tied-head shape class: B = table.T
    (64, 40, 17, True),
]


def _operands(M, K, N, transposed, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = rng.normal(size=(N, K) if transposed else (K, N)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,transposed", GEMM_CASES)
def test_gemm_plain_matches_reference_kernel(M, K, N, transposed, dtype):
    """Plain GeMM == the Pallas kernel (interpret mode) == ref.gemm_ref, f32
    out, for ragged shapes and a transposed-view B."""
    a, b = _operands(M, K, N, transposed)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ja = jnp.asarray(a, jdt)
    jb = jnp.asarray(b, jdt).T if transposed else jnp.asarray(b, jdt)
    want_kernel = np.asarray(rops.gemm(ja, jb, backend="interpret"))
    want_ref = np.asarray(rref.gemm_ref(ja, jb))
    ta = torch.from_numpy(a).to(tdt)
    tb = torch.from_numpy(b).to(tdt)
    tb = tb.t() if transposed else tb
    got = tops.gemm(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want_kernel, **GEMM_TOL[dtype])
    np.testing.assert_allclose(got.numpy(), want_ref, **GEMM_TOL[dtype])


def test_linear_casts_to_input_dtype_and_rejects_int8():
    """`linear` answers in the input's dtype; quant="int8" on a float weight
    (activations per row, the weight per column, dequant epilogue) matches
    the reference's `linear(..., quant="int8")` and no longer raises."""
    a, b = _operands(6, 16, 8, False)
    x = torch.from_numpy(a).to(torch.bfloat16).reshape(2, 3, 16)
    y = tops.linear(x, torch.from_numpy(b).to(torch.bfloat16))
    assert y.shape == (2, 3, 8) and y.dtype == torch.bfloat16
    want = (torch.from_numpy(a).to(torch.bfloat16).float()
            @ torch.from_numpy(b).to(torch.bfloat16).float()).to(torch.bfloat16)
    assert torch.equal(y.reshape(6, 8), want)
    for dtype in ("float32", "bfloat16"):
        tx = torch.from_numpy(a).to(getattr(torch, dtype)).reshape(2, 3, 16)
        jx = jnp.asarray(a, getattr(jnp, dtype)).reshape(2, 3, 16)
        got = tops.linear(tx, torch.from_numpy(b), quant="int8")
        want = np.asarray(rops.linear(jx, jnp.asarray(b), quant="int8"), np.float32)
        assert got.shape == (2, 3, 8) and got.dtype == tx.dtype
        np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# paged flash-decode (pool and queries built as tests/test_flash_decode.py)
# ---------------------------------------------------------------------------

B, BS, MAX_BLOCKS, HKV, GROUPS, D = 3, 4, 6, 2, 2, 16
LENGTHS = np.array([5, 12, MAX_BLOCKS * BS], np.int32)   # ragged, one at cap


def _pools(seed=0, d=D):
    """The same lived-in pool in both packages: ragged per-slot lengths,
    every live position written through each package's write_kv."""
    rng = np.random.default_rng(seed)
    num_blocks = 1 + B * MAX_BLOCKS
    L = int(LENGTHS.max())
    k_new = rng.normal(size=(B, L, HKV, d)).astype(np.float32)
    v_new = rng.normal(size=(B, L, HKV, d)).astype(np.float32)

    rcache = rkvc.init_paged_kv(num_blocks, BS, HKV, d, jnp.float32)
    ralloc, rtables = rkvc.BlockAllocator(num_blocks, BS), rkvc.BlockTables(B, MAX_BLOCKS)
    tcache = tkvc.init_paged_kv(num_blocks, BS, HKV, d, torch.float32, "cpu")
    talloc, ttables = tkvc.BlockAllocator(num_blocks, BS), tkvc.BlockTables(B, MAX_BLOCKS)
    for s in range(B):
        rtables.ensure(s, int(LENGTHS[s]), ralloc)
        ttables.ensure(s, int(LENGTHS[s]), talloc)
    rbt, tbt = rtables.array(), ttables.array("cpu")
    rcache = rkvc.write_kv(rcache, rbt, jnp.asarray(k_new), jnp.asarray(v_new), 0)
    tkvc.write_kv(tcache, tbt, torch.from_numpy(k_new), torch.from_numpy(v_new), 0)
    return (rcache, rbt), (tcache, tbt)


def _query(sq, seed=1, d=D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, sq, HKV * GROUPS, d)).astype(np.float32)
    return q, (LENGTHS - sq).astype(np.int32)   # first query position


@pytest.mark.parametrize("sq,window,splits", [
    (1, None, 1),     # plain decode
    (1, None, 4),     # split-K (uneven: 6 cols over 4 splits)
    (3, None, 2),     # Sq > 1, split
    (1, 6, 1),        # sliding window
    (3, 6, 4),        # everything at once
])
def test_paged_decode_plain_matches_reference(sq, window, splits):
    """The port's plain paged decode (and its gather oracle) reproduce the
    Pallas kernel in interpret mode and the reference's bounded walk."""
    (rcache, rbt), (tcache, tbt) = _pools()
    q, idx = _query(sq)
    want_kernel = np.asarray(rfd.flash_decode_attention(
        jnp.asarray(q), rcache, rbt, jnp.asarray(idx), window=window,
        spec=rfd.FlashDecodeSpec(num_splits=splits), interpret=True))
    want_walk = np.asarray(rfd.ref_paged_decode(
        jnp.asarray(q), rcache, rbt, jnp.asarray(idx), window=window))
    want_oracle = np.asarray(r_decode_attention(
        jnp.asarray(q), *rkvc.gather_kv(rcache, rbt), index=jnp.asarray(idx),
        window=window))
    tq, tidx = torch.from_numpy(q), torch.from_numpy(idx)
    spec = tfd.FlashDecodeSpec(num_splits=splits)
    got = tfd.paged_decode_attention(tq, tcache, tbt, tidx, window=window, spec=spec)
    got_oracle = tfd.gather_decode(tq, tcache, tbt, tidx, window=window)
    for want in (want_kernel, want_walk, want_oracle):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_oracle.numpy(), want_oracle, rtol=1e-5, atol=1e-5)


def test_cpu_tensors_launch_no_kernel():
    """On CPU tensors the wrappers run the plain versions: no CUDA kernel
    launches, so the launch counters stay 0 (float and int8 GeMMs, row
    quantization, and paged decode over a float and an int8 pool)."""
    for mod in (tgemm, tgemm8, tkquant, tfd):
        mod.reset_launches()
    a, b = _operands(4, 8, 8, False)
    x, w = torch.from_numpy(a), torch.from_numpy(b)
    tops.linear(x, w)
    tops.linear(x, w, quant="int8")
    tops.linear(x, quant.quantize_leaf(w))
    tops.gemm(tops.quantize(x)[0], quant.quantize_leaf(w).q)
    (_, _), (tcache, tbt) = _pools()
    q, idx = _query(1)
    tfd.paged_decode_attention(torch.from_numpy(q), tcache, tbt, torch.from_numpy(idx))
    cache8 = tkvc.init_paged_kv(tcache.k.shape[0], BS, HKV, D, torch.float32, "cpu",
                                kv_precision="int8")
    tfd.paged_decode_attention(torch.from_numpy(q), cache8, tbt, torch.from_numpy(idx))
    assert (tgemm.launches, tgemm8.launches, tgemm8.int_launches, tkquant.launches,
            tfd.launches, tfd.launches_int8) == (0,) * 6
