"""Port kernels against the reference: the plain GeMM, plain paged
decode, plain flash attention and plain pipelined GeMM against the Pallas
kernels in interpret mode and the reference's oracles, on the same
numpy-made inputs; the GeMM backend switch; CPU tensors never launch a CUDA
kernel.  (The int8 kernels' plain versions: tests/test_torch_quant.py.)  (The CUDA kernels themselves are held against these plain
versions on the card: tests/test_torch_gpu.py and chip_smoke.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.generator import TpuGemmSpec
from repro.kernels import flash_decode as rfd
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as r_flash_attention
from repro.kernels.gemm_pipelined import make_pipelined_gemm
from repro.models.attention import decode_attention as r_decode_attention
from repro.serving import kv_cache as rkvc
from repro_torch import quant
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import gemm_int8 as tgemm8
from repro_torch.kernels import gemm_pipelined as tgp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import registry as tregistry
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
    launches, so the launch counters stay 0 (float and int8 GeMMs under both
    backends, the w8a8 GeMM with dynamic and static scales, row
    quantization, paged decode over a float and an int8 pool, and flash
    attention)."""
    for mod in (tgemm, tgemm8, tkquant, tfd, tfa, tgp):
        mod.reset_launches()
    a, b = _operands(4, 8, 8, False)
    x, w = torch.from_numpy(a), torch.from_numpy(b)
    tops.linear(x, w)
    tops.linear(x, w, quant="int8")
    tops.linear(x, quant.quantize_leaf(w))
    tops.gemm_w8a8(x, quant.quantize_leaf(w).q, quant.quantize_leaf(w).scale,
                   act_scale=torch.tensor(0.01))
    tops.gemm(tops.quantize(x)[0], quant.quantize_leaf(w).q)
    (_, _), (tcache, tbt) = _pools()
    q, idx = _query(1)
    tfd.paged_decode_attention(torch.from_numpy(q), tcache, tbt, torch.from_numpy(idx))
    cache8 = tkvc.init_paged_kv(tcache.k.shape[0], BS, HKV, D, torch.float32, "cpu",
                                kv_precision="int8")
    tfd.paged_decode_attention(torch.from_numpy(q), cache8, tbt, torch.from_numpy(idx))
    tops.linear(x, w, backend="pipelined")
    tops.gemm(tops.quantize(x)[0], quant.quantize_leaf(w).q, backend="pipelined")
    qa = torch.from_numpy(_query(4)[0])
    tfa.flash_attention(qa, qa[:, :, :HKV], qa[:, :, :HKV])
    assert (tgemm.launches, tgemm8.launches, tgemm8.int_launches, tgemm8.w8a8_launches,
            tkquant.launches, tfd.launches, tfd.launches_int8, tfa.launches,
            tgp.launches) == (0,) * 9


# ---------------------------------------------------------------------------
# flash attention (K5): shapes of tests/test_flash_attention.py + gemma3 smoke
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (B, S, Hq, Hkv, D, causal, window, reference tile)
    (1, 128, 2, 2, 64, True, None, 128),    # MHA
    (2, 256, 4, 2, 64, True, None, 128),    # GQA
    (1, 192, 4, 1, 128, True, None, 128),   # MQA, ragged seq vs tile
    (1, 128, 2, 2, 64, False, None, 64),    # non-causal
    (1, 256, 2, 1, 64, True, 64, 64),       # sliding window
    (2, 32, 4, 1, 16, True, 8, 512),        # gemma3-1b smoke: window 8 < S
]
# f32: the reference's flash tests' bar.  bf16: p and out round to bf16 at
# the same points in both (same tiling), sums in another order.
FLASH_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
             "bfloat16": dict(rtol=0, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window,tile", FLASH_CASES)
def test_flash_attention_plain_matches_reference_kernel(B, S, Hq, Hkv, D, causal,
                                                        window, tile, dtype):
    """The port's flash attention on CPU tensors (its plain version, kv
    blocks of the reference's tile) reproduces the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = r_flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                             jnp.asarray(v, jdt), causal=causal, window=window,
                             block_q=tile, block_kv=tile, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                    block_kv=tile)
    assert got.dtype == tdt and got.shape == (B, S, Hq, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **FLASH_TOL[dtype])
    dispatched = tfa.flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(dispatched.float().numpy(), np.asarray(want, np.float32),
                               **FLASH_TOL[dtype])


# ---------------------------------------------------------------------------
# pipelined GeMM (K6) and the backend switch
# ---------------------------------------------------------------------------

PIPE_CASES = [  # (M, K, N, transposed B view)
    (13, 70, 45, False),      # ragged everywhere, one K tile
    (1, 300, 129, True),      # tied-head shape class, K steps 3 at tile 128
    (64, 520, 200, False),    # K steps 5 > depth
]


def _pad_to(x, m):
    return np.pad(x, [(0, -n % m) for n in x.shape])


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("M,K,N,transposed", PIPE_CASES)
def test_pipelined_gemm_plain_matches_reference_kernel(M, K, N, transposed, dtype, depth):
    """The port's pipelined GeMM on CPU tensors equals the Pallas
    pipelined kernel in interpret mode (operands padded to its 128 tile):
    f32 within 1e-5, int8 -> int32 exactly."""
    rng = np.random.default_rng(depth)
    if dtype == "int8":
        a = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
        b = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    else:
        # B scaled by K^-0.5 (as weights are): outputs of order 1, so the
        # f32 reordering error stays near 1e-6 absolute.
        a = rng.normal(size=(M, K)).astype(np.float32)
        b = (rng.normal(size=(K, N)) * K ** -0.5).astype(np.float32)
    kern = make_pipelined_gemm(TpuGemmSpec(128, 128, 128, depth), interpret=True)
    want = np.asarray(kern(jnp.asarray(_pad_to(a, 128)), jnp.asarray(_pad_to(b, 128))))[:M, :N]
    tb = torch.from_numpy(np.ascontiguousarray(b.T)).t() if transposed else torch.from_numpy(b)
    got = tgp.gemm(torch.from_numpy(a), tb, depth=depth)
    assert got.dtype == (torch.int32 if dtype == "int8" else torch.float32)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(tops.gemm(torch.from_numpy(a), tb, backend="pipelined"), got)


@pytest.mark.parametrize("bad", ["auto", "xla", "interpret", "pallas", "nope"])
def test_backend_switch(bad):
    """"tiled" (K1) and "pipelined" (K6) are the two float GeMM kernels; the
    reference's device-choosing backends have no counterpart and raise."""
    assert tregistry.registered_kernels() == ("dequant", "pipelined", "tiled", "w8a8")
    assert tops.get_default_backend() == "tiled"
    with pytest.raises(ValueError, match="backend"):
        tops.set_default_backend(bad)
    a, b = _operands(6, 16, 8, False)
    x, w = torch.from_numpy(a), torch.from_numpy(b)
    with pytest.raises(ValueError, match="backend"):
        tops.linear(x, w, backend=bad)
    tops.set_default_backend("pipelined")
    try:
        assert tops.get_default_backend() == "pipelined"
        got = tops.linear(x, w)
    finally:
        tops.set_default_backend("tiled")
    assert torch.equal(got, tops.linear(x, w, backend="tiled"))
    with pytest.raises(ValueError, match="depth"):
        tgp.gemm(x, w, depth=5)
