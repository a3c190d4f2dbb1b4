"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports no JAX, so it runs on the GPU machine:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Every test here is marked `gpu` and skips without a CUDA device."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import gemm_int8 as tgemm8
from repro_torch.kernels import gemm_pipelined as tgp
from repro_torch.kernels import quant as tquant
from repro_torch.serving import kv_cache as tkvc

GEMM_CASES = [  # (M, K, N, transposed B view)
    (8, 64, 96, False),
    (13, 70, 45, False),      # ragged everywhere
    (1, 33, 129, True),       # the tied-head shape class: B = table.T
    (64, 40, 17, True),
    (8, 6912, 300, False),    # split-K with a ragged tail
]

INT8_CASES = GEMM_CASES + [   # K % 16 == 0 with a K-contiguous B: 16-byte loads
    (8, 1152, 1024, True),
    (13, 1152, 300, True),    # ragged M and N
    (64, 6912, 1152, True),   # split-K, 64-row tile
    (8, 1040, 200, True),     # K not a multiple of the 64-byte K tile
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_matches_plain(cuda_device, dtype):
    """f32 out for both operand dtypes: bf16 products are exact in f32, so
    kernel and plain version differ only in the order of f32 sums."""
    rng = np.random.default_rng(0)
    tgemm.reset_launches()
    for M, K, N, transposed in GEMM_CASES:
        a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(N, K) if transposed else (K, N))
                             .astype(np.float32))
        a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
        b = b.t() if transposed else b
        got = tgemm.gemm(a, b)
        torch.testing.assert_close(got, tgemm.gemm_plain(a, b), rtol=1e-5, atol=1e-4)
    assert tgemm.launches == len(GEMM_CASES)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["dequant_f32", "dequant_bf16", "int"])
def test_int8_gemm_kernel_matches_plain_bitwise(cuda_device, mode):
    """K3 (dequant epilogue, f32 or bf16 out) and K1's int mode on the s8
    tensor-core body equal their plain versions bit for bit: the int32 sums
    are exact and the epilogue's order is fixed.  Covers ragged shapes, a
    transposed-view B read in place, a (K, N) B re-laid K-major, K not a
    multiple of the 32-deep mma step, and split-K with a ragged tail."""
    rng = np.random.default_rng(0)
    tgemm8.reset_launches()
    for M, K, N, transposed in INT8_CASES:
        a = torch.from_numpy(rng.integers(-127, 128, size=(M, K), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, size=(N, K) if transposed
                                          else (K, N), dtype=np.int8))
        a, b = a.to(cuda_device), b.to(cuda_device)
        b = b.t() if transposed else b
        if mode == "int":
            got, want = tgemm8.gemm_int(a, b), tgemm8.gemm_int_plain(a, b)
        else:
            out = torch.float32 if mode == "dequant_f32" else torch.bfloat16
            sa = torch.from_numpy(rng.uniform(1e-3, 1e-1, size=(M, 1))
                                  .astype(np.float32)).to(cuda_device)
            sb = torch.from_numpy(rng.uniform(1e-3, 1e-1, size=(1, N))
                                  .astype(np.float32)).to(cuda_device)
            got = tgemm8.dequant_gemm(a, b, sa, sb, out_dtype=out)
            want = tgemm8.dequant_gemm_plain(a, b, sa, sb, out)
        assert got.dtype == want.dtype and torch.equal(got, want), (M, K, N, transposed)
    n = len(INT8_CASES)
    assert (tgemm8.int_launches, tgemm8.launches) == ((n, 0) if mode == "int" else (0, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_kernel_matches_plain_bitwise(cuda_device, dtype):
    """K4's codes and scales equal `quantize_ref(x, -1)` bit for bit, for
    ragged M, a zero row (the 1e-8 floor) and exact .5 ties (half to even)."""
    rng = np.random.default_rng(2)
    tquant.reset_launches()
    for M, K in [(1, 1152), (7, 70), (300, 6912)]:
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
        x[0, :4] = torch.tensor([127.0, 0.5, 1.5, -2.5])  # ties at scale 1
        if M > 1:
            x[1] = 0.0
        x = x.to(cuda_device, dtype)
        q, s = tquant.quantize_rows(x)
        qp, sp = tquant.quantize_rows_plain(x)
        assert q.dtype == torch.int8 and s.shape == (M, 1)
        assert torch.equal(q, qp) and torch.equal(s, sp), (M, K)
    assert tquant.launches == 3


def _lived_in_pool(cuda_device, kv_precision, rng):
    B, bs, max_blocks, hkv, d = 3, 4, 6, 2, 64
    lengths = [5, 12, max_blocks * bs]
    nb = 1 + B * max_blocks
    cache = tkvc.init_paged_kv(nb, bs, hkv, d, torch.float32, cuda_device,
                               kv_precision=kv_precision)
    alloc, tables = tkvc.BlockAllocator(nb, bs), tkvc.BlockTables(B, max_blocks)
    for s, n in enumerate(lengths):
        tables.ensure(s, n, alloc)
    bt = tables.array(cuda_device)
    kv = torch.from_numpy(rng.normal(size=(2, B, max(lengths), hkv, d))
                          .astype(np.float32)).to(cuda_device)
    tkvc.write_kv(cache, bt, kv[0], kv[1], 0)
    return cache, bt, lengths


@pytest.mark.gpu
@pytest.mark.parametrize("kv_precision", ["float", "int8"])
@pytest.mark.parametrize("sq,window,splits", [
    (1, None, 1), (1, None, 4), (3, None, 2), (1, 6, 1), (3, 6, 4)])
def test_flash_decode_kernel_matches_plain(cuda_device, sq, window, splits,
                                           kv_precision):
    """Ragged lengths (one at the table's capacity), GQA packing, windows,
    Sq > 1 and split-K against the plain walk and the gather oracle, for a
    float pool and an int8 pool with its scales."""
    rng = np.random.default_rng(1)
    cache, bt, lengths = _lived_in_pool(cuda_device, kv_precision, rng)
    B, hkv, d, groups = len(lengths), cache.k.shape[2], cache.k.shape[3], 2
    q = torch.from_numpy(rng.normal(size=(B, sq, hkv * groups, d))
                         .astype(np.float32)).to(cuda_device)
    idx = torch.tensor([n - sq for n in lengths], dtype=torch.int32,
                       device=cuda_device)
    tfd.reset_launches()
    got = tfd.flash_decode_attention(q, cache, bt, idx, window=window,
                                     spec=tfd.FlashDecodeSpec(num_splits=splits))
    assert (tfd.launches, tfd.launches_int8) == \
        ((0, 1) if kv_precision == "int8" else (1, 0))
    for want in (tfd.ref_paged_decode(q, cache, bt, idx, window=window),
                 tfd.gather_decode(q, cache, bt, idx, window=window)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _ragged_pool(cuda_device, kv_precision, rng, d, lengths, bs=4, max_blocks=16, hkv=1):
    B = len(lengths)
    nb = 1 + B * max_blocks
    cache = tkvc.init_paged_kv(nb, bs, hkv, d, torch.float32, cuda_device,
                               kv_precision=kv_precision)
    alloc, tables = tkvc.BlockAllocator(nb, bs), tkvc.BlockTables(B, max_blocks)
    for s, n in enumerate(lengths):
        tables.ensure(s, n, alloc)
    bt = tables.array(cuda_device)
    kv = torch.from_numpy(rng.normal(size=(2, B, max(lengths), hkv, d))
                          .astype(np.float32)).to(cuda_device)
    tkvc.write_kv(cache, bt, kv[0], kv[1], 0)
    return cache, bt


@pytest.mark.gpu
@pytest.mark.parametrize("kv_precision", ["float", "int8"])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("sq,window", [(1, None), (1, 6), (3, None), (3, 9)])
def test_flash_decode_split_rule_matches_plain(cuda_device, kv_precision, d, sq, window):
    """K2 with no spec (the split count of `decode_splits`: 8 splits of 2
    columns here, so the 1- and 5-token slots leave most splits dead) and
    with one split per column, against the plain walk and the plain split
    version at the same count, over ragged lengths: a 1-token slot, one at
    the table's capacity."""
    rng = np.random.default_rng(7)
    lengths = [1, 5, 40, 64]
    cache, bt = _ragged_pool(cuda_device, kv_precision, rng, d, lengths)
    B, groups = len(lengths), 4
    q = torch.from_numpy(rng.normal(size=(B, sq, groups, d)).astype(np.float32)) \
        .to(cuda_device)
    idx = torch.tensor([max(n - sq, 0) for n in lengths], dtype=torch.int32,
                       device=cuda_device)
    walk = tfd.ref_paged_decode(q, cache, bt, idx, window=window)
    for spec in (None, tfd.FlashDecodeSpec(num_splits=bt.shape[1])):
        splits = tfd.launch_splits(q, bt, 1, spec)
        assert splits == (bt.shape[1] // 2 if spec is None else bt.shape[1])
        tfd.reset_launches()
        got = tfd.flash_decode_attention(q, cache, bt, idx, window=window, spec=spec)
        assert (tfd.launches, tfd.launches_int8) == \
            ((0, 1) if kv_precision == "int8" else (1, 0))
        for want in (walk, tfd.split_decode_plain(q, cache, bt, idx, splits, window=window)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


FLASH_CASES = [  # (B, S, Hq, Hkv, D, causal, window)
    (1, 128, 2, 2, 64, True, None),      # MHA
    (2, 256, 4, 2, 64, True, None),      # GQA
    (1, 192, 4, 1, 128, True, None),     # MQA, S not a multiple of the 32-row tile
    (1, 128, 2, 2, 64, False, None),     # non-causal
    (1, 100, 2, 1, 64, True, 64),        # window, ragged S
    (2, 300, 4, 1, 256, True, None),     # gemma3-1b heads, ragged S
    (2, 300, 4, 1, 256, True, 64),       # gemma3-1b local layer (window < S)
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype):
    """K5 against its plain version: f32 within 1e-5, bf16 within one bf16
    ulp of the rounded output (p rounds to bf16 in both, in other tiles)."""
    rng = np.random.default_rng(3)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2 ** -8)
    tfa.reset_launches()
    for B, S, Hq, Hkv, D, causal, window in FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32))
                   .to(cuda_device, dtype) for h in (Hq, Hkv, Hkv))
        got = tfa.flash_attention(q, k, v, causal=causal, window=window)
        want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), **tol)
    assert tfa.launches == len(FLASH_CASES)


MMA_CASES = [  # (B, S, Hq, Hkv, D, causal, window): S not a multiple of 64
    (1, 100, 2, 1, 64, True, None),
    (2, 200, 4, 2, 128, True, 64),
    (1, 33, 4, 1, 256, True, 16),
    (2, 130, 4, 1, 256, True, None),
    (1, 70, 2, 2, 128, False, None),
    (1, 1000, 4, 1, 256, True, 512),
]


@pytest.mark.gpu
def test_flash_attention_bf16_tensor_core_path(cuda_device):
    """K5's bf16 body (mma.sync) at head dims 64, 128 and 256 with ragged
    sequence lengths, against its plain version within one bf16 ulp."""
    rng = np.random.default_rng(11)
    tfa.reset_launches()
    for B, S, Hq, Hkv, D, causal, window in MMA_CASES:
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32))
                   .to(cuda_device, torch.bfloat16) for h in (Hq, Hkv, Hkv))
        got = tfa.flash_attention(q, k, v, causal=causal, window=window)
        want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        assert got.dtype == torch.bfloat16 and bool(got.isfinite().all())
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7, atol=2 ** -8)
    assert tfa.launches == len(MMA_CASES)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_pipelined_gemm_kernel_matches_plain(cuda_device, dtype, depth):
    """K6 at every ring depth against its plain version on the GEMM_CASES
    and INT8_CASES shapes (ragged edges zero-filled by the copies, split-K,
    the transposed-B view): int8 -> int32 bit for bit; f32 out within 1e-5
    (B scaled by K^-0.5, as weights are); bf16 out within one bf16 ulp."""
    rng = np.random.default_rng(depth)
    tgp.reset_launches()
    for M, K, N, transposed in INT8_CASES:
        shape_b = (N, K) if transposed else (K, N)
        if dtype == torch.int8:
            a = torch.from_numpy(rng.integers(-127, 128, size=(M, K), dtype=np.int8))
            b = torch.from_numpy(rng.integers(-127, 128, size=shape_b, dtype=np.int8))
        else:
            a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
            b = torch.from_numpy((rng.normal(size=shape_b) * K ** -0.5).astype(np.float32))
        a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
        b = b.t() if transposed else b
        got = tgp.gemm(a, b, depth=depth)
        want = tgp.gemm_plain(a, b)
        if dtype == torch.int8:
            assert got.dtype == torch.int32 and torch.equal(got, want), (M, K, N, transposed)
            continue
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        if dtype == torch.bfloat16:
            got16 = tgp.gemm(a, b, depth=depth, out_dtype=torch.bfloat16)
            torch.testing.assert_close(got16.float(), want.to(torch.bfloat16).float(),
                                       rtol=2 ** -7, atol=1e-5)
    n = len(INT8_CASES) * (2 if dtype == torch.bfloat16 else 1)
    assert tgp.launches == n


# gemma3-1b's GeMMs (K, N, B K-major) and ragged variants: N and K off the
# 128-column tile and the 64-deep bf16 stage (multiples of 8, so the rows
# stay 16-byte aligned and nothing is re-laid).
MODEL_SHAPES = [
    (1152, 1024, False), (1152, 256, False), (1024, 1152, False),
    (1152, 6912, False), (6912, 1152, False), (1152, 262144, True),
    (1160, 1000, False), (1000, 1160, True), (6904, 200, False), (72, 136, True),
]
FLOAT_KERNELS = {
    "tiled": lambda a, b, out: tgemm.gemm(a, b, out_dtype=out),
    **{f"pipelined-{d}": (lambda a, b, out, d=d: tgp.gemm(a, b, depth=d, out_dtype=out))
       for d in (2, 3, 4)},
}


def _float_operands(rng, M, K, N, kmajor, device, dtype=torch.bfloat16):
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(N, K) if kmajor else (K, N))
                          * K ** -0.5).astype(np.float32))
    a, b = a.to(device, dtype), b.to(device, dtype)
    return a, (b.t() if kmajor else b)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("kernel", sorted(FLOAT_KERNELS))
def test_float_gemm_at_model_shapes(cuda_device, kernel, M):
    """K1 and K6 (each depth) on the tensor cores at gemma3-1b's shapes,
    both B layouts (the head K-major only, as the model holds it), ragged
    N and K: f32 out within 1e-5 of the plain version (B scaled by K^-0.5,
    as weights are), bf16 out within one bf16 ulp."""
    rng = np.random.default_rng(M)
    fn = FLOAT_KERNELS[kernel]
    for K, N, head_kmajor in MODEL_SHAPES:
        for kmajor in ((True,) if head_kmajor and N > 100000 else (False, True)):
            a, b = _float_operands(rng, M, K, N, kmajor, cuda_device)
            want = tgemm.gemm_plain(a, b)
            got = fn(a, b, torch.float32)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{(M, K, N, kmajor)}: {m}")
            got16 = fn(a, b, torch.bfloat16)
            torch.testing.assert_close(got16.float(), want.to(torch.bfloat16).float(),
                                       rtol=2 ** -7, atol=1e-5)
            del a, b, want, got, got16


def _w8a8_operands(rng, M, K, N, device, dtype=torch.bfloat16, static=False):
    """x (M, K) with one zero row (the 1e-8 floor), the weight as the
    model holds it (the .t() view of an (N, K) int8 store), its column
    scales (1, N), and a static scale (a 0-d float32 tensor) or None."""
    x = torch.from_numpy((rng.normal(size=(M, K)) * 3).astype(np.float32))
    if M > 1:
        x[M // 2] = 0.0
    w = torch.from_numpy(rng.integers(-127, 128, size=(N, K), dtype=np.int8))
    sb = torch.from_numpy(rng.uniform(1e-3, 1e-1, size=(1, N)).astype(np.float32))
    act = torch.tensor(float(x.abs().max()) / 127.0 * 0.8) if static else None
    x, w, sb = x.to(device, dtype), w.to(device).t(), sb.to(device)
    return x, w, sb, (None if act is None else act.to(device))


INT8_GRAPH_KERNELS = ("pipelined-int8", "dequant", "w8a8-dynamic", "w8a8-static")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["tiled", "pipelined-3", *INT8_GRAPH_KERNELS])
def test_gemm_bitwise_repeatable_and_graph_replay(cuda_device, kernel):
    """One launch per call with the split-K fix-up inside: two calls, a
    CUDA-graph capture replayed twice and a call after the replays give
    bitwise-equal results (the fix-up sums in split order and re-arms its
    counters), at a split shape of each tile (M = 8: 27 splits; M = 64);
    the int8 kernels (K6's int mode, K3, the w8a8 GeMM with per-row and
    static scales) also bit for bit equal to their plain versions."""
    rng = np.random.default_rng(5)
    for M, K, N in [(8, 6912, 1152), (64, 1152, 1000), (1, 1152, 256)]:
        if kernel.startswith("w8a8"):
            x, w, sb, act = _w8a8_operands(rng, M, K, N, cuda_device,
                                           static=kernel == "w8a8-static")
            fn = lambda: tgemm8.gemm_w8a8(x, w, sb, act, out_dtype=torch.bfloat16)  # noqa: E731
            want = tgemm8.gemm_w8a8_plain(x, w, sb, act, torch.bfloat16)
        elif kernel in ("pipelined-int8", "dequant"):
            a = torch.from_numpy(rng.integers(-127, 128, size=(M, K), dtype=np.int8))
            b = torch.from_numpy(rng.integers(-127, 128, size=(N, K), dtype=np.int8))
            a, b = a.to(cuda_device), b.to(cuda_device).t()
            sa = torch.rand((M, 1), device=cuda_device) * 0.1
            sb = torch.rand((1, N), device=cuda_device) * 0.1
            if kernel == "dequant":
                fn = lambda: tgemm8.dequant_gemm(a, b, sa, sb)   # noqa: E731
                want = tgemm8.dequant_gemm_plain(a, b, sa, sb)
            else:
                fn = lambda: tgp.gemm(a, b)                      # noqa: E731
                want = tgp.gemm_plain(a, b)
        else:
            a, b = _float_operands(rng, M, K, N, False, cuda_device)
            fn = (lambda: tgemm.gemm(a, b)) if kernel == "tiled" else \
                (lambda: tgp.gemm(a, b, depth=3))
        first, second = fn(), fn()
        assert torch.equal(first, second), (M, K, N)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fn()
        for _ in range(2):
            captured.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, first), (M, K, N)
        assert torch.equal(fn(), first), (M, K, N)
        if kernel in INT8_GRAPH_KERNELS:
            assert torch.equal(first, want), (M, K, N)
        else:
            torch.testing.assert_close(first, tgemm.gemm_plain(a, b), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["tiled", "pipelined-3"])
def test_gemm_relays_unaligned_operands(cuda_device, kernel):
    """Operands whose rows are not 16-byte aligned (an A one element off
    its allocation, a (K, N) B whose row stride is odd, a K-major B one
    element off) are re-laid by the wrappers and give the plain version's
    result."""
    rng = np.random.default_rng(9)
    fn = FLOAT_KERNELS[kernel]
    M, K, N = 8, 1152, 300
    base_a, base_b = _float_operands(rng, M, K + 1, N + 1, False, cuda_device)
    a = base_a[:, 1:]                                  # misaligned start
    b_rows = base_b[1:, :N]                            # row stride N + 1 elements
    store = torch.from_numpy(rng.normal(size=(N, K + 1)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16)
    b_kmajor = store[:, 1:].t()                        # K-major, one element off
    for b in (b_rows, b_kmajor):
        want = tgemm.gemm_plain(a, b)
        torch.testing.assert_close(fn(a, b, torch.float32), want, rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    a = torch.zeros((4, 8), device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        tgemm.gemm(a, a.t())
    q = torch.zeros((1, 1, 2, 48), device=cuda_device)
    cache = tkvc.init_paged_kv(2, 4, 1, 48, torch.float32, cuda_device)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        tfd.flash_decode_attention(q, cache, bt, 0)       # head_dim 48
    q = torch.zeros((1, 1, 2, 64), device=cuda_device)
    cache8 = tkvc.init_paged_kv(2, 4, 1, 64, torch.float32, cuda_device,
                                kv_precision="int8")
    with pytest.raises(ValueError, match="scales"):      # int8 pool, no scales
        tfd.flash_decode_attention(q, cache8._replace(k_scale=None, v_scale=None), bt, 0)
    with pytest.raises(ValueError, match="device"):      # scales on the CPU
        tfd.flash_decode_attention(q, cache8._replace(k_scale=cache8.k_scale.cpu()), bt, 0)
    a8 = torch.zeros((4, 8), device=cuda_device, dtype=torch.int8)
    with pytest.raises(ValueError, match="device"):      # scales on the CPU
        tgemm8.dequant_gemm(a8, a8.t(), torch.ones((4, 1)),
                            torch.ones((1, 4), device=cuda_device))
    with pytest.raises(TypeError):                       # f32 operands
        tgemm8.gemm_int(a8.float(), a8.t())
    with pytest.raises(TypeError):                       # f16 activations
        tquant.quantize_rows(a8.half())
    q = torch.zeros((1, 4, 2, 64), device=cuda_device)
    with pytest.raises(TypeError):                       # f16 q
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):                       # k, v in another dtype
        tfa.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):                      # head_dim 48
        tfa.flash_attention(q[..., :48], q[..., :48], q[..., :48])
    with pytest.raises(ValueError):                      # 2 q heads over 3 kv heads
        tfa.flash_attention(q, torch.zeros((1, 4, 3, 64), device=cuda_device),
                            torch.zeros((1, 4, 3, 64), device=cuda_device))
    with pytest.raises(TypeError):                       # f16 operands
        tgp.gemm(a, a.t())
    with pytest.raises(TypeError):                       # int8 x int8 -> bf16
        tgp.gemm(a8, a8.t(), out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="depth"):       # a ring deeper than 4
        tgp.gemm(a.float(), a.float().t(), depth=5)


# gemma3-1b's int8 GeMMs (K, N): the projections and the tied head.
W8A8_SHAPES = [(1152, 1024), (1152, 256), (1024, 1152), (1152, 6912), (6912, 1152),
               (1152, 262144)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_w8a8_fused_matches_plain_at_model_shapes(cuda_device, mode, M):
    """The w8a8 GeMM equals its plain composition bit for bit at gemma3-1b's
    shapes, as its plan runs it (one launch, the rows quantized in the int8
    GeMM's prologue, at M <= FUSED_ROWS; the row quantization then the
    dequant GeMM above) and as one launch at every M: bf16 and f32
    activations, bf16 and f32 out, a zero row, per-row and static scales."""
    rng = np.random.default_rng(M)
    tgemm8.reset_launches()
    tquant.reset_launches()
    n = 0
    for K, N in W8A8_SHAPES:
        for xdt in (torch.bfloat16, torch.float32):
            x, w, sb, act = _w8a8_operands(rng, M, K, N, cuda_device, xdt,
                                           static=mode == "static")
            for out in (torch.bfloat16, torch.float32):
                want = tgemm8.gemm_w8a8_plain(x, w, sb, act, out)
                got = tgemm8.gemm_w8a8(x, w, sb, act, out_dtype=out)
                assert got.dtype == out and torch.equal(got, want), (K, N, xdt, out)
                got = tgemm8._w8a8_fused(x, w, sb, act, out)
                assert got.dtype == out and torch.equal(got, want), (K, N, xdt, out)
                n += 1
            del x, w, got, want
    planned = n if M <= tgemm8.FUSED_ROWS else 0
    assert (tgemm8.w8a8_launches, tgemm8.launches, tquant.launches) == \
        (n + planned, n - planned, n - planned)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_static_scale_matches_plain_bitwise(cuda_device, dtype):
    """K4 with a static scale (every row takes it, codes round(x / s) by
    true division, clipped): codes and scales equal the plain version's."""
    rng = np.random.default_rng(4)
    tquant.reset_launches()
    for M, K in [(1, 1152), (7, 70), (64, 6912)]:
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda_device, dtype)
        act = torch.tensor(0.01, device=cuda_device)          # most codes clip
        q, s = tquant.quantize_rows(x, act)
        qp, sp = tquant.quantize_rows_plain(x, act)
        assert q.dtype == torch.int8 and s.shape == (M, 1)
        assert torch.equal(q, qp) and torch.equal(s, sp), (M, K)
        assert bool((s == 0.01).all()) and int(q.abs().max()) == 127
    assert tquant.launches == 3


@pytest.mark.gpu
def test_int8_gemm_relays_unaligned_operands(cuda_device):
    """Operands the kernel does not read in place are re-laid by the
    wrappers and give the plain versions' results bit for bit: activations
    one element off their allocation and with a K stride, a (K, N)
    row-major int8 weight, and a K-major weight one element off."""
    rng = np.random.default_rng(13)
    M, K, N = 8, 1152, 300
    xs = torch.from_numpy(rng.normal(size=(M, K + 1)).astype(np.float32)) \
        .to(cuda_device, torch.bfloat16)
    x_off = xs[:, 1:]                                    # rows 2 bytes off
    x_kstride = xs[:, :K].t().contiguous().t()           # K stride M
    store = torch.from_numpy(rng.integers(-127, 128, size=(N, K + 1), dtype=np.int8)) \
        .to(cuda_device)
    w_off = store[:, 1:].t()                             # K-major, 1 byte off
    w_rows = store[:, :K].t().contiguous()               # (K, N) row-major
    sb = torch.rand((1, N), device=cuda_device) * 0.1
    for x in (x_off, x_kstride):
        for w in (w_off, w_rows):
            for act in (None, torch.tensor(0.02, device=cuda_device)):
                got = tgemm8.gemm_w8a8(x, w, sb, act)
                assert torch.equal(got, tgemm8.gemm_w8a8_plain(x, w, sb, act))
    a = torch.from_numpy(rng.integers(-127, 128, size=(M, K + 1), dtype=np.int8)) \
        .to(cuda_device)[:, 1:]
    sa = torch.rand((M, 1), device=cuda_device) * 0.1
    for w in (w_off, w_rows):
        assert torch.equal(tgemm8.dequant_gemm(a, w, sa, sb),
                           tgemm8.dequant_gemm_plain(a, w, sa, sb))
        assert torch.equal(tgemm8.gemm_int(a, w), tgemm8.gemm_int_plain(a, w))


@pytest.mark.gpu
def test_w8a8_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros((4, 64), device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros((32, 64), device=cuda_device, dtype=torch.int8).t()
    sb = torch.ones((1, 32), device=cuda_device)
    act = torch.tensor(0.1, device=cuda_device)
    assert tgemm8.gemm_w8a8(x, w, sb, act).shape == (4, 32)
    with pytest.raises(TypeError):                       # f16 activations
        tgemm8.gemm_w8a8(x.half(), w, sb)
    with pytest.raises(TypeError):                       # int32 out
        tgemm8.gemm_w8a8(x, w, sb, out_dtype=torch.int32)
    with pytest.raises(TypeError):                       # float weight
        tgemm8.gemm_w8a8(x, w.float(), sb)
    with pytest.raises(ValueError, match="scales"):      # (N, 1) column scales
        tgemm8.gemm_w8a8(x, w, sb.t())
    with pytest.raises(TypeError):                       # f64 column scales
        tgemm8.gemm_w8a8(x, w, sb.double())
    with pytest.raises(ValueError):                      # column scales on the CPU
        tgemm8.gemm_w8a8(x, w, sb.cpu())
    with pytest.raises(TypeError, match="static scale"):  # a Python float
        tgemm8.gemm_w8a8(x, w, sb, 0.1)
    with pytest.raises(TypeError, match="static scale"):  # on the CPU
        tgemm8.gemm_w8a8(x, w, sb, act.cpu())
    with pytest.raises(TypeError, match="static scale"):  # float64
        tgemm8.gemm_w8a8(x, w, sb, act.double())
    with pytest.raises(TypeError, match="static scale"):  # two elements
        tgemm8.gemm_w8a8(x, w, sb, act.expand(2))


# -- the engine's CUDA graphs (gemma3-1b smoke config, float32) -------------------
# The smoke config's head_dim of 16 is below the decode kernel's smallest
# instantiation, so these runs take head_dim 64; the rest is the smoke config.

GRAPH_MODES = [("float", "float"), ("w8a8", "int8"), ("w8a8-calibrated", "int8")]


def _smoke_cfg():
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke("gemma3-1b"), head_dim=64)


def _smoke_engine(cuda_device, params=None, **kw):
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Engine

    cfg = _smoke_cfg()
    if params is None:
        params = TM.init_model(cfg, seed=0, device=cuda_device)
    kw = dict(dict(slots=3, max_seq=48, block_size=4, max_chunk=8), **kw)
    return cfg, params, Engine(cfg, params, device=cuda_device, **kw)


def _smoke_requests(vocab):
    from repro_torch.serving.request import RequestSpec

    rng = np.random.default_rng(11)
    lens, gens = [13, 5, 22, 9, 17], [6, 9, 4, 7, 5]   # 5 requests over 3 slots
    return [RequestSpec(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                        max_new=g) for n, g in zip(lens, gens)]


def _serve_smoke(cuda_device, params, warm=True, **kw):
    cfg, _, eng = _smoke_engine(cuda_device, params, **kw)
    if warm:
        eng.warmup()
    for spec in _smoke_requests(cfg.vocab):
        eng.submit(spec)
    return eng, eng.run()


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["tiled", "pipelined"])
@pytest.mark.parametrize("precision,kv_precision", GRAPH_MODES)
def test_graphed_engine_tokens_equal_eager(cuda_device, precision, kv_precision, backend):
    """The engine's replayed CUDA graphs give the eager engine's tokens on
    the same weights, with slot refills and resets, for every precision and
    both GeMM backends; every shape was captured at warmup (no cold
    compile), and the launches counted from replays are the eager run's."""
    from repro_torch.kernels import launches, ops

    cfg, params, _ = _smoke_engine(cuda_device)
    prev = ops.get_default_backend()
    ops.set_default_backend(backend)
    kw = dict(precision=precision, kv_precision=kv_precision)
    runs = {}
    try:
        for graphs in (False, True):
            eng = _smoke_engine(cuda_device, params, graphs=graphs, **kw)[2]
            eng.warmup()
            launches.reset()
            for spec in _smoke_requests(cfg.vocab):
                eng.submit(spec)
            runs[graphs] = (eng, eng.run(), launches.counts())
    finally:
        ops.set_default_backend(prev)
    (eager, want, eager_counts), (graphed, got, graphed_counts) = runs[False], runs[True]
    assert graphed_counts == dict.fromkeys(launches.COUNTERS, 0)   # no eager call
    assert graphed.graphs and not eager.graphs
    assert graphed.metrics.aot_steps == len(graphed.step_graphs) == 1 + 4 + 1
    assert graphed.metrics.cold_compiles == eager.metrics.cold_compiles == 0
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert graphed.replayed_launches() == eager_counts
    assert sum(eager_counts.values()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("precision,kv_precision", GRAPH_MODES[:2])
def test_replayed_decode_step_logits_bitwise(cuda_device, precision, kv_precision):
    """A decode step captured as a CUDA graph and replayed gives the eager
    step's logits and lengths bit for bit, on a state with live history in
    every slot (K2's per-call workspace comes from the graph's pool)."""
    from repro_torch import quant
    from repro_torch.models import model as TM

    cfg, params, eng = _smoke_engine(cuda_device, graphs=False, precision=precision,
                                     kv_precision=kv_precision)
    eng.warmup()
    for spec in _smoke_requests(cfg.vocab)[:3]:
        eng.submit(spec)
    eng.run(max_ticks=8)                        # mid-prefill and decoding slots
    state = eng.state
    saved = [t.clone() for t in (state.lengths, *[x for c in state.caches for x in c
                                                  if x is not None])]

    def restore():
        for t, s in zip((state.lengths, *[x for c in state.caches for x in c
                                          if x is not None]), saved):
            t.copy_(s)

    tokens = torch.arange(3, device=cuda_device, dtype=torch.int64)[:, None] + 7
    active = torch.tensor([True, False, True], device=cuda_device)
    with torch.no_grad(), quant.precision(precision):
        want, new = TM.paged_decode_step(eng.params, cfg, state, tokens, active)
        want, want_len = want.clone(), new.lengths.clone()
        restore()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got, new = TM.paged_decode_step(eng.params, cfg, state, tokens, active)
        for _ in range(2):
            restore()
            got.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want) and torch.equal(new.lengths, want_len)


@pytest.mark.gpu
def test_engine_captures_cold_shapes_at_first_use(cuda_device):
    """An engine that was never warmed runs each shape eagerly at its first
    use, counts it in cold_compiles, captures it for its next use, and gives
    the warmed engine's tokens."""
    _, params, _ = _smoke_engine(cuda_device)
    warm, want = _serve_smoke(cuda_device, params)
    cold, got = _serve_smoke(cuda_device, params, warm=False)
    assert cold.graphs and warm.metrics.cold_compiles == 0
    assert cold.metrics.cold_compiles == len(cold.step_graphs) > 1
    assert sum(cold._replays.values()) > 0
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])


@pytest.mark.gpu
def test_replay_under_another_backend_raises(cuda_device):
    """The GeMM backend binds at capture: a replay after
    `ops.set_default_backend` changed it raises instead of running the
    other kernel's graph."""
    from repro_torch.kernels import ops

    cfg, _, eng = _smoke_engine(cuda_device)
    eng.warmup()
    assert ops.get_default_backend() == "tiled"
    specs = _smoke_requests(cfg.vocab)
    eng.submit(specs[0])
    ops.set_default_backend("pipelined")
    try:
        with pytest.raises(RuntimeError, match="captured under the 'tiled' GeMM backend"):
            eng.run()
    finally:
        ops.set_default_backend("tiled")


# -- the dense family's shapes (qwen3-14b, bert-base) ---------------------------

DENSE_GEMM_SHAPES = [  # (K, N): qwen3-14b's q/o, k/v, gate/up, down, untied head
    (5120, 5120), (5120, 1024), (5120, 17408), (17408, 5120), (5120, 151936)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 8, 64])
def test_gemm_at_qwen3_shapes(cuda_device, M):
    """K1 on qwen3-14b's projections, the long-K down projection (split-K
    over 17408) and the N-contiguous 151936-wide head: bf16 out within one
    bf16 ulp of the plain version."""
    rng = np.random.default_rng(100 + M)
    for K, N in DENSE_GEMM_SHAPES:
        a, b = _float_operands(rng, M, K, N, False, cuda_device)
        want = tgemm.gemm_plain(a, b)
        got = tgemm.gemm(a, b, out_dtype=torch.bfloat16)
        torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                                   rtol=2 ** -7, atol=1e-3, msg=lambda m: f"{(M, K, N)}: {m}")
        del a, b, want, got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_takes_the_aligned_unaligned_vocab_head_in_place(cuda_device, dtype):
    """bert-base's 30522-wide untied head as `init_model` stores it (rows
    padded to 16 bytes): the GeMM reads it in place (no operand re-laid) and
    its logits equal the plain version's on the unpadded matrix."""
    rng = np.random.default_rng(5)
    a, b = _float_operands(rng, 8, 768, 30522, False, cuda_device, dtype)
    head = tgemm.aligned_rows(b)
    assert head.stride(0) != head.shape[1] and torch.equal(head, b)
    tgemm.reset_launches()
    got = tgemm.gemm(a, head)
    assert tgemm.relaid == 0 and tgemm.launches == 1
    torch.testing.assert_close(got, tgemm.gemm_plain(a, b), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_precision", ["float", "int8"])
@pytest.mark.parametrize("hq,hkv,d", [(40, 8, 128), (12, 12, 64)])
@pytest.mark.parametrize("sq", [1, 64])
def test_flash_decode_at_dense_head_layouts(cuda_device, kv_precision, hq, hkv, d, sq):
    """K2 at qwen3-14b's 5 q heads per kv head (the 16-row tile, 11 rows
    dead at Sq 1) and bert-base's MHA at D 64, at the rule's split count
    and one split per column, against the plain walk."""
    rng = np.random.default_rng(hq + sq)
    lengths = [64, 70, 23, 100, 64, 1, 90, 80]
    cache, bt = _ragged_pool(cuda_device, kv_precision, rng, d, lengths, bs=8,
                             max_blocks=13, hkv=hkv)
    q = torch.from_numpy(rng.normal(size=(len(lengths), sq, hq, d)).astype(np.float32)) \
        .to(cuda_device)
    idx = torch.tensor([max(n - sq, 0) for n in lengths], dtype=torch.int32,
                       device=cuda_device)
    walk = tfd.ref_paged_decode(q, cache, bt, idx)
    for spec in (None, tfd.FlashDecodeSpec(num_splits=bt.shape[1])):
        got = tfd.flash_decode_attention(q, cache, bt, idx, spec=spec)
        torch.testing.assert_close(got, walk, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(40, 8, 128), (12, 12, 64)])
def test_flash_attention_at_dense_head_layouts(cuda_device, dtype, hq, hkv, d):
    rng = np.random.default_rng(d)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2 ** -8)
    for B, S in ((1, 300), (2, 32)):
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, d)).astype(np.float32))
                   .to(cuda_device, dtype) for h in (hq, hkv, hkv))
        torch.testing.assert_close(tfa.flash_attention(q, k, v).float(),
                                   tfa.flash_attention_plain(q, k, v).float(), **tol)


@pytest.mark.gpu
def test_qwen3_published_width_engine_graphed_equals_eager(cuda_device):
    """qwen3-14b at its published widths, depth cut to 2 layers, bf16: the
    engine's replayed CUDA graphs give the eager engine's tokens on the
    same weights."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.request import RequestSpec

    cfg = dataclasses.replace(configs.get("qwen3-14b"), n_layers=2, group_size=1)
    params = TM.init_model(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(3)
    specs = [RequestSpec(prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                         max_new=g) for n, g in ((70, 6), (9, 8), (33, 5))]
    out = {}
    for graphs in (True, False):
        eng = Engine(cfg, params, slots=2, max_seq=96, block_size=16, max_chunk=32,
                     device=cuda_device, graphs=graphs)
        eng.warmup()
        for spec in specs:
            eng.submit(spec)
        out[graphs] = eng.run()
        assert eng.metrics.cold_compiles == 0
    assert sorted(out[True]) == list(range(len(specs)))
    for rid in out[False]:
        np.testing.assert_array_equal(out[True][rid], out[False][rid])


# -- speculative verify, sampling, preemption and the prefix cache ---------------

VERIFY_ROWS = (16, 24, 40)          # slots 8 x verify widths 2, 3, 5


@pytest.mark.gpu
@pytest.mark.parametrize("M", VERIFY_ROWS)
def test_gemms_at_verify_rows(cuda_device, M):
    """The verify steps' GeMMs: K1 (bf16 out within one bf16 ulp) and the
    w8a8 GeMM (bit for bit, as planned) at M = 16 (the last swapped and the
    last fused row count), 24 and 40 (the 64-row tile, part unused) on
    gemma3-1b's and qwen3-14b's projections and heads."""
    rng = np.random.default_rng(200 + M)
    for K, N in W8A8_SHAPES + DENSE_GEMM_SHAPES:
        a, b = _float_operands(rng, M, K, N, N > 100000 and K == 1152, cuda_device)
        got = tgemm.gemm(a, b, out_dtype=torch.bfloat16)
        torch.testing.assert_close(got.float(), tgemm.gemm_plain(a, b).to(torch.bfloat16)
                                   .float(), rtol=2 ** -7, atol=1e-3,
                                   msg=lambda m: f"{(M, K, N)}: {m}")
        x, w, sb, act = _w8a8_operands(rng, M, K, N, cuda_device)
        assert torch.equal(tgemm8.gemm_w8a8(x, w, sb, act, out_dtype=torch.bfloat16),
                           tgemm8.gemm_w8a8_plain(x, w, sb, act, torch.bfloat16)), (M, K, N)
        del a, b, got, x, w


@pytest.mark.gpu
@pytest.mark.parametrize("kv_precision", ["float", "int8"])
@pytest.mark.parametrize("hq,hkv,d,window", [(4, 1, 256, None), (4, 1, 256, 40),
                                             (40, 8, 128, None)])
@pytest.mark.parametrize("sq", [2, 3, 5])
def test_flash_decode_at_verify_shapes(cuda_device, kv_precision, hq, hkv, d, window, sq):
    """K2 with several slots at several positions each (B = 8, Sq = the
    verify width), the slots' lengths spread across block boundaries and
    past the window, at the rule's split count and one split per column,
    against the plain walk."""
    rng = np.random.default_rng(300 + sq + hq)
    lengths = [2, 9, 16, 17, 47, 64, 100, 7]
    cache, bt = _ragged_pool(cuda_device, kv_precision, rng, d, lengths, bs=8,
                             max_blocks=13, hkv=hkv)
    q = torch.from_numpy(rng.normal(size=(len(lengths), sq, hq, d)).astype(np.float32)) \
        .to(cuda_device)
    idx = torch.tensor([max(n - sq, 0) for n in lengths], dtype=torch.int32,
                       device=cuda_device)
    walk = tfd.ref_paged_decode(q, cache, bt, idx, window=window)
    for spec in (None, tfd.FlashDecodeSpec(num_splits=bt.shape[1])):
        got = tfd.flash_decode_attention(q, cache, bt, idx, window=window, spec=spec)
        torch.testing.assert_close(got, walk, rtol=1e-5, atol=1e-5)


def _spec_requests(vocab, sampled=()):
    """Repetitive prompts (the drafter's own-history and corpus matches)
    and random ones; the indices in `sampled` sample at T 0.8 / top-k 50 /
    top-p 0.95 with fixed seeds."""
    from repro_torch.serving.request import RequestSpec, SamplingParams

    rng = np.random.default_rng(12)
    pat = rng.integers(0, vocab, size=5).astype(np.int32)
    prompts = [np.tile(pat, 4), rng.integers(0, vocab, size=11).astype(np.int32),
               np.tile(pat, 4), np.tile(pat, 3), rng.integers(0, vocab, size=7)
               .astype(np.int32)]
    return [RequestSpec(prompt=p, max_new=g, sampling=SamplingParams(
        temperature=0.8, top_k=50, top_p=0.95, seed=100 + i) if i in sampled
        else SamplingParams()) for i, (p, g) in enumerate(zip(prompts, (12, 9, 12, 10, 8)))]


def _serve_specs(eng, specs, warm=True):
    if warm:
        eng.warmup()
    reqs = [eng.submit(s) for s in specs]
    out = eng.run()
    eng.alloc.check()
    assert eng.metrics.cold_compiles == 0
    return [out[r.rid] for r in reqs]


@pytest.mark.gpu
@pytest.mark.parametrize("precision,kv_precision", GRAPH_MODES[:2])
def test_graphed_speculative_engine_equals_eager_and_plain(cuda_device, precision,
                                                           kv_precision):
    """The verify shapes captured at warmup: the graphed speculative
    engine gives the eager speculative engine's and the plain engine's
    tokens, launches per replay as the eager run's, no cold compile."""
    from repro_torch.kernels import launches

    cfg, params, _ = _smoke_engine(cuda_device)
    kw = dict(precision=precision, kv_precision=kv_precision)
    specs = _spec_requests(cfg.vocab)
    runs = {}
    for graphs in (False, True):
        eng = _smoke_engine(cuda_device, params, graphs=graphs, speculative=4, **kw)[2]
        eng.warmup()
        params = eng.params
        launches.reset()
        runs[graphs] = (eng, _serve_specs(eng, specs, warm=False), launches.counts())
    plain = _serve_specs(_smoke_engine(cuda_device, params, **kw)[2], specs)
    (eager, want, counts), (graphed, got, _) = runs[False], runs[True]
    assert graphed.metrics.aot_steps == 1 + 4 + 3 + 1
    assert {"verify2", "verify3", "verify5"} <= set(graphed.step_graphs)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    assert graphed.metrics.spec_ticks == eager.metrics.spec_ticks > 0
    assert graphed.replayed_launches() == counts


@pytest.mark.gpu
def test_graphed_sampling_engine_equals_eager(cuda_device):
    """Sampled and greedy requests in the same batches, with and without
    speculation: graphed and eager engines give the same tokens, a second
    graphed run replays them, and the greedy rows equal a greedy-only
    run's."""
    cfg, params, _ = _smoke_engine(cuda_device)
    sampled = {1, 3}
    specs = _spec_requests(cfg.vocab, sampled)
    greedy_only = _serve_specs(_smoke_engine(cuda_device, params)[2],
                               [s for i, s in enumerate(specs) if i not in sampled])
    for speculative in (False, 4):
        runs = [_serve_specs(_smoke_engine(cuda_device, params, graphs=g, sampling=True,
                                           speculative=speculative)[2], specs)
                for g in (True, False, True)]
        for a, b, c in zip(*runs):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
        greedy = [t for i, t in enumerate(runs[0]) if i not in sampled]
        for g, w in zip(greedy, greedy_only):
            np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_graphed_preemption_and_prefix_cache_equal_eager(cuda_device):
    """A preempted victim restored into fresh blocks, and prompts seeded
    from the prefix cache: the graphed engine's tokens equal the eager
    engine's and an undisturbed run's."""
    from repro_torch.serving.request import RequestSpec

    cfg, params, _ = _smoke_engine(cuda_device)
    rng = np.random.default_rng(13)
    shared = rng.integers(0, cfg.vocab, size=16).astype(np.int32)
    batch = [RequestSpec(prompt=np.concatenate([shared, rng.integers(0, cfg.vocab, size=n)
                                                .astype(np.int32)]), max_new=10,
                         priority="batch") for n in (3, 5, 2)]
    inter = RequestSpec(prompt=rng.integers(0, cfg.vocab, size=6).astype(np.int32),
                        max_new=4)
    out = {}
    for graphs in (True, False):
        eng = _smoke_engine(cuda_device, params, graphs=graphs, preempt=True,
                            prefix_cache=True)[2]
        eng.warmup()
        reqs = [eng.submit(batch[0])]
        while reqs[0].phase.value != "decode":       # its prompt's blocks cached
            eng.tick()
        reqs += [eng.submit(s) for s in batch[1:]]
        for _ in range(10):
            eng.tick()
        reqs.append(eng.submit(inter))
        res = eng.run()
        eng.alloc.check()
        assert eng.metrics.preemptions >= 1 and eng.metrics.prefix_hits >= 1
        out[graphs] = [res[r.rid] for r in reqs]
    base = _serve_specs(_smoke_engine(cuda_device, params)[2], batch + [inter])
    for g, e, b in zip(out[True], out[False], base):
        np.testing.assert_array_equal(g, e)
        np.testing.assert_array_equal(g, b)


@pytest.mark.gpu
def test_verify_rows_bitwise_equal_decode_rows(cuda_device):
    """Row invariance, which makes speculative tokens identical to decode
    tokens on the card: K1's rows at M = 16, 24, 40 equal its rows at M = 8
    bit for bit (one split plan up to 64 rows), and K2's output for each
    position of a step of Sq <= 16 equals a one-position step's (the split
    count of one position)."""
    rng = np.random.default_rng(400)
    for K, N in W8A8_SHAPES + DENSE_GEMM_SHAPES[:4]:
        a, b = _float_operands(rng, 40, K, N, N > 100000, cuda_device)
        want = tgemm.gemm(a[:8], b, out_dtype=torch.bfloat16)
        for m in VERIFY_ROWS:
            assert torch.equal(tgemm.gemm(a[:m], b, out_dtype=torch.bfloat16)[:8], want), (K, N, m)
    lengths = [2, 9, 16, 17, 47, 64, 100, 7]
    for hq, hkv, d in ((4, 1, 256), (40, 8, 128)):
        cache, bt = _ragged_pool(cuda_device, "float", rng, d, lengths, bs=8, max_blocks=13,
                                 hkv=hkv)
        idx = torch.tensor(lengths, dtype=torch.int32, device=cuda_device)
        for sq in (2, 3, 5, 9):
            q = torch.from_numpy(rng.normal(size=(8, sq, hq, d)).astype(np.float32)) \
                .to(cuda_device, torch.bfloat16)
            cache16 = tkvc.PagedKVCache(cache.k.bfloat16(), cache.v.bfloat16())
            full = tfd.flash_decode_attention(q, cache16, bt, idx, window=40)
            for j in range(sq):
                one = tfd.flash_decode_attention(q[:, j:j + 1].contiguous(), cache16, bt,
                                                 idx + j, window=40)
                assert torch.equal(one[:, 0], full[:, j]), (hq, sq, j)


# -- the recurrent, hybrid and MoE families -------------------------------------

FAMILY_ARCHS = ("xlstm-1.3b", "jamba-1.5-large-398b", "dbrx-132b", "arctic-480b")


def _family_cfg(arch):
    """The arch's smoke config (float32), head_dim raised to 64, K2's
    smallest instantiation, where the stack has attention."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_smoke(arch)
    if "attn" in cfg.layer_kinds():
        cfg = dataclasses.replace(cfg, head_dim=64)
    return cfg


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _family_requests(vocab):
    from repro_torch.serving.request import RequestSpec

    rng = np.random.default_rng(21)
    pat = rng.integers(0, vocab, size=4).astype(np.int32)
    prompts = [np.tile(pat, 5), rng.integers(0, vocab, size=13).astype(np.int32),
               np.tile(pat, 5), rng.integers(0, vocab, size=30).astype(np.int32),
               rng.integers(0, vocab, size=6).astype(np.int32)]
    return [RequestSpec(prompt=p, max_new=g) for p, g in zip(prompts, (9, 7, 9, 5, 6))]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_steps_on_card_equal_cpu(cuda_device, arch):
    """A prefill chunk and three decode steps (one slot idle) on the card
    against the CPU's plain versions on the same weights: logits within
    1e-4 x max|logit| (float32 sums reordered), greedy tokens equal, and
    every recurrent state within 1e-4."""
    from repro_torch.models import model as TM

    cfg = _family_cfg(arch)
    params = TM.init_model(cfg, seed=0, device="cpu")
    states = {}
    for dev, p in (("cpu", params), ("cuda", _to_device(params, cuda_device))):
        st = TM.init_paged_decode_state(cfg, 2, num_blocks=9, block_size=16,
                                        max_blocks_per_slot=4, device=dev)
        st.block_tables.copy_(torch.arange(1, 9, dtype=torch.int32).reshape(2, 4))
        toks = torch.arange(20, dtype=torch.int64)[None] % cfg.vocab
        logits = []
        with torch.no_grad():
            out, st = TM.prefill_chunk(p, cfg, st, toks.to(dev), torch.tensor([1], device=dev))
            logits.append(out[0, -1].float().cpu())
            tok = int(logits[-1].argmax())
            for _ in range(3):
                out, new = TM.paged_decode_step(
                    p, cfg, st, torch.tensor([[0], [tok]], device=dev),
                    torch.tensor([False, True], device=dev))
                st.lengths = new.lengths
                logits.append(out[1, -1].float().cpu())
                tok = int(logits[-1].argmax())
        states[dev] = (logits, st)
    (want, st_c), (got, st_g) = states["cpu"], states["cuda"]
    for g_, w_ in zip(got, want):
        assert float((g_ - w_).abs().max()) <= 1e-4 * float(w_.abs().max())
        assert int(g_.argmax()) == int(w_.argmax())
    for c_g, c_c in zip(st_g.caches, st_c.caches):
        if not isinstance(c_g, tkvc.PagedKVCache):
            for a, b in zip(c_g, c_c):
                torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_graphed_engine_equals_eager(cuda_device, arch):
    """The replayed CUDA graphs serve the family stacks as the eager engine
    does on the same weights: tokens equal with slot refills (the reset
    replayed on recurrent states), every shape captured at warmup, the
    launches counted from replays the eager run's, and every state tensor
    (pools, recurrent states, tables, lengths) still at the address the
    graphs captured."""
    from repro_torch.kernels import launches
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Engine

    cfg = _family_cfg(arch)
    params = TM.init_model(cfg, seed=0, device=cuda_device)
    runs = {}
    for graphs in (False, True):
        eng = Engine(cfg, params, slots=2, max_seq=64, block_size=16, max_chunk=16,
                     device=cuda_device, graphs=graphs)
        eng.warmup()
        ptrs = [t.data_ptr() for c in eng.state.caches for t in c if t is not None]
        launches.reset()
        for spec in _family_requests(cfg.vocab):
            eng.submit(spec)
        runs[graphs] = (eng, eng.run(), launches.counts())
        assert [t.data_ptr() for c in eng.state.caches for t in c if t is not None] == ptrs
        assert eng.metrics.cold_compiles == 0
    (eager, want, counts), (graphed, got, graphed_counts) = runs[False], runs[True]
    assert graphed_counts == dict.fromkeys(launches.COUNTERS, 0)
    assert graphed._replays["reset"] > 0
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert graphed.replayed_launches() == counts
    assert counts["gemm"] > 0 and (counts["flash_decode"] > 0) == ("attn" in cfg.layer_kinds())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_family_graphed_speculative_equals_plain(cuda_device, arch):
    """Graphed verify steps commit each slot's recurrent state at its
    accepted position: speculative tokens equal the plain engine's."""
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Engine

    cfg = _family_cfg(arch)
    params = TM.init_model(cfg, seed=0, device=cuda_device)
    out = []
    for spec in (4, False):
        eng = Engine(cfg, params, slots=2, max_seq=64, block_size=16, max_chunk=16,
                     device=cuda_device, speculative=spec)
        out.append(_serve_specs(eng, _family_requests(cfg.vocab)))
        if spec:
            assert eng.metrics.spec_ticks > 0
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
def test_moe_combine_deterministic_on_card(cuda_device):
    """The MoE block in bf16 gives the same bits on every call and on every
    replay of a captured graph: a token's k weighted expert outputs are
    summed in choice order, never by atomics."""
    from repro_torch.models import model as TM
    from repro_torch.models import moe as TMoE

    import dataclasses

    cfg = dataclasses.replace(_family_cfg("dbrx-132b"), dtype="bfloat16")
    params = TM.init_model(cfg, seed=0, device=cuda_device)
    ffn = params["layers"][0]["ffn"]
    x = torch.randn((8, 5, cfg.d_model), device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        want = TMoE.moe_block(x, ffn, cfg)
        for _ in range(3):
            assert torch.equal(TMoE.moe_block(x, ffn, cfg), want)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = TMoE.moe_block(x, ffn, cfg)
        for _ in range(3):
            got.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(got, want)


# -- the encoder-decoder and VLM families: K5 at Sq != Skv, the graphed unpaged step --

CROSS_CASES = [  # (B, Sq, Skv, Hq, Hkv, D): non-causal, queries over other keys
    (2, 1, 300, 4, 4, 64),        # a decode step's cross-attention
    (2, 37, 300, 4, 4, 64),       # prefill's decoder tokens over the frames, ragged
    (1, 1, 1500, 16, 16, 64),     # whisper-medium's heads over 1500 frames
    (2, 70, 130, 8, 2, 128),      # GQA, both lengths ragged
    (1, 300, 100, 4, 1, 256),     # more queries than keys
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_shapes(cuda_device, dtype):
    """K5 at Sq != Skv, non-causal (whisper's cross-attention): the rows of
    a query tile past Sq are neither read nor stored, every key is seen;
    against its plain version, f32 within 1e-5, bf16 within one bf16 ulp."""
    rng = np.random.default_rng(13)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2 ** -8)
    tfa.reset_launches()
    for B, Sq, Skv, Hq, Hkv, D in CROSS_CASES:
        q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)) \
            .to(cuda_device, dtype)
        k, v = (torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))
                .to(cuda_device, dtype) for _ in range(2))
        got = tfa.flash_attention(q, k, v, causal=False)
        want = tfa.flash_attention_plain(q, k, v, causal=False)
        assert got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **tol)
    assert tfa.launches == len(CROSS_CASES)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b", "jamba-1.5-large-398b"])
def test_graphed_unpaged_decode_step_equals_eager(cuda_device, arch):
    """The unpaged decode step captured as a CUDA graph (the dense caches and
    recurrent states written in place, the index advanced on the device)
    gives the eager step's logits bit for bit, after `prefill`, in bf16 at
    head_dim 64; its replay launches K1 per projection and the head, and
    K5 per whisper cross-attention."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import steps
    from repro_torch.models import model as TM

    cfg = dataclasses.replace(configs.get_smoke(arch), head_dim=64, dtype="bfloat16")
    params = TM.init_model(cfg, seed=0, device=cuda_device)
    rng = np.random.default_rng(5)
    B, P = 3, 7
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, P)))
             .to(cuda_device)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).to(cuda_device)
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.normal(
            size=(B, cfg.prefix_len, TM.VISION_DIM)).astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        le, se = TM.prefill(params, cfg, batch, P + 8)
        lg, sg = TM.prefill(params, cfg, batch, P + 8)
        graphed = steps.GraphedServeStep(cfg, params, sg, B)
        assert int(sg.index) == P
        assert graphed.launches.get("gemm", 0) > cfg.n_layers
        assert graphed.launches.get("flash_attention", 0) == \
            (cfg.n_layers if cfg.family == "encdec" else 0)
        for _ in range(6):
            te, tg = le[:, -1].argmax(-1), lg[:, -1].argmax(-1)
            assert torch.equal(te, tg)
            le, se = TM.decode_step(params, cfg, se, te[:, None])
            lg, _ = graphed(params, sg, tg[:, None])
            assert torch.equal(lg, le)
    assert int(sg.index) == int(se.index) == P + 6


# -- the tile autotuner and the engine's observability ------------------------


@pytest.mark.gpu
def test_wallclock_tuner_times_real_launches(cuda_device):
    """Wall-clock tuning on the card: every candidate of gemma3-1b's q
    projection and of a K6 depth sweep launches (the launches counted apart),
    the winner is legal and no slower than the rule beyond the margin, and
    a K2 search over a float pool does the same."""
    from repro_torch import tuning
    from repro_torch.tuning.autotuner import MARGIN

    t = tuning.Autotuner(cache=tuning.TuneCache(persistent=False), mode="wallclock")
    for shape, backend in ((tuning.GemmShape(8, 1152, 1024), "tiled"),
                           (tuning.GemmShape(8, 1152, 6912), "w8a8"),
                           (tuning.GemmShape(8, 6912, 1152), "pipelined")):
        dtype = "int8" if backend == "w8a8" else "bfloat16"
        r = t.tune(shape, dtype, backend=backend)
        assert r.source == "wallclock" and not r.from_cache
        assert r.spec in tuning.enumerate_tiles(shape, dtype, backend=backend, sms=t.sms)
        assert r.score <= r.rule_score * (1 + MARGIN)
        assert len(r.timings) == r.candidates and all(s > 0 for _, s in r.timings)
    assert t.timing_launches["gemm"] > 0 and t.timing_launches["gemm_w8a8"] > 0
    assert t.timing_launches["gemm_pipelined"] > 0
    shape = tuning.DecodeShape(8, 1, 4, 256, 1, 16, 20, windows=((0, 1), (128, 2)))
    r = tuning.tune_decode(shape, "bfloat16", tuner=t)
    assert r.source == "wallclock" and r.score <= r.rule_score * (1 + MARGIN)
    assert t.timing_launches["flash_decode"] > 0


@pytest.mark.gpu
def test_tuned_plans_keep_rows_bitwise(cuda_device):
    """Under any candidate plan K1's rows at M = 8 equal its rows at M = 40
    bit for bit, the swapped and the 64-row tile give the same bits, K6's
    depths the same bits, and the w8a8 GeMM in one launch or two the same
    bits: the candidate axes never move a token."""
    from repro_torch import tuning

    rng = np.random.default_rng(500)
    for K, N in W8A8_SHAPES[:5]:
        a, b = _float_operands(rng, 40, K, N, False, cuda_device)
        w_q = torch.from_numpy(rng.integers(-127, 128, size=(N, K), dtype=np.int8)) \
            .to(cuda_device).t()
        sb = torch.from_numpy(rng.uniform(1e-3, 1e-1, size=(1, N)).astype(np.float32)) \
            .to(cuda_device)
        for spec in tuning.enumerate_tiles(tuning.GemmShape(8, K, N))[:6]:
            want = tgemm.gemm(a[:8], b, out_dtype=torch.bfloat16, spec=spec)
            assert torch.equal(tgemm.gemm(a, b, out_dtype=torch.bfloat16, spec=spec)[:8], want)
            other = tgemm.GemmLaunchSpec(splits=spec.splits, swap=not spec.swap)
            assert torch.equal(tgemm.gemm(a[:8], b, out_dtype=torch.bfloat16, spec=other),
                               want), (K, N, spec)
            outs = [tgp.gemm(a[:8], b, depth=d, out_dtype=torch.bfloat16, spec=spec)
                    for d in (2, 3, 4)]
            assert all(torch.equal(o, outs[0]) for o in outs), (K, N, spec)
        for spec in tuning.enumerate_tiles(tuning.GemmShape(8, K, N), "int8",
                                           backend="w8a8")[:6]:
            one = tgemm8.gemm_w8a8(a[:8], w_q, sb, out_dtype=torch.bfloat16, spec=spec)
            two = tgemm8.gemm_w8a8(a[:8], w_q, sb, out_dtype=torch.bfloat16,
                                   spec=tgemm.GemmLaunchSpec(splits=spec.splits,
                                                             fused=not spec.fused))
            assert torch.equal(one, two) and torch.equal(
                tgemm8.gemm_w8a8(a, w_q, sb, out_dtype=torch.bfloat16, spec=spec)[:8], one)


@pytest.mark.gpu
def test_tuned_engine_on_card(cuda_device, tmp_path, monkeypatch):
    """A wall-clock-tuned, traced engine (gemma3-1b smoke, head_dim 64):
    graphed tokens equal eager ones under the tuned plans; a second engine
    on the same cache file resolves every plan from it with no timing
    launch; tracing changes no token, replayed launch or allocator counter;
    and the tracer's cost stays under 2 % of the card's decode tick."""
    from repro_torch.obs import Tracer

    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
    kw = dict(autotune=True, tune_mode="wallclock")
    cfg, params, _ = _smoke_engine(cuda_device)
    runs = {}
    for name, extra in (("traced", dict(trace=True)), ("eager", dict(graphs=False)),
                        ("untraced", {})):
        eng, out = _serve_smoke(cuda_device, params, **kw, **extra)
        runs[name] = (eng, out)
    traced, eager, untraced = (runs[k][0] for k in ("traced", "eager", "untraced"))
    assert traced.tuner.timing_launches and not eager.tuner.timing_launches
    assert all(r.from_cache for _, r in eager.tune_results)
    assert eager.decode_tune_result.from_cache
    for rid, toks in runs["traced"][1].items():
        np.testing.assert_array_equal(toks, runs["eager"][1][rid])
        np.testing.assert_array_equal(toks, runs["untraced"][1][rid])
    assert traced.replayed_launches() == untraced.replayed_launches()
    assert traced.alloc.stats() == untraced.alloc.stats()
    tr = Tracer(capacity=1 << 14)
    code = tr.intern("bench")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter_ns()
        for _ in range(5000):
            tr.begin(code)
            tr.end(code)
        best = min(best, (time.perf_counter_ns() - t0) / 10000)
    m = traced.metrics
    tick = m.decode_time_s / max(1, m.decode_steps)
    assert 14 * best * 1e-9 / tick < 0.02


# -- the cluster: engines on their own streams and split-K scratch ------------------


def _smoke_pool(cuda_device, n, params, **kw):
    from repro_torch.cluster import ReplicaPool

    kw = dict(dict(slots=3, max_seq=48, block_size=4, max_chunk=8), **kw)
    return ReplicaPool(_smoke_cfg(), n, device=cuda_device, params=params, **kw)


@pytest.mark.gpu
def test_engines_own_their_streams_and_splitk_scratch(cuda_device):
    """Two warmed engines on one card: different streams (neither the
    current one) and different split-K workspaces and tile counters, each
    allocated in the engine's own first eager step (the smoke config's down
    projection splits K), with every counter back at 0."""
    cfg, params, a = _smoke_engine(cuda_device)
    b = _smoke_engine(cuda_device, params)[2]
    for e in (a, b):
        e.warmup()
    dev = torch.device("cuda", torch.cuda.current_device())
    (wa, ca), (wb, cb) = a.splitk.get(dev), b.splitk.get(dev)
    assert wa.data_ptr() != wb.data_ptr() and ca.data_ptr() != cb.data_ptr()
    assert a.stream != b.stream
    assert torch.cuda.current_stream(dev) not in (a.stream, b.stream)
    for e in (a, b):
        e.submit(_smoke_requests(cfg.vocab)[0])
        e.run()
        assert int(e.splitk.get(dev)[1].abs().sum()) == 0


@pytest.mark.gpu
def test_engine_step_waits_for_the_callers_stream(cuda_device):
    """The slots' lengths written on the caller's stream behind a long
    sleep, then one decode step on the engine's stream: the step reads the
    written lengths and advances them by one (a step that ran before the
    write landed would leave them as written)."""
    eng = _smoke_engine(cuda_device)[2]
    eng.warmup()
    lengths = [5, 9, 13]
    for slot, n in enumerate(lengths):
        eng.tables.ensure(slot, n + 1, eng.alloc)
    eng.tables.copy_to(eng.state.block_tables)
    base = torch.tensor(lengths, dtype=torch.int32, device=eng.device)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)            # ~0.1 s on the caller's stream
    eng.state.lengths.copy_(base)
    eng.step_decode(np.zeros(eng.slots, np.int64), np.ones(eng.slots, bool))
    torch.cuda.synchronize()
    assert eng.state.lengths.tolist() == [n + 1 for n in lengths]


def _pool_tokens(pool, specs, policy="least-loaded"):
    from repro_torch.cluster import Router

    pool.start()
    with Router(pool, policy=policy) as router:
        handles = [router.submit(s) for s in specs]
        router.drain(timeout=300)
        return [h.result(timeout=0) for h in handles]


@pytest.mark.gpu
def test_threaded_replicas_equal_a_bare_engine(cuda_device):
    """Two replicas on one card, each replaying its graphs on its own stream
    from its own thread, twice: every request's tokens equal a bare
    engine's, both replicas serve, no cold shape, clean allocators."""
    from repro_torch.cluster import mixed_traffic
    from repro_torch.serving.request import RequestSpec

    cfg, params, _ = _smoke_engine(cuda_device)
    trace = mixed_traffic(cfg.vocab, n=12, seed=0, max_prompt=30, max_new=(4, 12))
    specs = [RequestSpec(prompt=np.asarray(it.prompt, np.int32), max_new=it.max_new)
             for it in trace.items]
    want = _serve_specs(_smoke_engine(cuda_device, params)[2], specs)
    pool = _smoke_pool(cuda_device, 2, params)
    pool.warmup()
    for _ in range(2):
        got = _pool_tokens(pool, specs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for e in pool.engines:
        assert e.metrics.finished_requests > 0 and e.metrics.cold_compiles == 0
        assert sum(e._replays.values()) > 0
        e.alloc.check()


@pytest.mark.gpu
def test_started_pool_waits_for_the_callers_stream(cuda_device):
    """The slots' lengths zeroed on the caller's stream behind a sleep just
    before `start()`: the replica's thread (on the engine's stream) serves
    after the write, so the tokens are a bare engine's (a write landing
    mid-serve would cut the live slots' lengths)."""
    from repro_torch.cluster import mixed_traffic
    from repro_torch.serving.request import RequestSpec

    cfg, params, _ = _smoke_engine(cuda_device)
    trace = mixed_traffic(cfg.vocab, n=12, seed=1, max_prompt=30, max_new=(4, 12))
    specs = [RequestSpec(prompt=np.asarray(it.prompt, np.int32), max_new=it.max_new)
             for it in trace.items]
    want = _serve_specs(_smoke_engine(cuda_device, params)[2], specs)
    pool = _smoke_pool(cuda_device, 1, params)
    pool.warmup()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)             # ~30 ms on the caller's stream
    pool.engines[0].state.lengths.zero_()
    for g, w in zip(_pool_tokens(pool, specs), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_cold_shape_in_started_pool_runs_eagerly(cuda_device):
    """A sampled request on replicas warmed without sampling: the started
    pool runs `decode_sample` eagerly, counts it cold and captures nothing
    mid-serving; its tokens equal those of a bare engine that captured the
    shape at first use."""
    from repro_torch.serving.request import RequestSpec, SamplingParams

    cfg, params, _ = _smoke_engine(cuda_device)
    spec = RequestSpec(prompt=np.arange(1, 12, dtype=np.int32), max_new=8,
                       sampling=SamplingParams(temperature=0.8, top_k=50, seed=5))
    bare = _smoke_engine(cuda_device, params)[2]
    bare.warmup()
    bare.submit(spec)
    want = bare.run()[0]
    assert "decode_sample" in bare.step_graphs and bare.metrics.cold_compiles >= 1
    pool = _smoke_pool(cuda_device, 1, params)
    pool.warmup()
    got = _pool_tokens(pool, [spec])[0]
    eng = pool.engines[0]
    np.testing.assert_array_equal(got, want)
    assert eng.metrics.cold_compiles >= 1
    assert "decode_sample" not in eng.step_graphs and "decode_sample" in eng._warmed


# -- the training path: K5b, the lse output, K1's backward, a train step --------

BWD_CASES = [  # (B, S, Hq, Hkv, D, causal, window): ragged S, GQA / MQA, windows
    (1, 32, 4, 1, 64, True, None),
    (2, 100, 4, 2, 128, True, None),
    (1, 1000, 2, 1, 64, True, 200),
    (2, 300, 4, 1, 256, True, None),
    (2, 300, 4, 1, 256, True, 64),
    (1, 100, 4, 4, 256, False, None),
    (2, 37, 2, 1, 128, True, 16),
    # the bf16 body's edges: GQA 8 / 1 and 10 / 2 (one cluster of 8 and of
    # 5 blocks), 16 / 1 (8 blocks of 2 heads: past the cluster limit), a
    # window shorter than a tile, D 64 and 128 at S 1024
    (1, 300, 8, 1, 128, True, None),
    (2, 200, 10, 2, 128, True, None),
    (1, 130, 16, 1, 64, True, None),
    (2, 1000, 4, 1, 256, True, 16),
    (1, 1024, 4, 1, 64, True, None),
    (1, 1024, 4, 1, 128, True, 512),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_matches_plain(cuda_device, dtype):
    """K5b through the autograd Function against `flash_attention_bwd_plain`
    on the kernel's own out and lse: f32 within 1e-5 of each gradient's
    largest element (sums reordered), bf16 within 2^-7 of it (P and dS
    round to bf16 in both, the sums in other orders); two runs give the
    same bits (no atomics); the lse within 1e-5 of the plain forward's, and
    asking for it leaves the output's bits as they were."""
    rng = np.random.default_rng(5)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    tfa.reset_launches()
    for B, S, Hq, Hkv, D, causal, window in BWD_CASES:
        q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32))
                   .to(cuda_device, dtype).requires_grad_(True) for h in (Hq, Hkv, Hkv))
        do = torch.from_numpy(rng.normal(size=(B, S, Hq, D)).astype(np.float32)).to(
            cuda_device, dtype)
        out = tfa.flash_attention(q, k, v, causal=causal, window=window)
        got = torch.autograd.grad(out, (q, k, v), do)
        again = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=causal,
                                                        window=window), (q, k, v), do)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        qd, kd, vd = (t.detach() for t in (q, k, v))
        o, lse = tfa._forward(qd, kd, vd, causal, window, True)
        assert torch.equal(o, tfa._forward(qd, kd, vd, causal, window, False)[0])
        assert torch.equal(o, out.detach())
        _, plse = tfa.flash_attention_plain(qd, kd, vd, causal=causal, window=window,
                                            return_lse=True)
        torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)
        want = tfa.flash_attention_bwd_plain(qd, kd, vd, o, lse, do, causal=causal,
                                             window=window)
        for g, w in zip(got, want):
            assert g.dtype == dtype and bool(g.isfinite().all())
            scale = float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=rel * scale)
    n = len(BWD_CASES)
    assert tfa.bwd_launches == 2 * n and tfa.launches == 2 * n + 2 * n


FAMILY_BWD_CASES = [  # (B, Sq, Skv, Hq, Hkv, D, causal): queries over longer keys
    (2, 24, 40, 4, 4, 64, False),          # (non-causal), 1500 keys (not a multiple of
    (1, 37, 100, 4, 1, 64, False),         # the 64-key tile), clusters of 6 and 7 blocks
    (1, 448, 1500, 16, 16, 64, False),
    (1, 1500, 1500, 16, 16, 64, False),
    (1, 1024, 1024, 48, 8, 128, True),
    (1, 1024, 1024, 56, 8, 128, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FAMILY_BWD_CASES, ids=str)
def test_flash_attention_backward_at_family_shapes(cuda_device, dtype, case):
    """K5b at the families' training shapes (whisper's encoder and
    cross-attention, dbrx's 48 / 8 and arctic's 56 / 8 heads) and at small
    Sq != Skv cases, through the autograd Function, against
    `flash_attention_bwd_plain` with the bars of
    test_flash_attention_backward_kernel_matches_plain; two runs equal."""
    B, Sq, Skv, Hq, Hkv, D, causal = case
    rng = np.random.default_rng(Sq + Skv)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)).to(
        cuda_device, dtype).requires_grad_(True)
    k, v = (torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))
            .to(cuda_device, dtype).requires_grad_(True) for _ in range(2))
    do = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)).to(
        cuda_device, dtype)
    got = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=causal), (q, k, v), do)
    again = torch.autograd.grad(tfa.flash_attention(q, k, v, causal=causal), (q, k, v), do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = tfa._forward(qd, kd, vd, causal, None, True)
    want = tfa.flash_attention_bwd_plain(qd, kd, vd, o, lse, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(g.isfinite().all())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=rel * float(w.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_gradients_through_k1(cuda_device, dtype):
    """`ops.linear` under autograd: dX = dY W^T and dW = X^T dY, each one
    launch of K1 (three a call), against the plain products; the tied
    head's W = table.t() view gives the table's gradient through the view.
    f32 within 1e-5 relative, bf16 within one bf16 ulp of the rounded out."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(9)
    tol = dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    tgemm.reset_launches()
    cases = [(64, 96, 200, False), (300, 1152, 256, False), (40, 128, 1000, True)]
    for M, K, N, tied in cases:
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(cuda_device, dtype)
        shape = (N, K) if tied else (K, N)
        w0 = torch.from_numpy((rng.normal(size=shape) * K ** -0.5).astype(np.float32)).to(
            cuda_device, dtype)
        x.requires_grad_(True)
        w0.requires_grad_(True)
        w = w0.t() if tied else w0
        y = ops.linear(x, w)
        dy = torch.from_numpy(rng.normal(size=(M, N)).astype(np.float32)).to(cuda_device, dtype)
        dx, dw0 = torch.autograd.grad(y, (x, w0), dy)
        wd = w.detach()
        torch.testing.assert_close(dx.float(), tgemm.gemm_plain(dy, wd.t(), dtype).float(), **tol)
        want_w = tgemm.gemm_plain(x.detach().t(), dy, dtype)
        torch.testing.assert_close((dw0.t() if tied else dw0).float(), want_w.float(), **tol)
        assert dx.dtype == dw0.dtype == dtype
    assert tgemm.launches == 3 * len(cases)
    with torch.no_grad():                       # serving: one launch, no Function
        tgemm.reset_launches()
        y = ops.linear(x.detach(), w.detach())
        assert y.grad_fn is None and tgemm.launches == 1


def _train_cfg(dtype):
    """qwen3-14b's smoke config at head_dim 64 (K5's smallest) with a
    250-token vocab, whose untied head is stored row-padded."""
    from repro_torch import configs as tconfigs

    return dataclasses.replace(tconfigs.get_smoke("qwen3-14b"), head_dim=64, vocab=250,
                               dtype=dtype)


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu_and_keeps_weights_aligned(cuda_device):
    """f32 loss and every gradient leaf on the card (K1, K5, K5b) against the
    CPU (plain versions) on the same weights and batch: the loss within
    1e-5 relative, each leaf within 1e-4 of its largest element (sums
    reordered; chip_smoke phase 14b's bar).  Then two train steps on the
    card, each launching K1, K5 and K5b; afterwards the padded head is
    still padded (AdamW updated it in place) and a no_grad forward re-lays
    no weight."""
    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_init

    cfg = _train_cfg("float32")
    data = SyntheticLMData(cfg.vocab, 2, 80)
    params = TM.init_model(cfg, seed=0, device="cpu")
    card = tree_lib.map_tree(lambda t: t.to(cuda_device), params)
    card["head"] = tgemm.aligned_rows(card["head"])    # as init_model stores it
    grads = {}
    for dev, p in (("cpu", params), ("cuda", card)):
        leaves = tree_lib.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = TM.loss_fn(p, cfg, to_device(data.batch_at(0), dev))
        grads[dev] = (float(loss), [g.cpu() for g in torch.autograd.grad(loss, leaves)])
    (lc, gc), (lg, gg) = grads["cpu"], grads["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
    head = card["head"]
    opt = adamw_init(card, tsteps.optimizer_config(cfg))
    step = tsteps.make_train_step(cfg, base_lr=1e-3, total_steps=2)
    for i in range(2):
        tgemm.reset_launches()
        tfa.reset_launches()
        card, opt, m = step(card, opt, to_device(data.batch_at(i), cuda_device))
        assert np.isfinite(float(m["loss"]))
        assert tgemm.launches > 0 and tfa.launches > 0 and tfa.bwd_launches > 0
    assert card["head"] is head and tgemm.aligned_rows(head) is head
    assert head.stride(0) > head.shape[1]
    tgemm.reset_launches()
    with torch.no_grad():
        TM.forward(card, cfg, to_device(data.batch_at(5), cuda_device))
    assert tgemm.launches > 0 and tgemm.relaid == 0


@pytest.mark.gpu
@pytest.mark.parametrize("zero3", [False, True], ids=["dp", "zero3"])
def test_sharded_train_step_in_a_world_one_nccl_group(cuda_device, tmp_path, zero3):
    """`make_sharded_train_step` in a world-1 NCCL group (a `file://`
    store) against `make_train_step` on the same weights and batches, bf16,
    three steps: the losses bit for bit, the parameters equal, the same
    K1 / K5 / K5b launches a step; ZeRO-3 gathers and reduce-scatters
    every sharded leaf, dp all-reduces every leaf."""
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import MeshShape, backend_for
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import make_plan

    cfg = _train_cfg("bfloat16")
    data = SyntheticLMData(cfg.vocab, 2, 80)
    opt_cfg = tsteps.optimizer_config(cfg)
    runs = {}
    dist.init_process_group(backend_for(cuda_device), init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = MeshShape(("data", "model"), (1, 1))
        plan = make_plan(mesh, cfg.param_count(), force_fsdp=zero3)
        sharded = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=1e-3,
                                                 total_steps=3)
        for label, step in (("unsharded", tsteps.make_train_step(cfg, opt_cfg, base_lr=1e-3,
                                                                  total_steps=3)),
                            ("sharded", sharded)):
            params = TM.init_model(cfg, seed=0, device=cuda_device)
            if label == "sharded":
                params = sharded.layout.shard(params)
            opt = adamw_init(params, opt_cfg)
            out = []
            for i in range(3):
                tgemm.reset_launches()
                tfa.reset_launches()
                params, opt, m = step(params, opt, to_device(data.batch_at(i), cuda_device))
                out.append((float(m["loss"]), tgemm.launches, tfa.launches, tfa.bwd_launches,
                            m.get("collectives")))
            runs[label] = (out, tree_lib.leaves(params))
    finally:
        dist.destroy_process_group()
    (want, wp), (got, gp) = runs["unsharded"], runs["sharded"]
    assert [x[:4] for x in got] == [x[:4] for x in want]
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(gp, wp))
    n, k = len(wp), sharded.layout.sharded
    assert (k > 0) == zero3
    assert got[-1][4] == {"all_reduce": n - k + 3,
                          **({"all_gather": k, "reduce_scatter": k} if zero3 else {})}


@pytest.mark.gpu
def test_tp_train_step_in_a_world_one_nccl_group(cuda_device, tmp_path):
    """`make_sharded_train_step` under a tp plan forced over (data 1,
    model 1) in a world-1 NCCL group against `make_train_step` on the same
    2-layer smoke-width qwen3 weights and batches, bf16, three steps: the
    operators of `parallel/tensor.py` run with their collectives; each
    step's loss within 1e-5 relative, the same K1 / K5 / K5b launches, and
    the collectives a step those of the same step traced on the meta
    device."""
    import torch.distributed as dist

    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch import step_cost
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import MeshShape, backend_for
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import make_plan

    cfg = _train_cfg("bfloat16")
    data = SyntheticLMData(cfg.vocab, 2, 80)
    opt_cfg = tsteps.optimizer_config(cfg)
    mesh = MeshShape(("data", "model"), (1, 1))
    plan = make_plan(mesh, 10**12, force_mode="tp", force_fsdp=False)
    assert plan.model_axis == "model" and not plan.attn_seq
    runs = {}
    dist.init_process_group(backend_for(cuda_device), init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        sharded = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=1e-3,
                                                 total_steps=3)
        for label, step in (("unsharded", tsteps.make_train_step(cfg, opt_cfg, base_lr=1e-3,
                                                                  total_steps=3)),
                            ("tp", sharded)):
            params = TM.init_model(cfg, seed=0, device=cuda_device)
            if label == "tp":
                params = sharded.layout.shard(params)
            opt = adamw_init(params, opt_cfg)
            out = []
            for i in range(3):
                tgemm.reset_launches()
                tfa.reset_launches()
                params, opt, m = step(params, opt, to_device(data.batch_at(i), cuda_device))
                out.append((float(m["loss"]), tgemm.launches, tfa.launches, tfa.bwd_launches,
                            m.get("collectives")))
            runs[label] = out
    finally:
        dist.destroy_process_group()
    want, got = runs["unsharded"], runs["tp"]
    for g, w in zip(got, want):
        assert abs(g[0] - w[0]) <= 1e-5 * abs(w[0]), (g[0], w[0])
        assert g[1:4] == w[1:4] and g[1] > 0 and g[2] > 0 and g[3] > 0
    meta = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, rank=0)
    pieces = meta.layout.shard(tsteps.params_struct(cfg))
    batch = {k: torch.zeros((2, 80), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    step_cost.analyze(meta, pieces, adamw_init(pieces, opt_cfg), batch)
    assert got[-1][4] == dict(meta.layout.collectives)
    assert sharded.layout.model_sharded == 2 + cfg.n_layers * 7


@pytest.mark.gpu
def test_sp_train_step_in_a_world_one_nccl_group(cuda_device, tmp_path):
    """`make_sharded_train_step` under the sequence-parallel (attn_seq) plan
    forced over (data 1, model 1) in a world-1 NCCL group against
    `make_train_step` on the same weights and batches, bf16, three steps:
    the sequence operators gather and reduce-scatter over the one rank and
    attention runs at q offset 0, so the losses and parameters are bit for
    bit, the launches equal, and the collectives a step those of the same
    step traced on the meta device."""
    import torch.distributed as dist

    from repro_torch import tree as tree_lib
    from repro_torch.data import SyntheticLMData, to_device
    from repro_torch.launch import step_cost
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import MeshShape, backend_for
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import make_plan

    cfg = _train_cfg("bfloat16")
    data = SyntheticLMData(cfg.vocab, 2, 80)
    opt_cfg = tsteps.optimizer_config(cfg)
    mesh = MeshShape(("data", "model"), (1, 1))
    plan = make_plan(mesh, 10**12, force_mode="tp", force_fsdp=False, force_attn_seq=True)
    assert plan.model_axis == "model" and plan.attn_seq
    runs = {}
    dist.init_process_group(backend_for(cuda_device), init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        sharded = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, base_lr=1e-3,
                                                 total_steps=3, seq_len=80)
        for label, step in (("unsharded", tsteps.make_train_step(cfg, opt_cfg, base_lr=1e-3,
                                                                  total_steps=3)),
                            ("sp", sharded)):
            params = TM.init_model(cfg, seed=0, device=cuda_device)
            if label == "sp":
                params = sharded.layout.shard(params)
            opt = adamw_init(params, opt_cfg)
            out = []
            for i in range(3):
                tgemm.reset_launches()
                tfa.reset_launches()
                params, opt, m = step(params, opt, to_device(data.batch_at(i), cuda_device))
                out.append((float(m["loss"]), tgemm.launches, tfa.launches, tfa.bwd_launches,
                            m.get("collectives")))
            runs[label] = (out, tree_lib.leaves(params))
    finally:
        dist.destroy_process_group()
    (want, wp), (got, gp) = runs["unsharded"], runs["sp"]
    assert [x[:4] for x in got] == [x[:4] for x in want] and got[0][2] > 0 and got[0][3] > 0
    assert all(torch.equal(a, b) for a, b in zip(gp, wp))
    meta = tsteps.make_sharded_train_step(cfg, opt_cfg, mesh, plan, rank=0)
    pieces = meta.layout.shard(tsteps.params_struct(cfg))
    batch = {k: torch.zeros((2, 80), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    step_cost.analyze(meta, pieces, adamw_init(pieces, opt_cfg), batch)
    assert got[-1][4] == dict(meta.layout.collectives)
    assert got[-1][4]["all_gather"] > 0 and got[-1][4]["reduce_scatter"] > 0
    assert sharded.layout.model_sharded == 2 + cfg.n_layers * 3


# (B, Sq, Skv, Hq, Hkv, D, window, q_offset): a sequence-parallel rank's
# queries over the whole key sequence, causal (chip_smoke.py phase 2's 18c
# shapes): qwen3-14b's 40 / 8 heads at offsets 0 and 512 of S 1024, with and
# without a 512 window; gemma3-1b's 4 / 1 at D 256 with its window; an offset
# that is no multiple of a tile.
OFFSET_CASES = [
    (2, 512, 1024, 40, 8, 128, None, 0), (2, 512, 1024, 40, 8, 128, None, 512),
    (2, 512, 1024, 40, 8, 128, 512, 0), (2, 512, 1024, 40, 8, 128, 512, 512),
    (2, 512, 1024, 4, 1, 256, 512, 512), (1, 100, 256, 4, 1, 64, None, 37),
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_flash_attention_at_a_q_offset_matches_plain(cuda_device, dtype, case):
    """K5 (out and lse) and K5b through the autograd Function at a q offset
    against their plain versions, with the bars of
    test_flash_attention_backward_kernel_matches_plain; the keys past the
    last query's position get dK = dV = 0 exactly (K5b writes the key tiles
    no query sees); two runs give the same bits."""
    B, Sq, Skv, Hq, Hkv, D, window, off = case
    rng = np.random.default_rng(Sq + off)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=2 ** -8)
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)).to(
        cuda_device, dtype).requires_grad_(True)
    k, v = (torch.from_numpy(rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))
            .to(cuda_device, dtype).requires_grad_(True) for _ in range(2))
    do = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)).to(
        cuda_device, dtype)
    tfa.reset_launches()
    run = lambda: torch.autograd.grad(tfa.flash_attention(q, k, v, window=window,  # noqa: E731
                                                          q_offset=off), (q, k, v), do)
    got, again = run(), run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert tfa.launches == 2 and tfa.bwd_launches == 2
    qd, kd, vd = (t.detach() for t in (q, k, v))
    o, lse = tfa._forward(qd, kd, vd, True, window, True, off)
    po, plse = tfa.flash_attention_plain(qd, kd, vd, window=window, q_offset=off,
                                         return_lse=True)
    torch.testing.assert_close(o, po, **tol)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)
    want = tfa.flash_attention_bwd_plain(qd, kd, vd, o, lse, do, window=window, q_offset=off)
    for g, w in zip(got, want):
        assert g.dtype == dtype and bool(g.isfinite().all())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=rel * float(w.float().abs().max()))
    unseen = off + Sq
    if unseen < Skv:
        for g in got[1:]:
            assert bool((g[:, unseen:] == 0).all()) and bool((g[:, :unseen] != 0).any())
