"""The port's CUDA kernels against their plain PyTorch versions on a card.

Imports no JAX, so it runs on the GPU machine:
    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
Every test here is marked `gpu` and skips without a CUDA device."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import gemm as tgemm
from repro_torch.serving import kv_cache as tkvc

GEMM_CASES = [  # (M, K, N, transposed B view)
    (8, 64, 96, False),
    (13, 70, 45, False),      # ragged everywhere
    (1, 33, 129, True),       # the tied-head shape class: B = table.T
    (64, 40, 17, True),
    (8, 6912, 300, False),    # split-K with a ragged tail
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
@pytest.mark.parametrize("sq,window,splits", [
    (1, None, 1), (1, None, 4), (3, None, 2), (1, 6, 1), (3, 6, 4)])
def test_flash_decode_kernel_matches_plain(cuda_device, sq, window, splits):
    """Ragged lengths (one at the table's capacity), GQA packing, windows,
    Sq > 1 and split-K against the plain walk and the gather oracle."""
    B, bs, max_blocks, hkv, groups, d = 3, 4, 6, 2, 2, 64
    lengths = [5, 12, max_blocks * bs]
    rng = np.random.default_rng(1)
    nb = 1 + B * max_blocks
    cache = tkvc.init_paged_kv(nb, bs, hkv, d, torch.float32, cuda_device)
    alloc, tables = tkvc.BlockAllocator(nb, bs), tkvc.BlockTables(B, max_blocks)
    for s, n in enumerate(lengths):
        tables.ensure(s, n, alloc)
    bt = tables.array(cuda_device)
    kv = torch.from_numpy(rng.normal(size=(2, B, max(lengths), hkv, d))
                          .astype(np.float32)).to(cuda_device)
    tkvc.write_kv(cache, bt, kv[0], kv[1], 0)
    q = torch.from_numpy(rng.normal(size=(B, sq, hkv * groups, d))
                         .astype(np.float32)).to(cuda_device)
    idx = torch.tensor([n - sq for n in lengths], dtype=torch.int32,
                       device=cuda_device)
    tfd.reset_launches()
    got = tfd.flash_decode_attention(q, cache, bt, idx, window=window,
                                     spec=tfd.FlashDecodeSpec(num_splits=splits))
    assert tfd.launches == 1
    for want in (tfd.ref_paged_decode(q, cache, bt, idx, window=window),
                 tfd.gather_decode(q, cache, bt, idx, window=window)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
