"""The float GeMMs' launch plan and their split-K arithmetic on the CPU.

`gemm_plan` picks the tile, the operand roles and the split-K count that K1
(csrc/gemm.cu) and K6 (csrc/gemm_pipelined.cu) launch with; the kernels sum
the splits' partials in split order inside the launch.  `gemm_split_plain`
is that arithmetic in plain PyTorch, held here against the reference's
Pallas kernel in interpret mode and its oracle.  (The kernels themselves
are held against their plain versions on the card: tests/test_torch_gpu.py
and chip_smoke.py.)"""

import functools
import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import _build
from repro_torch.kernels import gemm as tgemm


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GEMM_SHAPES = _chip_smoke().GEMM_SHAPES   # gemma3-1b's projections and tied head
SMS = 132                                  # the H100's multiprocessors


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kmajor", [False, True])
@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("name,K,N", [(n, k, c) for n, k, c, _ in GEMM_SHAPES])
def test_plan_fills_the_card_without_empty_splits(name, K, N, M, kmajor):
    """Swap exactly when M <= 16; the grid covers C once per split; the
    rule asks for a block on every SM unless a cap stops it (MAX_SPLITS,
    or MIN_K_TILES stages a split), and rounding only drops splits; no
    split is empty; the workspace and counters the launch needs fit the
    ones allocated per device."""
    plan = tgemm.gemm_plan(M, N, K, kmajor, SMS)
    assert plan.swap == (M <= 16) and plan.kmajor == kmajor
    assert plan.bk == 64 and plan.bm == (16 if M <= 16 else 64)
    tiles = -(-M // plan.bm) * -(-N // tgemm.TILE_N)
    k_tiles = -(-K // plan.bk)
    assert plan.grid == (-(-N // tgemm.TILE_N), -(-M // plan.bm), plan.splits)
    assert 1 <= plan.splits <= tgemm.MAX_SPLITS[plan.swap]
    assert (plan.splits - 1) * plan.kps < k_tiles <= plan.splits * plan.kps
    ranges = tgemm.split_ranges(plan, K)
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(k0 < k1 for k0, k1 in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    asked = tgemm.requested_splits(tiles, k_tiles, plan.swap, SMS)
    capped = asked in (k_tiles // tgemm.MIN_K_TILES, tgemm.MAX_SPLITS[plan.swap])
    assert tiles * asked >= SMS or capped
    assert plan.kps == -(-k_tiles // asked) and plan.splits <= asked
    if asked > 1:
        assert plan.kps >= tgemm.MIN_K_TILES
    if tiles >= SMS:
        assert plan.splits == 1
    if plan.splits > 1:
        assert plan.ws_elems == plan.splits * M * N <= tgemm.workspace_elems(SMS)
        assert tiles < SMS                       # one counter per tile
    else:
        assert plan.ws_elems == 0


@pytest.mark.parametrize("M,N,K,sms", [
    (8, 1024, 1152, 132), (64, 6912, 1152, 132), (1, 262144, 1152, 132),
    (13, 45, 70, 132), (2048, 6912, 1152, 132), (8, 300, 6912, 16),
    (17, 129, 4000, 8), (16, 1, 1, 132)])
@pytest.mark.parametrize("elem_bytes", [1, 2, 4])
def test_plan_workspace_bound_and_determinism(M, N, K, sms, elem_bytes):
    """The workspace bound holds for every card size and operand width, and
    the plan is a pure function of its arguments."""
    plan = tgemm.gemm_plan(M, N, K, False, sms, elem_bytes)
    assert plan == tgemm.gemm_plan.__wrapped__(M, N, K, False, sms, elem_bytes)
    assert plan.bk == 128 // elem_bytes
    assert plan.ws_elems <= tgemm.workspace_elems(sms)
    if plan.splits > 1:
        assert plan.grid[0] * plan.grid[1] < sms


# ---------------------------------------------------------------------------
# the split-K arithmetic against the reference
# ---------------------------------------------------------------------------

# Within test_torch_kernels.py's GEMM_TOL: f32 out for both operand dtypes
# (bf16 products are exact in f32), so the packages differ only in the
# order of the f32 sums.
GEMM_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=1e-5, atol=1e-5)}
SPLIT_CASES = [  # (M, K, N, transposed B view)
    (8, 1030, 96, False),      # 17 bf16 / 33 f32 stages, ragged K
    (13, 70, 45, False),       # ragged everywhere, 2 / 3 stages
    (1, 1100, 129, True),      # the tied-head shape class: B = table.T, M = 1
    (64, 520, 17, True),
]


def _operands(M, K, N, transposed, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    b = (rng.normal(size=(N, K) if transposed else (K, N)) * K ** -0.5).astype(np.float32)
    return a, b


@functools.lru_cache(maxsize=None)
def _references(M, K, N, transposed, dtype):
    """The Pallas kernel in interpret mode and ref.gemm_ref, f32 out."""
    a, b = _operands(M, K, N, transposed)
    jdt = getattr(jnp, dtype)
    ja = jnp.asarray(a, jdt)
    jb = jnp.asarray(b, jdt).T if transposed else jnp.asarray(b, jdt)
    return (np.asarray(rops.gemm(ja, jb, backend="interpret")),
            np.asarray(rref.gemm_ref(ja, jb)))


@pytest.mark.parametrize("splits", [None, 1, 2, 5, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,transposed", SPLIT_CASES)
def test_split_plain_matches_reference_kernel(M, K, N, transposed, dtype, splits):
    """The plan's K partition (splits=None) and forced counts, partials
    summed in split order, equal the Pallas kernel (interpret mode) and
    ref.gemm_ref within GEMM_TOL."""
    a, b = _operands(M, K, N, transposed)
    tdt = getattr(torch, dtype)
    ta = torch.from_numpy(a).to(tdt)
    tb = torch.from_numpy(b).to(tdt)
    tb = tb.t() if transposed else tb
    got = tgemm.gemm_split_plain(ta, tb, sms=SMS, splits=splits)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    want_kernel, want_ref = _references(M, K, N, transposed, dtype)
    np.testing.assert_allclose(got.numpy(), want_kernel, **GEMM_TOL[dtype])
    np.testing.assert_allclose(got.numpy(), want_ref, **GEMM_TOL[dtype])
    plan = tgemm.gemm_plan(M, N, K, transposed, SMS, ta.element_size(), splits)
    if splits is not None:
        k_tiles = -(-K // plan.bk)
        assert plan.splits == -(-k_tiles // -(-k_tiles // splits))


def test_split_plain_order_is_the_kernels():
    """The partials are summed in split order from zero and rounded once:
    bit for bit the per-range products summed in a loop."""
    a, b = _operands(8, 1030, 96, False, seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plan = tgemm.gemm_plan(8, 96, 1030, False, SMS, 4)
    assert plan.splits > 1
    want = torch.zeros((8, 96))
    for k0, k1 in tgemm.split_ranges(plan, 1030):
        want = want + ta[:, k0:k1] @ tb[k0:k1]
    assert torch.equal(tgemm.gemm_split_plain(ta, tb, sms=SMS), want)
    torch.testing.assert_close(tgemm.gemm_split_plain(ta, tb, torch.bfloat16, sms=SMS),
                               want.to(torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the build: a change to a shared header rebuilds the libraries
# ---------------------------------------------------------------------------

def test_library_is_stale_when_a_header_is_newer(tmp_path, monkeypatch):
    """`_build._stale` compares a library with its source and with every
    csrc/*.cuh header (gemm.cu and gemm_pipelined.cu include gemm_mma.cuh)."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir(), build.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    src, hdr, lib = csrc / "gemm.cu", csrc / "gemm_mma.cuh", build / "libgemm.so"
    assert _build._stale("gemm")                      # no library yet
    for path, mtime in ((src, 100), (hdr, 100), (lib, 200)):
        path.write_text("")
        os.utime(path, (mtime, mtime))
    assert not _build._stale("gemm")
    os.utime(hdr, (300, 300))                         # the header changed
    assert _build._stale("gemm")
    os.utime(lib, (400, 400))
    assert not _build._stale("gemm")
    os.utime(src, (500, 500))                         # the source changed
    assert _build._stale("gemm")
