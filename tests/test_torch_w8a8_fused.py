"""The w8a8 GeMM with its row quantization fused into the int8 GeMM, on the
CPU: the launch plan the int8 kernel runs with (K1's, at 1-byte elements)
and the fused entry's plain version against the reference.

`gemm_int8.gemm_w8a8` runs, on a card, one kernel that quantizes x's rows
(per row, or with a static scale) in the int8 GeMM's prologue; on the CPU
it runs the plain composition, held here bit for bit against the
reference's Pallas w8a8 GeMM in interpret mode (dynamic) and the
reference's `ops.gemm_w8a8` with a static scale.  (The kernel itself is
held against the plain version on the card: tests/test_torch_gpu.py and
chip_smoke.py.)"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.generator import TpuGemmSpec
from repro.kernels import ops as rops
from repro.kernels.quant import make_w8a8_gemm
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import gemm_int8 as tgemm8
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tkquant
from repro_torch.kernels import registry as tregistry


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
# the plan of the int8 kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 8, 64])
@pytest.mark.parametrize("name,K,N", [(n, k, c) for n, k, c, _ in GEMM_SHAPES])
def test_int8_plan_at_model_shapes(name, K, N, M):
    """The int8 kernel plans with K1's rule at 1-byte elements and B
    K-major: 128 codes a stage, the swapped tile at M <= 16, a grid that
    covers C once per split, no empty split, and a split-K workspace (read
    as int32) and tile counters within what is allocated once per device."""
    plan = tgemm.gemm_plan(M, N, K, True, SMS, 1)
    assert plan.kmajor and plan.bk == 128 and plan.swap == (M <= 16)
    assert plan.bm == (16 if M <= 16 else 64)
    tiles = -(-M // plan.bm) * -(-N // tgemm.TILE_N)
    k_tiles = -(-K // plan.bk)
    assert plan.grid == (-(-N // tgemm.TILE_N), -(-M // plan.bm), plan.splits)
    assert 1 <= plan.splits <= tgemm.MAX_SPLITS[plan.swap]
    assert (plan.splits - 1) * plan.kps < k_tiles <= plan.splits * plan.kps
    if tiles >= SMS:
        assert plan.splits == 1 and plan.ws_elems == 0
    if plan.splits > 1:
        assert tiles < SMS                                   # one counter per tile
        assert plan.ws_elems == plan.splits * M * N <= tgemm.workspace_elems(SMS)
        assert plan.kps >= tgemm.MIN_K_TILES


# ---------------------------------------------------------------------------
# the fused entry's plain version against the reference
# ---------------------------------------------------------------------------

SPEC = TpuGemmSpec(tm=8, tk=128, tn=128)
CASES = [  # (M, K, N): ragged M, K and N; one row of each x is all zero
    (1, 40, 24),
    (5, 130, 33),
    (13, 256, 129),
    (17, 70, 200),
]


def _pad(a, rows, cols):
    return np.pad(a, ((0, -a.shape[0] % rows), (0, -a.shape[1] % cols)))


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(M, K)) * 3).astype(np.float32)
    x[M // 2] = 0.0                                  # the 1e-8 scale floor
    x[0, :3] = (127.0, 0.5, -2.5)                    # a tie at its row's scale
    w_q = rng.integers(-127, 128, size=(K, N), dtype=np.int8)
    w_s = rng.uniform(1e-3, 1e-1, size=(1, N)).astype(np.float32)
    return x, w_q, w_s


def _torch_weight(w_q):
    """The weight as `quant.params` holds it: the .t() view of (N, K)."""
    return torch.from_numpy(np.ascontiguousarray(w_q.T)).t()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", CASES)
def test_fused_dynamic_matches_reference_w8a8_kernel(M, K, N, dtype):
    """Per-row scales: the fused entry (and its plain version, and the
    "w8a8" registry variant) equals the reference's Pallas w8a8 GeMM
    (`make_w8a8_gemm`, interpret mode; operands padded to its tiles) bit
    for bit, f32 out; bf16 out is that value rounded once."""
    x, w_q, w_s = _inputs(M, K, N, seed=M)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(make_w8a8_gemm(SPEC, interpret=True)(
        jnp.pad(jx, ((0, -M % SPEC.tm), (0, -K % SPEC.tk))),
        jnp.asarray(_pad(w_q, SPEC.tk, SPEC.tn)),
        jnp.asarray(_pad(w_s, 1, SPEC.tn))))[:M, :N]
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw, ts = _torch_weight(w_q), torch.from_numpy(w_s)
    tgemm8.reset_launches()
    got = tgemm8.gemm_w8a8(tx, tw, ts)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tgemm8.gemm_w8a8_plain(tx, tw, ts).numpy(), want)
    np.testing.assert_array_equal(tregistry.make_kernel("w8a8")(tx, tw, ts).numpy(), want)
    np.testing.assert_array_equal(tops.gemm_w8a8(tx, tw, ts.reshape(-1)).numpy(), want)
    got16 = tgemm8.gemm_w8a8(tx, tw, ts, out_dtype=torch.bfloat16)
    assert torch.equal(got16, torch.tensor(want).to(torch.bfloat16))
    # the plain composition: the rows' codes and scales are K4's
    x_q, sx = tkquant.quantize_rows_plain(tx)
    assert torch.equal(got, tgemm8.dequant_gemm_plain(x_q, tw, sx, ts))
    assert tgemm8.w8a8_launches == 0                  # CPU tensors launch nothing


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", CASES)
def test_fused_static_matches_reference_gemm_w8a8(M, K, N, dtype, backend):
    """A static per-tensor scale: codes round(x / s) by true division, then
    the dequant GeMM with s for every row, bit for bit against the
    reference's `ops.gemm_w8a8(..., act_scale=s)` (its Pallas dequant GeMM
    in interpret mode, or its jnp oracle)."""
    x, w_q, w_s = _inputs(M, K, N, seed=100 + M)
    s = np.float32(np.abs(x).max() / 127.0 * 0.8)   # some rows clip at +-127
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(rops.gemm_w8a8(jx, jnp.asarray(w_q), jnp.asarray(w_s),
                                     act_scale=jnp.asarray(s), backend=backend))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tw, ts = _torch_weight(w_q), torch.from_numpy(w_s)
    got = tgemm8.gemm_w8a8(tx, tw, ts, torch.tensor(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tops.gemm_w8a8(tx, tw, ts, act_scale=torch.tensor(s)).numpy(), want)
    got16 = tgemm8.gemm_w8a8(tx, tw, ts, torch.tensor(s), out_dtype=torch.bfloat16)
    assert torch.equal(got16, torch.tensor(want).to(torch.bfloat16))


def test_fused_entry_rejects_bad_operands():
    """Shapes, dtypes and scale shapes are checked on every device."""
    x = torch.zeros((4, 8))
    w = torch.zeros((8, 6), dtype=torch.int8)
    s = torch.ones((1, 6))
    assert tgemm8.gemm_w8a8(x, w, s).shape == (4, 6)
    assert tgemm8.gemm_w8a8(x, w, s.reshape(-1)).shape == (4, 6)
    with pytest.raises(ValueError, match="shapes"):
        tgemm8.gemm_w8a8(x[:, :7], w, s)
    with pytest.raises(TypeError):
        tgemm8.gemm_w8a8(x.to(torch.int8), w, s)           # int8 activations
    with pytest.raises(TypeError):
        tgemm8.gemm_w8a8(x, w.float(), s)                  # a float weight
    with pytest.raises(ValueError, match="scales"):
        tgemm8.gemm_w8a8(x, w, torch.ones((6, 1)))         # (N, 1) column scales
    with pytest.raises(ValueError, match="scales"):
        tgemm8.gemm_w8a8(x, w, torch.ones((1, 5)))
    with pytest.raises(TypeError, match="float32"):
        tgemm8.gemm_w8a8(x, w, s.double())
