"""The tiled GeMM: CUDA kernel wrapper, its plain versions, a launch count,
and the launch plan and split-K scratch it shares with the pipelined GeMM.

Port of repro/kernels/gemm.py::_gemm_kernel (the Pallas TPU kernel built by
`make_gemm`).  The kernel, `csrc/gemm.cu`, computes C = A @ B with float32
accumulation for float32 or bfloat16 operands (bf16 on the tensor cores)
and writes C in the dtype the caller asks for.  It is bound by B's bytes at
decode batch sizes (every launch reads all of B; the notes at the top of
gemm.cu and gemm_mma.cuh say what the design does about that).

One launch per call: `gemm_plan` picks the tile and the split-K count, and
the kernel sums the splits' partials itself, in split order, in a
workspace allocated once per device (`splitk_scratch`).

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version `gemm_plain`.  No fallback on the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernel since the last reset (the plain version never
# counts): the proof that a run went through the kernel.
launches = 0
# Operands `rows_for_copies` re-laid (copied) since the last reset, for
# every kernel that takes its operands through it: a model whose weights
# are stored aligned (`aligned_rows`, as `init_model` stores an untied
# head) makes none.
relaid = 0

# The tiles of csrc/gemm_mma.cuh.
TILE_N = 128          # output columns per block
K_TILE_BYTES = 128    # K per stage, in bytes: 64 bf16, 32 f32, 128 int8
SWAP_ROWS = 16        # M <= 16: the swapped tensor-core tile (SIMT: 16 rows)
FULL_ROWS = 64        # M > 16: 64 rows per block
# The split rule (`gemm_plan`).
MIN_K_TILES = 2       # K stages per split, at least
# By swap; the fix-up block reads every split's tile.  One cap for both
# tiles: at M <= FULL_ROWS every plan has one row tile, so the split count,
# and with it every output element's sum, is the same at any such M (a
# speculative verify step's rows at M = 16-40 equal the decode step's at
# M = 8, bit for bit).
MAX_SPLITS = {True: 16, False: 16}

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global launches, relaid
    launches = relaid = 0


@functools.lru_cache(maxsize=None)
def _lib():
    fn = _build.load("gemm").gemm_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class GemmPlan(NamedTuple):
    """One launch of K1 or K6: tile, operand roles, K partition, grid."""
    swap: bool          # M <= 16: C^T = B^T A^T on the tensor cores (SIMT: 16-row tile)
    kmajor: bool        # B is K-contiguous (the tied head's .t() view)
    bm: int             # rows of C per block tile
    bk: int             # K per stage, in elements
    splits: int         # K ranges, one per blockIdx.z; none empty
    kps: int            # K stages per split (the last split may hold fewer)
    grid: Tuple[int, int, int]
    ws_elems: int       # workspace elements the launch writes: splits * M * N, or 0


@functools.lru_cache(maxsize=4096)
def gemm_plan(M: int, N: int, K: int, b_kmajor: bool, sms: int,
              elem_bytes: int = 2, splits: Optional[int] = None) -> GemmPlan:
    """The launch for a (M, K) @ (K, N) product of `elem_bytes` operands on
    a card with `sms` multiprocessors.  One split when the output tiles give
    every SM a block; else `requested_splits` asks for enough splits to get
    there, each keeping at least MIN_K_TILES K stages, at most
    MAX_SPLITS[swap].  (One block per SM and not two: every split adds a
    partial tile to write, fence and read back, and on the H100 fewer,
    longer splits were faster; chip_smoke.py times both rules.)  `splits`
    forces a count instead (the plain split version's tests).  Either way
    the K stages are dealt ceil(k_tiles / splits) per split, and splits
    left empty by the rounding are dropped.  Up to FULL_ROWS rows the plan
    splits K as at M = 1, so a row's result does not depend on M."""
    swap = M <= SWAP_ROWS
    bm = SWAP_ROWS if swap else FULL_ROWS
    bk = K_TILE_BYTES // elem_bytes
    tiles = -(-M // bm) * -(-N // TILE_N)
    k_tiles = -(-K // bk)
    if splits is None:
        splits = requested_splits(tiles, k_tiles, swap, sms)
    kps = -(-k_tiles // max(1, splits))
    splits = -(-k_tiles // kps)
    return GemmPlan(swap, b_kmajor, bm, bk, splits, kps,
                    (-(-N // TILE_N), -(-M // bm), splits),
                    splits * M * N if splits > 1 else 0)


def requested_splits(tiles: int, k_tiles: int, swap: bool, sms: int) -> int:
    """The split count the rule asks for before rounding: one block per SM,
    at least MIN_K_TILES stages a split, at most MAX_SPLITS[swap]."""
    if tiles >= sms:
        return 1
    return max(1, min(-(-sms // tiles), k_tiles // MIN_K_TILES, MAX_SPLITS[swap]))


def split_ranges(plan: GemmPlan, K: int) -> List[Tuple[int, int]]:
    """The K range [k0, k1) of each split, in split order."""
    step = plan.kps * plan.bk
    return [(z * step, min(K, (z + 1) * step)) for z in range(plan.splits)]


def workspace_elems(sms: int) -> int:
    """Elements of the split-K workspace: every plan that splits has
    tiles < sms and splits <= ceil(sms / tiles), so tiles * splits
    < 2 * sms partial tiles of at most FULL_ROWS x TILE_N."""
    return 2 * sms * FULL_ROWS * TILE_N


_scratch: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def splitk_scratch(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K workspace (float32; the int8 mode reads it as int32) and
    the per-tile arrival counters of `device`, allocated at first use and
    shared by K1 and K6.  The kernels leave every counter at 0.  Launches go
    on PyTorch's current stream, which orders their uses of it."""
    got = _scratch.get(device)
    if got is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the GeMM's split-K scratch is allocated at its first "
                               "eager call; call it once before capturing a graph")
        sms = sm_count(device)
        got = (torch.empty(workspace_elems(sms), dtype=torch.float32, device=device),
               torch.zeros(sms, dtype=torch.int32, device=device))
        _scratch[device] = got
    return got


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """2-D `t` as the kernels' 16-byte copies take it: its last axis
    contiguous and every row starting 16-byte aligned.  A tensor that is
    not comes back as a copy with each row padded to a multiple of 16 bytes
    (the view keeps the logical shape)."""
    s0, s1 = t.stride()
    if s1 == 1 and t.data_ptr() % 16 == 0 and (s0 * t.element_size()) % 16 == 0:
        return t
    rows, cols = t.shape
    per = 16 // t.element_size()
    buf = torch.zeros((rows, -(-cols // per) * per), dtype=t.dtype, device=t.device)
    buf[:, :cols] = t
    return buf[:, :cols]


def rows_for_copies(t: torch.Tensor) -> torch.Tensor:
    """`aligned_rows(t)` on a launch's operand, counting the copies in
    `relaid`."""
    out = aligned_rows(t)
    if out is not t:
        global relaid
        relaid += 1
    return out


def operands_for_copies(a: torch.Tensor, b: torch.Tensor):
    """(a, b, b_kmajor) as the kernels' 16-byte copies take them: A with K
    contiguous, B with K (an (N, K) store seen through .t()) or N
    contiguous, every row 16-byte aligned.  An operand that is not comes
    back as a re-laid copy.  On the model's path none is: the activations
    are contiguous with K a multiple of 8, and an untied head whose vocab is
    not a multiple of 8 (bert-base's 30522) is stored with padded rows
    (`aligned_rows`)."""
    sb0, sb1 = b.stride()
    kmajor = sb0 == 1 and sb1 != 1
    b = rows_for_copies(b.t()).t() if kmajor else rows_for_copies(b)
    return rows_for_copies(a), b, kmajor


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32-accumulated A @ B."""
    return ref.gemm_ref(a, b).to(out_dtype)


def gemm_split_plain(a: torch.Tensor, b: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32, *,
                     sms: int = 132, splits: Optional[int] = None) -> torch.Tensor:
    """The kernel's split-K arithmetic in plain PyTorch: one f32 partial
    per split of `gemm_plan`'s K partition (or of a forced `splits`),
    summed in split order from zero, then rounded once to `out_dtype`."""
    M, K = a.shape
    N = b.shape[1]
    plan = gemm_plan(M, N, K, b.stride(0) == 1 and b.stride(1) != 1, sms,
                     a.element_size(), splits)
    out = torch.zeros((M, N), dtype=torch.float32, device=a.device)
    for k0, k1 in split_ranges(plan, K):
        out = out + ref.gemm_ref(a[:, k0:k1], b[k0:k1])
    return out.to(out_dtype)


def gemm(a: torch.Tensor, b: torch.Tensor, *,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ B for a (M, K) and b (K, N), any strides, f32 accumulation,
    C (M, N) contiguous in `out_dtype`."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"gemm operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return gemm_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"gemm: no kernel for device {a.device}")
    return _gemm_cuda(a, b, out_dtype)


def check_launch(a: torch.Tensor, b: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """(M, N, K) of a kernel launch, or raise on what the kernels do not take."""
    M, K = a.shape
    N = b.shape[1]
    if min(M, N, K) < 1 or max(M, N, K) > _INT_MAX or M * N > _INT_MAX:
        raise ValueError(f"{what} kernel shape ({M}, {K}, {N}) out of range")
    if min(*a.stride(), *b.stride()) < 0:
        raise ValueError(f"{what} kernel takes non-negative strides only")
    return M, N, K


@functools.lru_cache(maxsize=4096)
def launch_plan(M: int, N: int, K: int, kmajor: bool, elem_bytes: int,
                device: torch.device):
    """(plan, workspace pointer, counters pointer) of one launch on
    `device`; cached, since the scratch is never freed."""
    plan = gemm_plan(M, N, K, kmajor, sm_count(device), elem_bytes)
    if plan.splits == 1:
        return plan, None, None
    ws, counters = splitk_scratch(device)
    if plan.ws_elems > ws.numel():
        raise RuntimeError(f"split-K plan {plan} exceeds the workspace ({ws.numel()})")
    return plan, ws.data_ptr(), counters.data_ptr()


def _gemm_cuda(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if a.dtype != b.dtype or a.dtype not in _CODES:
        raise TypeError(f"gemm kernel takes f32/bf16 pairs, got {a.dtype}, {b.dtype}")
    if out_dtype not in _CODES:
        raise TypeError(f"gemm kernel writes f32 or bf16, not {out_dtype}")
    M, N, K = check_launch(a, b, "gemm")
    a, b, kmajor = operands_for_copies(a, b)
    dev = a.device
    plan, ws, counters = launch_plan(M, N, K, kmajor, a.element_size(), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    err = _lib()(a.data_ptr(), b.data_ptr(), out.data_ptr(), ws, counters,
                 M, N, K, a.stride(0), *b.stride(), _CODES[a.dtype], _CODES[out_dtype],
                 plan.swap, plan.kmajor, plan.kps, plan.splits,
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"gemm kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
