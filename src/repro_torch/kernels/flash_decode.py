"""Paged flash-decode: CUDA kernel wrapper, its plain versions, dispatch.

Port of repro/kernels/flash_decode.py.  `flash_decode_attention` launches
`csrc/flash_decode.cu`, the hand-written replacement for the Pallas TPU
kernel `_decode_kernel` plus its split merge `_combine_splits`: decode
attention for Sq query positions per slot read straight from the paged KV
pool through the block tables (GQA rows packed per kv head, causal /
seq-cap / sliding-window masks in the kernel, split-K online-softmax
partials merged in a second kernel).  An int8 pool (the reference's
quantized branch) carries a float32 scale per (block, position, kv head)
and the kernel dequantizes each K/V element as it leaves shared memory.
It is bound by the pool bytes it reads and by latency; the note at the top
of the .cu file says what the design does about that.  Without an explicit
`FlashDecodeSpec` the split count comes from `decode_splits`: enough
splits of the table extent for about two blocks per SM.

Plain versions beside it: `ref_paged_decode`, the bounded online-softmax
walk over table-column chunks (the reference's CPU default);
`gather_decode`, the `gather_kv` + `decode_attention` oracle; and
`split_decode_plain`, the kernel's own split partials and merge.

`paged_decode_attention` is the entry the model calls: CUDA tensors launch
the kernel (or raise), CPU tensors run `ref_paged_decode`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.serving.kv_cache import NULL_BLOCK, PagedKVCache, gather_kv

NEG_INF = -2.0e38

# Launches of the CUDA kernel pair since the last reset (plain versions never
# count): the proof that a run went through the kernel.  `launches` counts
# float pools, `launches_int8` int8 pools.
launches = 0
launches_int8 = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)   # instantiated in csrc/flash_decode.cu
_MAX_SPLIT_COLS = 4096        # table entries of one split the kernel holds in shared memory
INVARIANT_SQ = 16             # launch_splits: up to this Sq, one position's split count
_SM_COUNT = {}                # device index -> multiprocessor count


def reset_launches() -> None:
    global launches, launches_int8
    launches = launches_int8 = 0


@dataclasses.dataclass(frozen=True)
class FlashDecodeSpec:
    """One decode-kernel design point.

    num_splits     split-K factor over the block-table columns; each split
                   emits partial (acc, m, l) merged by the combine kernel.
                   The CUDA wrapper, given no spec, picks it with
                   `decode_splits`.
    cols_per_iter  table columns the plain version gathers per iteration.
    """

    num_splits: int = 1
    cols_per_iter: int = 8

    def __post_init__(self):
        if self.num_splits < 1:
            raise ValueError(f"num_splits must be >= 1, got {self.num_splits}")
        if self.cols_per_iter < 1:
            raise ValueError(
                f"cols_per_iter must be >= 1, got {self.cols_per_iter}")


def _row_tile(rows: int) -> int:
    """Packed query rows per kernel block (RT in csrc/flash_decode.cu)."""
    return 4 if rows <= 4 else 16


@functools.lru_cache(maxsize=None)
def decode_splits(B: int, Hkv: int, row_tiles: int, max_blocks: int, n_sm: int) -> int:
    """Split count for a launch over B slots x Hkv kv heads x `row_tiles`
    row tiles and a table of `max_blocks` columns on `n_sm` SMs: enough
    splits for about two blocks per SM, no split under two columns, never
    more splits than columns.  The rule reads the table extent, known on the
    host, not the live lengths, which lie on the card; splits past a slot's
    length cost one block that exits at once."""
    want = -(-2 * n_sm // max(1, B * Hkv * row_tiles))
    return max(1, min(want, max_blocks // 2))


def split_columns(max_blocks: int, splits: int):
    """[(first, end)) table columns of each split, as the kernel cuts them:
    split s owns [s * max_blocks // splits, (s + 1) * max_blocks // splits)."""
    return [(s * max_blocks // splits, (s + 1) * max_blocks // splits)
            for s in range(splits)]


def _sm_count(device: torch.device) -> int:
    i = device.index if device.index is not None else torch.cuda.current_device()
    n = _SM_COUNT.get(i)
    if n is None:
        n = _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return n


def launch_splits(q: torch.Tensor, block_tables: torch.Tensor, Hkv: int,
                  spec: Optional[FlashDecodeSpec] = None) -> int:
    """The split count `flash_decode_attention` launches with for q (B, Sq,
    Hq, D) on a CUDA device: the spec's, else `decode_splits`'.  A step of
    at most INVARIANT_SQ positions per slot (a speculative verify step)
    takes the count of one position, so each position sums its keys in the
    splits a decode step sums them in: its output equals the decode step's
    bit for bit (the kernel's row tile does not change a row's sums)."""
    B, Sq, Hq, _ = q.shape
    max_blocks = block_tables.shape[1]
    if spec is not None:
        return max(1, min(spec.num_splits, max_blocks))
    rows = (Hq // Hkv) * (1 if Sq <= INVARIANT_SQ else Sq)
    return decode_splits(B, Hkv, -(-rows // _row_tile(rows)), max_blocks,
                         _sm_count(q.device))


def _index_vector(index, B: int, device) -> torch.Tensor:
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.expand(B) if idx.dim() == 0 else idx


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ref_paged_decode(q: torch.Tensor, cache: PagedKVCache,
                     block_tables: torch.Tensor, index, *,
                     window: Optional[int] = None,
                     cols_per_iter: int = 8) -> torch.Tensor:
    """Online-softmax decode over block-table column chunks, stopping once
    the chunk start passes max(index) + Sq (the reference's bounded
    fallback, written as a host loop).  An int8 pool is dequantized as each
    chunk is gathered."""
    B, Sq, Hq, D = q.shape
    nb, bs, Hkv, _ = cache.k.shape
    groups = Hq // Hkv
    max_blocks = block_tables.shape[1]
    seq_cap = max_blocks * bs
    dev = q.device
    C = max(1, min(cols_per_iter, max_blocks))
    n_cols = -(-max_blocks // C) * C
    bt = block_tables.to(torch.int64)
    if n_cols != max_blocks:
        bt = torch.nn.functional.pad(bt, (0, n_cols - max_blocks), value=NULL_BLOCK)
    idx = _index_vector(index, B, dev).to(torch.int64)
    k_flat = cache.k.reshape(nb * bs, Hkv, D)
    v_flat = cache.v.reshape(nb * bs, Hkv, D)
    if cache.quantized:
        ks_flat = cache.k_scale.reshape(nb * bs, Hkv)
        vs_flat = cache.v_scale.reshape(nb * bs, Hkv)

    qf = (q.to(torch.float32) * (D ** -0.5)).reshape(B, Sq, Hkv, groups, D)
    qf = qf.permute(0, 2, 3, 1, 4)                          # (B, H, G, Sq, D)
    qpos = idx[:, None] + torch.arange(Sq, device=dev)[None, :]   # (B, Sq)
    bound = int(idx.max()) + Sq
    span = C * bs
    offs = torch.arange(bs, device=dev)

    m = torch.full((B, Hkv, groups, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, groups, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, groups, Sq, D), dtype=torch.float32, device=dev)
    col = 0
    while col * bs < bound and col < max_blocks:
        blk = bt[:, col:col + C]
        flat = (blk[:, :, None] * bs + offs[None, None, :]).reshape(-1)
        k = k_flat[flat].reshape(B, span, Hkv, D).to(torch.float32)
        v = v_flat[flat].reshape(B, span, Hkv, D).to(torch.float32)
        if cache.quantized:
            k = k * ks_flat[flat].reshape(B, span, Hkv)[..., None]
            v = v * vs_flat[flat].reshape(B, span, Hkv)[..., None]
        s = torch.einsum("bhgqd,bkhd->bhgqk", qf, k)
        kpos = col * bs + torch.arange(span, device=dev)
        mask = (kpos[None, None, :] <= qpos[:, :, None]) \
            & (kpos < seq_cap)[None, None, :]
        if window is not None:
            mask &= (qpos[:, :, None] - kpos[None, None, :]) < window
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v)
        m = m_new
        col += C
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D)
    return out.to(q.dtype)


def gather_decode(q: torch.Tensor, cache: PagedKVCache,
                  block_tables: torch.Tensor, index, *,
                  window: Optional[int] = None) -> torch.Tensor:
    """The oracle: materialize every slot's view with `gather_kv` (which
    dequantizes an int8 pool), then dense masked softmax over the whole
    table extent."""
    from repro_torch.models.attention import decode_attention

    k, v = gather_kv(cache, block_tables)
    return decode_attention(q, k, v, index=index, window=window)


def split_decode_plain(q: torch.Tensor, cache: PagedKVCache,
                       block_tables: torch.Tensor, index, splits: int, *,
                       window: Optional[int] = None) -> torch.Tensor:
    """The kernel's split-K in plain PyTorch: per-split partials (acc, m, l)
    over `split_columns`, each over its visible keys only (the kernel clips
    a split to those keys; the keys it drops are masked here), merged as the
    combine kernel merges them: a split with m = NEG_INF (nothing visible to
    the row) is skipped, the rest weighted by exp(m - max m)."""
    B, Sq, Hq, D = q.shape
    _, bs, Hkv, _ = cache.k.shape
    G, max_blocks = Hq // Hkv, block_tables.shape[1]
    splits = max(1, min(splits, max_blocks))
    dev = q.device
    k, v = gather_kv(cache, block_tables)                   # (B, seq_cap, Hkv, D)
    k, v = k.to(torch.float32), v.to(torch.float32)
    idx = _index_vector(index, B, dev).to(torch.int64)
    qf = (q.to(torch.float32) * (D ** -0.5)).reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k)             # (B, H, G, Sq, K)
    qpos = idx[:, None] + torch.arange(Sq, device=dev)[None, :]
    kpos = torch.arange(max_blocks * bs, device=dev)
    live = kpos[None, None, :] <= qpos[:, :, None]          # (B, Sq, K)
    if window is not None:
        live &= (qpos[:, :, None] - kpos[None, None, :]) < window
    ms, ls, accs = [], [], []
    for c0, c1 in split_columns(max_blocks, splits):
        ok = (live & (kpos >= c0 * bs) & (kpos < c1 * bs))[:, None, None]
        m = torch.where(ok, s, torch.full_like(s, NEG_INF)).amax(dim=-1)
        p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgqk,bkhd->bhgqd", p, v))
    m = torch.stack(ms)                                     # (S, B, H, G, Sq)
    m_g = m.amax(dim=0)
    alpha = torch.where(m > NEG_INF, torch.exp(m - m_g), torch.zeros_like(m))
    l_g = (torch.stack(ls) * alpha).sum(dim=0)
    acc = (torch.stack(accs) * alpha[..., None]).sum(dim=0)
    out = acc / torch.clamp_min(l_g[..., None], 1e-30)      # (B, H, G, Sq, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def _lib():
    fn = _build.load("flash_decode").flash_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 9
                       + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           block_tables: torch.Tensor, index, *,
                           window: Optional[int] = None,
                           spec: Optional[FlashDecodeSpec] = None) -> torch.Tensor:
    """Decode attention over the paged pool through the CUDA kernel.

    q (B, Sq, Hq, D) float32/bfloat16; the pools (num_blocks, block_size,
    Hkv, D) in q's dtype, or int8 with float32 scales (num_blocks,
    block_size, Hkv); block_tables (B, max_blocks) int32; index the first
    query position per slot ((B,) int32, or a scalar).  Returns
    (B, Sq, Hq, D) in q's dtype.  `spec` None: the split count of
    `decode_splits`."""
    global launches, launches_int8
    if q.dim() != 4 or cache.k.dim() != 4 or cache.k.shape != cache.v.shape:
        raise ValueError(f"flash decode shapes q {tuple(q.shape)}, "
                         f"pool {tuple(cache.k.shape)}/{tuple(cache.v.shape)}")
    B, Sq, Hq, D = q.shape
    nb, bs, Hkv, Dk = cache.k.shape
    if Dk != D or Hq % Hkv or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"flash decode shapes q {tuple(q.shape)}, pool "
                         f"{tuple(cache.k.shape)}, tables {tuple(block_tables.shape)}")
    quantized = cache.k.dtype == torch.int8 or cache.v.dtype == torch.int8
    tensors = (q, cache.k, cache.v, block_tables)
    if quantized:
        if cache.k_scale is None or cache.v_scale is None:
            raise ValueError("flash decode kernel: an int8 pool needs its scales")
        if cache.k_scale.shape != cache.k.shape[:-1] \
                or cache.v_scale.shape != cache.k.shape[:-1] \
                or cache.k_scale.dtype != torch.float32 \
                or cache.v_scale.dtype != torch.float32:
            raise ValueError("flash decode kernel: int8 pool scales must be float32 "
                             f"{tuple(cache.k.shape[:-1])}")
        tensors += (cache.k_scale, cache.v_scale)
    if any(not t.is_cuda or t.device != q.device for t in tensors):
        raise ValueError("flash decode kernel takes CUDA tensors on one device")
    pool_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in _CODES or cache.k.dtype != pool_dtype \
            or cache.v.dtype != pool_dtype:
        raise TypeError(f"flash decode kernel takes f32/bf16 q and a pool of q's "
                        f"dtype or int8, got {q.dtype}, {cache.k.dtype}, {cache.v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash decode kernel: head_dim {D} not in {_HEAD_DIMS}")
    if block_tables.dtype != torch.int32:
        raise TypeError(f"block tables must be int32, got {block_tables.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash decode kernel takes contiguous tensors")
    if cache.k.data_ptr() % 16 or cache.v.data_ptr() % 16:
        raise ValueError("flash decode kernel: the pools must be 16-byte aligned")
    idx = _index_vector(index, B, q.device).contiguous()
    if idx.shape != (B,) or idx.dtype != torch.int32:
        raise ValueError(f"index must be (B,) int32, got {tuple(idx.shape)} {idx.dtype}")

    groups, max_blocks = Hq // Hkv, block_tables.shape[1]
    splits = launch_splits(q, block_tables, Hkv, spec)
    if -(-max_blocks // splits) > _MAX_SPLIT_COLS:
        raise ValueError(f"flash decode kernel: {max_blocks} table columns over "
                         f"{splits} splits exceed {_MAX_SPLIT_COLS} per split")
    out = torch.empty_like(q)
    ws = [None, None, None]
    if splits > 1:   # one workspace: acc (B, Hkv, splits, rows, D), then m, then l
        n = B * Hkv * splits * groups * Sq
        buf = torch.empty((n * (D + 2),), dtype=torch.float32, device=q.device)
        ptr = buf.data_ptr()
        ws = [ptr, ptr + 4 * n * D, ptr + 4 * n * (D + 1)]
    scales = (cache.k_scale.data_ptr(), cache.v_scale.data_ptr()) if quantized \
        else (None, None)
    err = _lib()(
        q.data_ptr(), cache.k.data_ptr(), cache.v.data_ptr(), *scales,
        block_tables.data_ptr(), idx.data_ptr(), out.data_ptr(),
        *ws,
        B, Sq, Hkv, groups, D, bs, max_blocks, splits,
        0 if window is None else int(window), D ** -0.5, _CODES[q.dtype],
        int(quantized), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash decode kernel launch failed: cudaError_t {err}")
    if quantized:
        launches_int8 += 1
    else:
        launches += 1
    return out


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache,
                           block_tables: torch.Tensor, index, *,
                           window: Optional[int] = None,
                           spec: Optional[FlashDecodeSpec] = None) -> torch.Tensor:
    """Decode attention over a paged KV cache, the entry the model layer
    calls: the CUDA kernel for CUDA tensors, `ref_paged_decode` for CPU
    tensors.  Equivalent to `gather_decode` either way.  With no `spec` the
    kernel's split count comes from `decode_splits`."""
    if q.device.type == "cpu":
        return ref_paged_decode(q, cache, block_tables, index, window=window,
                                cols_per_iter=(spec or FlashDecodeSpec()).cols_per_iter)
    if q.device.type != "cuda":
        raise ValueError(f"paged decode: no kernel for device {q.device}")
    return flash_decode_attention(q, cache, block_tables, index, window=window,
                                  spec=spec)
