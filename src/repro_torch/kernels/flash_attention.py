"""Flash attention: CUDA kernel wrapper, its plain version, a launch count.

Port of repro/kernels/flash_attention.py: `flash_attention` launches
`csrc/flash_attention.cu`, the hand-written replacement for the Pallas TPU
kernel `_flash_kernel`: full-sequence attention over q (B, Sq, Hq, D) and
k/v (B, Skv, Hkv, D) with causal and sliding-window masks and GQA, online
softmax, the score matrix never in device memory.  It is bound by its
operations (~2 * Sq * Skv * D multiply-adds per q head, halved by the
causal mask): bf16 inputs run on the tensor cores (mma.sync), f32 inputs on
a SIMT FMA body that keeps full f32; the note at the top of the .cu file
says what each design does about it.

The plain version `flash_attention_plain` is the reference kernel's
arithmetic (q scaled in f32 before the dot, p rounded to v's dtype before
PV) as an online-softmax walk over kv blocks of `block_kv` keys.

Dispatch is by device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  No fallback on the card.  A meta tensor
reports the launch's cost (kernels/cost.py) and returns empty outputs.

Training: when grad mode is on and q, k or v requires a gradient,
`flash_attention` runs through the autograd Function `_FlashAttention`.
Its forward launches K5 with one more output, each row's log-sum-exp
`lse` (B, Hq, Sq) f32; its backward is `flash_attention_bwd`, the hand
kernel `csrc/flash_attention_bwd.cuh` (K5b: Delta, then dK / dV, then dQ,
recomputing the probabilities from `lse`, sums in a fixed order, no
atomics) on the card and `flash_attention_bwd_plain` on the CPU.  Its bf16
body (`flash_attention_bwd.cu`) runs `wgmma` on 64-row tiles fed by TMA
rings, one block per (key tile, q head) with a kv head's q heads in one
thread-block cluster that sums their dK / dV in a fixed order, and a dQ
block per (query tile, q head); `bwd_plan` fixes the cluster size, the
heads a block walks and which tile order goes heaviest first, and
`q_tiles_of_key_tile` / `key_tiles_of_q_tile` are the two walks.  Its f32
body (`flash_attention_bwd_f32.cu`) is a SIMT walk for the card-vs-CPU
parity runs.  Every other call (serving, calibration, anything under
no_grad or inference_mode) launches K5 with a null `lse`, as before.  The
reference has no backward kernel: it differentiates through its Pallas
kernel under `jax.checkpoint` (repro/models/attention.py:103-109); K5b
recomputes P from `lse`, so the Function saves only q, k, v, out and lse.

A q offset places query row r at position q_offset + r while the keys sit
at 0 .. Skv - 1 (a sequence-parallel rank's chunk of the queries over the
whole key sequence: `models/attention.py`); both kernels, both plain
versions and the meta routes take it.  Under it, a key tile that no query
of the call sees (causal: past q_offset + Sq - 1) gets zero dK / dV.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build, cost, ref

# Launches of the CUDA kernels since the last reset (the plain versions never
# count): the proof that a run went through the kernels.  `launches` counts
# K5, `bwd_launches` K5b (one per backward call: its three kernels on one
# stream).
launches = 0
bwd_launches = 0

_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)   # instantiated in csrc/flash_attention.cu
_INT_MAX = 2**31 - 1


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def _lib():
    fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# K5b's bf16 (wgmma) and f32 (SIMT) bodies build from two sources; the bf16
# entry takes the launch plan (`bwd_plan`) as four more ints.
_BWD_SOURCES = {torch.bfloat16: ("flash_attention_bwd", "flash_attention_bwd_launch", 4),
                torch.float32: ("flash_attention_bwd_f32", "flash_attention_bwd_f32_launch", 0)}


def _bwd_lib(dtype: torch.dtype):
    source, entry, plan_ints = _BWD_SOURCES[dtype]
    fn = getattr(_build.load(source), entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float]
                       + [ctypes.c_int] * plan_ints + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# K5b's bf16 schedule.  Its kernels take tiles of BWD_TILE query rows and
# keys; the dK / dV kernel runs the G = Hq / Hkv q heads of a kv head as
# one thread-block cluster of at most MAX_CLUSTER blocks (the portable
# cluster size).
BWD_TILE = 64
MAX_CLUSTER = 8


class BwdPlan(NamedTuple):
    """K5b's bf16 launch plan, passed to its C entry as ints.

    `cluster` blocks of one cluster share a kv head, each walking
    `heads_per_block` of its q heads in order (head hk G + r H + j for
    block r, j < H), and the cluster sums their dK / dV over r = 0 ..
    cluster - 1 in order.  `kv_reverse` / `q_reverse` launch the dK / dV
    kernel's key tiles and the dQ kernel's query tiles last to first, so the
    heaviest go first."""
    cluster: int
    heads_per_block: int
    kv_reverse: bool
    q_reverse: bool


def q_tiles_of_key_tile(k0: int, Sq: int, Skv: int, causal: bool,
                        window: Optional[int], q_offset: int = 0) -> range:
    """First rows of the query tiles that hold a live entry for the key tile
    at k0, query row r at q_offset + r: the dK / dV kernel's walk
    (csrc/flash_attention_bwd.cuh::q_span computes the same); empty where
    no row sees the tile."""
    T = BWD_TILE
    kmax = min(k0 + T - 1, Skv - 1)
    lo = max(0, k0 - q_offset) if causal else 0
    hi = Sq if window is None else min(Sq, kmax + window - q_offset)
    return range(lo, hi, T)


def key_tiles_of_q_tile(q0: int, Sq: int, Skv: int, causal: bool,
                        window: Optional[int], q_offset: int = 0) -> range:
    """First keys of the key tiles that hold a live entry for the query tile
    at row q0 (position q_offset + q0): the dQ kernel's walk
    (csrc/flash_attention_bwd.cuh::k_span)."""
    T = BWD_TILE
    hi = min(Skv, q_offset + min(q0 + T, Sq)) if causal else Skv
    lo = 0 if window is None else max(0, q_offset + q0 - window + 1)
    if lo >= hi:
        return range(0)
    return range(lo // T * T, hi, T)


def bwd_plan(Sq: int, Skv: int, Hq: int, Hkv: int, causal: bool,
             window: Optional[int], q_offset: int = 0) -> BwdPlan:
    """The cluster is the largest divisor of G = Hq / Hkv up to MAX_CLUSTER;
    a tile order is reversed where its last tile has more work than its
    first."""
    G = Hq // Hkv
    cluster = max(c for c in range(1, min(G, MAX_CLUSTER) + 1) if G % c == 0)
    T = BWD_TILE
    kv = [len(q_tiles_of_key_tile(k0, Sq, Skv, causal, window, q_offset))
          for k0 in (0, (Skv - 1) // T * T)]
    qs = [len(key_tiles_of_q_tile(q0, Sq, Skv, causal, window, q_offset))
          for q0 in (0, (Sq - 1) // T * T)]
    return BwdPlan(cluster, G // cluster, kv[1] > kv[0], qs[1] > qs[0])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0, block_kv: int = 512, return_lse: bool = False):
    """The kernel's function in plain PyTorch (kv blocks of `block_kv` keys,
    the reference kernel's default tile); with `return_lse`, (out, lse) with
    lse (B, Hq, Sq) f32 = m + log(l) of each row, as the kernel writes it."""
    return ref.blockwise_attention_ref(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, block_kv=block_kv,
                                       scale_in_f32=True, return_lse=return_lse)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: Optional[int] = None,
                              q_offset: int = 0):
    """K5b's function in plain PyTorch: (dq, dk, dv) in q's, k's and v's
    dtypes from the forward's out and lse (B, Hq, Sq), query row r at
    q_offset + r.  P = exp(S * scale -
    lse) where the forward's mask is live, else 0; Delta = rowsum(dO * O);
    dS = P * (dP - Delta); P is rounded to v's dtype before dV = P^T dO
    and dS to q's before dQ = scale dS K and dK = scale dS^T Q, as the
    kernel feeds its products.  The G q heads of a kv head sum into its
    dK, dV."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    f32 = torch.float32
    dev = q.device

    def heads(t):    # (B, S, Hq, D) -> (B, Hkv, G, S, D) in f32
        return t.to(f32).reshape(B, t.shape[1], Hkv, G, D).permute(0, 2, 3, 1, 4)

    qf, dof, of = heads(q), heads(dout), heads(out)
    kf, vf = (t.to(f32).permute(0, 2, 1, 3) for t in (k, v))      # (B, Hkv, Skv, D)
    qpos = torch.arange(Sq, device=dev) + q_offset
    kpos = torch.arange(Skv, device=dev)
    live = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        live &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        live &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf) * scale
    lse = lse.to(f32).reshape(B, Hkv, G, Sq)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros((), device=dev))
    delta = (dof * of).sum(dim=-1)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(v.dtype).to(f32), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(q.dtype).to(f32)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * scale
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    return dq, dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash attention operands on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, D) at positions q_offset .. q_offset + Sq
    - 1 over k, v (B, Skv, Hkv, D) at positions 0 .. Skv - 1: out (B, Sq,
    Hq, D) in q's dtype.  Differentiable (K5b) when grad mode is on and an
    input requires grad."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash attention window must be >= 1, got {window}")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash attention q_offset must be an int >= 0, got {q_offset!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, False, q_offset)[0]


def _forward(q, k, v, causal: bool, window: Optional[int], with_lse: bool, q_offset: int = 0):
    """(out, lse or None) on q's device: the kernel or the plain version."""
    if q.device.type == "cpu":
        got = flash_attention_plain(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    return_lse=with_lse)
        return got if with_lse else (got, None)
    if q.device.type == "meta":
        B, Sq, Hq, D = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        c = cost.flash_attention(B, Sq, Skv, Hq, Hkv, D,
                                 pairs=cost.attention_pairs(Sq, Skv, causal, window, q_offset),
                                 elem_bytes=q.element_size(), lse=with_lse)
        if not with_lse:
            return cost.meta_launch("flash_attention", c, (tuple(q.shape), q.dtype)), None
        return cost.meta_launch("flash_attention", c, (tuple(q.shape), q.dtype),
                                ((B, Hq, Sq), torch.float32))
    _on_card(q)
    return _flash_cuda(q, k, v, causal, window, with_lse, q_offset)


def _on_card(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for device {q.device}")


def _kernel_operands(what: str, q, k, v):
    """(B, Sq, Skv, Hq, Hkv, D) of a launch, or raise on what the kernels do
    not take."""
    if q.dtype not in _CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what} kernel takes f32/bf16 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what} kernel: head_dim {D} not in {_HEAD_DIMS}")
    if min(B, Sq, Skv) < 1 or max(q.numel(), k.numel()) > _INT_MAX:
        raise ValueError(f"{what} kernel shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} out of range")
    return B, Sq, Skv, Hq, Hkv, D


def _aligned(*ts):
    """16-byte copies: a tensor that is not contiguous, or a contiguous view
    that starts off a 16-byte boundary, is copied (fresh allocations are
    aligned)."""
    return tuple(t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in ts)


def _flash_cuda(q, k, v, causal: bool, window: Optional[int], with_lse: bool,
                q_offset: int = 0):
    global launches
    B, Sq, Skv, Hq, Hkv, D = _kernel_operands("flash attention", q, k, v)
    q, k, v = _aligned(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if with_lse else None
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, D, int(causal),
                 0 if window is None else int(window), int(q_offset), D ** -0.5,
                 _CODES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError_t {err}")
    launches += 1
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention` from its out and lse (B, Hq, Sq) f32
    and the output's gradient dout: K5b on the card, the plain version on
    the CPU."""
    _check(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (
            q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash attention backward shapes out {tuple(out.shape)}, "
                         f"dout {tuple(dout.shape)}, lse {tuple(lse.shape)} for q "
                         f"{tuple(q.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                         window=window, q_offset=q_offset)
    if q.device.type == "meta":
        B, Sq, Hq, D = q.shape
        Skv, Hkv = k.shape[1], k.shape[2]
        c = cost.flash_attention_bwd(B, Sq, Skv, Hq, Hkv, D,
                                     pairs=cost.attention_pairs(Sq, Skv, causal, window,
                                                                q_offset),
                                     elem_bytes=q.element_size())
        return cost.meta_launch("flash_attention_bwd", c, (tuple(q.shape), q.dtype),
                                (tuple(k.shape), k.dtype), (tuple(v.shape), v.dtype))
    _on_card(q)
    return _bwd_cuda(q, k, v, out, lse, dout, causal, window, q_offset)


def _bwd_cuda(q, k, v, out, lse, dout, causal: bool, window: Optional[int], q_offset: int = 0):
    global bwd_launches
    B, Sq, Skv, Hq, Hkv, D = _kernel_operands("flash attention backward", q, k, v)
    if out.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward: out {out.dtype}, lse {lse.dtype}")
    q, k, v, out, lse, dout = _aligned(q, k, v, out, lse, dout.to(q.dtype))
    # dK / dV uninitialised: both bodies write every key row, zeros where no
    # query of the call sees the key.
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    plan = (map(int, bwd_plan(Sq, Skv, Hq, Hkv, causal, window, q_offset))
            if q.dtype == torch.bfloat16 else ())
    err = _bwd_lib(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, D, int(causal),
                            0 if window is None else int(window), int(q_offset), D ** -0.5,
                            *plan,
                            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention backward launch failed: cudaError_t {err}")
    bwd_launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K5 forward with lse, K5b backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _forward(q, k, v, causal, window, True, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal,
                                         window=ctx.window, q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None
