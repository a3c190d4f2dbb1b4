"""Plain PyTorch versions of the kernels' arithmetic (port of
repro/kernels/ref.py).

These are the oracles the CUDA kernels are held against, and what the
wrappers run for tensors that lie on the CPU.
"""

from __future__ import annotations

import torch


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> exact int32 (the OpenGeMM P_A = P_B = 8, P_C = 32
    rule).  `torch.matmul` of two int8 tensors would return int8 and wrap,
    and CUDA has no integer matmul, so the product runs in float64 on every
    device: each product and partial sum is an integer of magnitude at most
    K * 127**2, exact in float64 for any K below 5.5e11, so every summation
    order gives the exact int32 result (and BLAS runs it several times
    faster than an int32 matmul on the CPU)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B with the OpenGeMM accumulation rule: int8 x int8
    accumulates in int32; float operands accumulate in float32 (f32 out).
    bf16 products are exact in f32, so upcasting the operands first changes
    no product.  On a CUDA device the f32 product must be exact-f32 FMA
    arithmetic, so TF32 must be off (PyTorch's default); this raises
    rather than switch it off for the whole process."""
    if a.dtype == torch.int8 and b.dtype == torch.int8:
        return _int8_matmul(a, b)
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("gemm_ref needs exact f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    return torch.matmul(a.to(torch.float32), b.to(a.dtype).to(torch.float32))


def gemm_dequant_ref(a: torch.Tensor, b: torch.Tensor, scale_a: torch.Tensor,
                     scale_b: torch.Tensor) -> torch.Tensor:
    """int8 GeMM with per-row / per-column dequantization: f32 out =
    float(A @ B) * scale_a * scale_b, multiplied in that order.  scale_a a
    scalar or (M, 1), scale_b a scalar or (1, N)."""
    return _int8_matmul(a, b).to(torch.float32) * scale_a * scale_b


def quantize_ref(x: torch.Tensor, axis: int = -1):
    """Symmetric per-channel int8 quantization along `axis`: (q, scale) with
    x ~= q * scale, scale = max(absmax, 1e-8) / 127 shaped like x with
    `axis` reduced to 1, codes rounded half to even and clipped to +-127."""
    xf = x.to(torch.float32)
    absmax = torch.amax(torch.abs(xf), dim=axis, keepdim=True)
    scale = torch.clamp_min(absmax, 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


NEG_INF = -2.0e38


def blockwise_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool, window=None, q_offset=0,
                            prefix_len: int = 0, softcap=None,
                            block_kv: int = 512,
                            scale_in_f32: bool = True, return_lse: bool = False):
    """Online-softmax attention over kv blocks of `block_kv` keys: q (B, Sq,
    Hq, D) at positions q_offset + t, k/v (B, Skv, Hkv, D) at 0..Skv-1, GQA
    groups kept explicit.  Masks: causal (bidirectional over a prefix of
    `prefix_len` keys), sliding window, kpos < Skv; the masked score is the
    finite sentinel NEG_INF.  p is rounded to v's dtype before PV; the
    statistics and the accumulator are f32; out in q's dtype.

    `scale_in_f32` scales q by D^-0.5 after the cast to f32, as the flash
    kernel does (kernels/flash_attention.py:41); without it q is scaled in
    its own dtype first, as the reference's XLA blockwise path does
    (models/attention.py:143).

    `return_lse` returns (out, lse) with lse (B, Hq, Sq) f32 = m + log(l)
    of each row, l clamped at 1e-30 as the division clamps it."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    if scale_in_f32:
        qf = q.to(torch.float32) * D ** -0.5
    else:
        qf = (q * torch.tensor(D ** -0.5, dtype=q.dtype).item()).to(torch.float32)
    qf = qf.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)      # (B, H, G, Sq, D)
    qpos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for start in range(0, Skv, block_kv):
        kb = k[:, start:start + block_kv].to(torch.float32)
        vb = v[:, start:start + block_kv]
        s = torch.einsum("bhgqd,bkhd->bhgqk", qf, kb)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kpos = torch.arange(start, start + kb.shape[1], device=dev)
        mask = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            cm = qpos[:, None] >= kpos[None, :]
            if prefix_len:
                cm = cm | (kpos[None, :] < prefix_len)
            mask &= cm
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(torch.float32),
                          vb.to(torch.float32))
        acc = acc * alpha[..., None] + pv
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    out = acc / l[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, Sq)
    return out
