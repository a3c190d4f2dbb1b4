"""Attention (port of repro/models/attention.py: `_project_qkv`,
`blockwise_attention`, the `decode_attention` oracle, and the unpaged and
paged branches of `attention`).

GQA/MQA/MHA with split-half RoPE, an optional QKV bias (qwen2.5; added
after the GeMM, as the reference adds it outside its kernel) and optional
qk-norm (qwen3: an RMS norm over head_dim of q and k after the head
reshape, before RoPE).  The unpaged branch (prefill, `forward`,
calibration) attends over the sequence itself through
`blockwise_attention`.  The paged branch writes this step's K/V through the
block tables first and then attends over the pool, so a query attends to
its own key.  The scale is D**-0.5; only the unpaged path applies a logit
softcap, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.serving import kv_cache as kvc

NEG_INF = -2.0e38


def init_attention(gen: torch.Generator, cfg, device) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": layers._init_dense(gen, d, hq * hd, dt, device),
        "wk": layers._init_dense(gen, d, hkv * hd, dt, device),
        "wv": layers._init_dense(gen, d, hkv * hd, dt, device),
        "wo": layers._init_dense(gen, hq * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return p


def _project_qkv(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor):
    B, S, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = layers.dense(x, p["wq"], p.get("bq")).reshape(B, S, hq, hd)
    k = layers.dense(x, p["wk"], p.get("bk")).reshape(B, S, hkv, hd)
    v = layers.dense(x, p["wv"], p.get("bv")).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset=0, window: Optional[int] = None,
                        prefix_len: int = 0, block_kv: int = 1024,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B, Sq, Hq, D) over k, v (B, Skv, Hkv, D).

    Where the reference hands the whole sequence to its flash kernel (no q
    offset, no prefix, no softcap: models/attention.py:103-109) this calls
    `kernels.flash_attention`: K5 on the card, its plain version on the
    CPU.  Otherwise it is the reference's XLA blockwise online softmax over
    kv blocks of `block_kv` keys, in plain PyTorch (the reference has no
    Pallas kernel there either)."""
    plain_offset = isinstance(q_offset, int) and q_offset == 0
    if plain_offset and not prefix_len and softcap is None:
        return fa.flash_attention(q, k, v, causal=causal, window=window)
    return ref.blockwise_attention_ref(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        prefix_len=prefix_len, softcap=softcap, block_kv=block_kv,
        scale_in_f32=False)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     index, window: Optional[int] = None) -> torch.Tensor:
    """Query-over-whole-cache attention (the oracle): q (B, Sq, Hq, D) at
    positions index + t, k/v (B, Skv, Hkv, D) at positions 0..Skv-1."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    scale = torch.tensor(D ** -0.5, dtype=q.dtype).item()
    qf = (q * scale).reshape(B, Sq, Hkv, groups, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf.to(torch.float32),
                     k.to(torch.float32))                   # (B, Hkv, G, Sq, Skv)
    idx = torch.as_tensor(index, dtype=torch.int64, device=q.device)
    if idx.dim() == 0:
        idx = idx.expand(B)
    qpos = idx[:, None] + torch.arange(Sq, device=q.device)[None, :]   # (B, Sq)
    kpos = torch.arange(Skv, device=q.device)
    mask = kpos[None, None, :] <= qpos[..., None]
    if window is not None:
        mask &= (qpos[..., None] - kpos[None, None, :]) < window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def attention(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
              window: Optional[int], cache: Optional[kvc.PagedKVCache] = None,
              cache_index: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal self-attention sublayer over x (B, S, d); returns (B, S, d).

    cache None: attend over x itself (prefill / `forward`).  A paged pool:
    x sits at per-slot first positions `cache_index` (B,) and the pools
    update in place.  Cross-attention and the dense `KVCache` decode are
    not ported."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cache is None:
        out = blockwise_attention(q, k, v, causal=True, window=window,
                                  softcap=cfg.logit_softcap)
    elif isinstance(cache, kvc.PagedKVCache):
        if block_tables is None:
            raise ValueError("a paged cache needs block_tables")
        kvc.write_kv(cache, block_tables, k, v, cache_index)
        out = fd.paged_decode_attention(q, cache, block_tables, cache_index,
                                        window=window)
    else:
        raise NotImplementedError(
            f"attention over a {type(cache).__name__} (the dense decode cache) "
            "is not ported; the port serves through the paged pool")
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return layers.dense(out, p["wo"])
