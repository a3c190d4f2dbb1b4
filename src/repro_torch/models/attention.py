"""Attention (port of repro/models/attention.py: `KVCache`,
`_project_qkv`, `blockwise_attention`, `decode_attention`, and the
unpaged, dense-cache, cross and paged branches of `attention`).

GQA/MQA/MHA with split-half RoPE, an optional QKV bias (qwen2.5; added
after the GeMM, as the reference adds it outside its kernel) and optional
qk-norm (qwen3: an RMS norm over head_dim of q and k after the head
reshape, before RoPE).  The unpaged branch (prefill, `forward`,
calibration, the encoder) attends over the sequence itself, or over
`kv_src` for cross-attention (no RoPE, non-causal), through
`blockwise_attention`.  The dense-cache branch (the unpaged
`decode_step`) writes this step's K/V into the (B, S_max, Hkv, D) cache
in place at the device-held scalar `cache_index`, so a CUDA graph
captures it, then attends over the whole cache (`decode_attention`,
plain PyTorch, as the reference's is plain jnp).  Cross-attention at
decode attends over the encoder's precomputed cache; the reference also
projects K/V from the decoder state there and discards them, which the
port skips.  The paged branch writes this step's K/V through the block
tables first and then attends over the pool, so a query attends to its
own key.  The scale is D**-0.5; only the unpaged path applies a logit
softcap, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.serving import kv_cache as kvc

NEG_INF = -2.0e38


class KVCache(NamedTuple):
    """A layer's dense decode cache: k, v (B, S_max, Hkv, D)."""

    k: torch.Tensor
    v: torch.Tensor


def init_attention(gen: torch.Generator, cfg, device, *, cross: bool = False) -> dict:
    """q/k/v/o projections (and QKV biases, q/k norms as `cfg` says); a
    cross-attention layer (`cross`) has no QKV bias, as in the reference."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": layers._init_dense(gen, d, hq * hd, dt, device),
        "wk": layers._init_dense(gen, d, hkv * hd, dt, device),
        "wv": layers._init_dense(gen, d, hkv * hd, dt, device),
        "wo": layers._init_dense(gen, hq * hd, d, dt, device),
    }
    if cfg.qkv_bias and not cross:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=device)
    return p


def _project_qkv(x: torch.Tensor, kv_src: Optional[torch.Tensor], p: dict, cfg,
                 positions: torch.Tensor, *, rope: bool = True):
    """q from x (B, S, d); k, v from `kv_src` (B, Skv, d), or None when
    the caller has them already (cross-attention at decode).  RoPE rotates
    q at `positions` and k at `positions` (Skv == S) or 0..Skv-1."""
    B, S, _ = x.shape
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    q = layers.dense(x, p["wq"], p.get("bq")).reshape(B, S, hq, hd)
    k = v = None
    if kv_src is not None:
        Skv = kv_src.shape[1]
        k = layers.dense(kv_src, p["wk"], p.get("bk")).reshape(B, Skv, hkv, hd)
        v = layers.dense(kv_src, p["wv"], p.get("bv")).reshape(B, Skv, hkv, hd)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"], cfg.norm_eps)
        if k is not None:
            k = layers.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        if k is not None:
            kv_pos = positions if k.shape[1] == S else torch.arange(k.shape[1],
                                                                    device=x.device)
            k = layers.apply_rope(k, kv_pos, cfg.rope_theta)
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
                     index, window: Optional[int] = None,
                     prefix_len: int = 0) -> torch.Tensor:
    """Query-over-whole-cache attention (the dense decode path, and the
    oracle of the paged one): q (B, Sq, Hq, D) at positions index + t
    (`index` a scalar or (B,)), k/v (B, Skv, Hkv, D) at positions
    0..Skv-1; a query sees the keys at or before it, within `window`, and
    every key below `prefix_len`."""
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
    if prefix_len:
        mask |= (kpos < prefix_len)[None, None, :]
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _write_dense(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
                 index: torch.Tensor) -> None:
    """k, v (B, S, Hkv, D) into the cache at positions index .. index + S -
    1, in place; the start clamps to [0, S_max - S], as the reference's
    `dynamic_update_slice` clamps it.  `index` is read on the device."""
    S, S_max = k.shape[1], cache.k.shape[1]
    start = torch.clamp(torch.as_tensor(index, device=k.device).reshape(1).long(),
                        0, S_max - S)
    pos = start + torch.arange(S, device=k.device)
    cache.k.index_copy_(1, pos, k.to(cache.k.dtype))
    cache.v.index_copy_(1, pos, v.to(cache.v.dtype))


def attention(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              prefix_len: int = 0, kv_src: Optional[torch.Tensor] = None,
              cache=None, cache_index: Optional[torch.Tensor] = None,
              block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention sublayer over x (B, S, d); returns (B, S, d).

    Self-attention (kv_src None): with no cache over x itself, causal or
    not, bidirectional over the first `prefix_len` keys (the VLM prefix);
    over a dense `KVCache`, x sits at the scalar position `cache_index` (a
    device tensor) and the cache updates in place; over a paged pool, x
    sits at per-slot first positions `cache_index` (B,) and the pools
    update in place.

    Cross-attention (kv_src given, as `apply_block` passes it): no RoPE,
    non-causal; with `cache` None over kv_src (the encoder's output), with
    a `KVCache` over that cache (the encoder's K/V, computed once)."""
    cross = kv_src is not None
    cached_cross = cross and cache is not None
    q, k, v = _project_qkv(x, None if cached_cross else (kv_src if cross else x),
                           p, cfg, positions, rope=not cross)
    if cross or cache is None:
        if cached_cross:
            k, v = cache.k, cache.v
        out = blockwise_attention(q, k, v, causal=causal and not cross,
                                  window=window, prefix_len=prefix_len,
                                  softcap=cfg.logit_softcap)
    elif isinstance(cache, kvc.PagedKVCache):
        if block_tables is None:
            raise ValueError("a paged cache needs block_tables")
        kvc.write_kv(cache, block_tables, k, v, cache_index)
        out = fd.paged_decode_attention(q, cache, block_tables, cache_index,
                                        window=window)
    elif isinstance(cache, KVCache):
        _write_dense(cache, k, v, cache_index)
        out = decode_attention(q, cache.k, cache.v, index=cache_index,
                               window=window, prefix_len=prefix_len)
    else:
        raise TypeError(f"attention over a {type(cache).__name__}: neither a "
                        f"KVCache nor a paged pool")
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return layers.dense(out, p["wo"])
