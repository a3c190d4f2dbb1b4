"""Architecture configuration (port of repro/models/config.py).

A copy, not an import: the reference module imports `jax.numpy`.  Only the
fields of the dense family are carried (qk-norm, QKV bias, sliding windows,
the SwiGLU or GELU MLP, RMS or LayerNorm, tied or untied heads);
`layer_kinds()` and `param_count()` are copied verbatim for that family so
the layer pattern (gemma3-1b: 13-layer groups, globals where (i+1) % 6 ==
0) and the parameter count agree with the reference exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense (only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads

    # attention flavor
    qk_norm: bool = False                   # qwen3: RMS norm of q and k per head
    qkv_bias: bool = False                  # qwen2.5
    rope_theta: float = 10_000.0
    local_window: Optional[int] = None      # sliding-window size
    local_ratio: int = 0                    # gemma3: N local layers per global
    logit_softcap: Optional[float] = None   # attention-score tanh cap (unpaged path)

    # ffn flavor
    mlp_variant: str = "swiglu"             # swiglu | gelu (encoders)

    # norms
    norm: str = "rms"                       # rms | ln (encoders)
    norm_eps: float = 1e-6
    post_block_norm: bool = False           # gemma-style post norms
    tie_embeddings: bool = False

    # numerics
    dtype: str = "bfloat16"

    # layer grouping (the reference scans groups; the port keeps a flat list
    # whose layer g * group_size + i has kind layer_kinds()[i])
    group_size: int = 1

    def __post_init__(self):
        if self.n_heads % max(1, self.n_kv_heads):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.local_ratio and not self.local_window:
            raise ValueError("local_ratio needs local_window")
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: only the dense family is ported, not {self.family!r}")
        if self.mlp_variant not in ("swiglu", "gelu"):
            raise ValueError(f"{self.name}: unknown mlp_variant {self.mlp_variant!r}")
        if self.norm not in ("rms", "ln"):
            raise ValueError(f"{self.name}: unknown norm {self.norm!r}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def n_groups(self) -> int:
        if self.n_layers % self.group_size:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"group_size {self.group_size}"
            )
        return self.n_layers // self.group_size

    def layer_kinds(self) -> Tuple[str, ...]:
        """Sub-layer kinds inside one group, in execution order."""
        kinds = []
        for i in range(self.group_size):
            if self.local_ratio:
                # Gemma3: local_ratio local layers then one global.
                kinds.append(
                    "attn" if (i + 1) % (self.local_ratio + 1) == 0 else "attn_local"
                )
            else:
                kinds.append("attn")
        return tuple(kinds)

    def all_layer_kinds(self) -> Tuple[str, ...]:
        """Kind of every layer of the flat stack, group after group."""
        return self.layer_kinds() * self.n_groups

    def param_count(self) -> int:
        """Parameter count (embeddings + blocks), as the reference counts it."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        ffn = 3 * d * self.d_ff if self.mlp_variant == "swiglu" else 2 * d * self.d_ff
        per_group = sum(attn + (ffn if self.d_ff else 0)
                        for _ in self.layer_kinds())
        return n + self.n_groups * per_group
