"""Architecture configuration (port of repro/models/config.py).

A copy, not an import: the reference module imports `jax.numpy`.  The
fields of the decoder families are carried: dense (qk-norm, QKV bias,
sliding windows, the SwiGLU or GELU MLP, RMS or LayerNorm, tied or untied
heads), moe (`MoEConfig`, `moe_every`), hybrid (`attn_every`,
`MambaConfig`) and ssm (`slstm_every`).  `layer_kinds()`,
`param_count()` and `active_param_count()` are copied verbatim, so the
layer pattern and the parameter counts agree with the reference exactly,
including its mLSTM term, which counts the q/k/v matrices as di x hd
where the weights are di x di (xlstm-1.3b: 1.85 B counted, 3.705 B held),
and its encoder term, which counts each encoder layer's attention and MLP
and one cross-attention per encoder layer.  The encoder-decoder (whisper:
`encoder_layers`, `encoder_seq`) and VLM (paligemma: `prefix_len`)
families run through the unpaged decode path; the paged engine refuses
them, as the reference's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # Snowflake Arctic: dense FFN residual in parallel with the MoE FFN.
    dense_residual: bool = False


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
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

    # mixture of experts; MoE replaces the dense FFN on every `moe_every`-th
    # layer of a group (Jamba: 2 -> alternate layers; DBRX/Arctic: 1 -> all).
    moe: Optional[MoEConfig] = None
    moe_every: int = 1

    # hybrid (jamba): one attention layer per `attn_every` layers, rest Mamba
    attn_every: int = 0
    mamba: Optional[MambaConfig] = None

    # ssm (xlstm): mLSTM blocks with one sLSTM per `slstm_every`
    slstm_every: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                    # frontend-stub sequence length

    # vlm prefix (paligemma)
    prefix_len: int = 0                     # image-patch prefix (stub embeds)

    # norms
    norm: str = "rms"                       # rms | ln (encoders)
    norm_eps: float = 1e-6
    post_block_norm: bool = False           # gemma-style post norms
    tie_embeddings: bool = False

    # numerics
    dtype: str = "bfloat16"
    remat: bool = True                      # activation checkpointing per group (training)

    # layer grouping (the reference scans groups; the port keeps a flat list
    # whose layer g * group_size + i has kind layer_kinds()[i])
    group_size: int = 1

    def __post_init__(self):
        if self.n_heads % max(1, self.n_kv_heads):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.family == "hybrid" and not (self.attn_every and self.mamba):
            raise ValueError("hybrid needs attn_every and mamba config")
        if self.local_ratio and not self.local_window:
            raise ValueError("local_ratio needs local_window")
        if self.family not in FAMILIES:
            raise ValueError(f"{self.name}: unknown family {self.family!r}")
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
        """Sub-layer kinds inside one group, in execution order:
        'attn' | 'attn_local' | 'mamba' | 'mlstm' | 'slstm'."""
        kinds = []
        for i in range(self.group_size):
            if self.family in ("ssm",):
                # xLSTM: one sLSTM per slstm_every, rest mLSTM.
                if self.slstm_every and (i + 1) % self.slstm_every == 0:
                    kinds.append("slstm")
                else:
                    kinds.append("mlstm")
            elif self.family == "hybrid":
                # Jamba: attention once per attn_every, rest Mamba.
                kinds.append("attn" if (i + 1) % self.attn_every == 0 else "mamba")
            elif self.local_ratio:
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
        moe = 0
        if self.moe:
            moe = (
                d * self.moe.num_experts
                + self.moe.num_experts * 3 * d * self.moe.d_ff_expert
            )
            if self.moe.dense_residual:
                moe += ffn

        def ffn_params(layer_idx: int) -> int:
            if self.moe and (layer_idx + 1) % self.moe_every == 0:
                return moe
            return ffn if self.d_ff else 0

        mixer = {}
        mixer["attn"] = mixer["attn_local"] = attn
        if self.mamba:
            di = self.mamba.expand * d
            dtr = self.mamba.resolved_dt_rank(d)
            mixer["mamba"] = (
                d * 2 * di + self.mamba.d_conv * di
                + di * (dtr + 2 * self.mamba.d_state) + dtr * di
                + di * self.mamba.d_state + di + di * d
            )
        if self.family == "ssm":
            # xLSTM blocks: in/out projections + gates, no separate FFN.
            di = 2 * d
            mixer["mlstm"] = d * 2 * di + 4 * di * hd + di * d + 3 * di
            mixer["slstm"] = 4 * d * d + int(8 / 3 * d * d) * 2
        kinds = self.layer_kinds()
        per_group = sum(
            mixer[k] + (ffn_params(i) if k not in ("mlstm", "slstm") else 0)
            for i, k in enumerate(kinds)
        )
        n += self.n_groups * per_group
        if self.encoder_layers:
            n += self.encoder_layers * (attn + ffn + attn)  # enc + cross-attn
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        expert_p = self.moe.num_experts * 3 * self.d_model * self.moe.d_ff_expert
        active_p = self.moe.top_k * 3 * self.d_model * self.moe.d_ff_expert
        n_moe_layers = self.n_layers // self.moe_every
        return total - n_moe_layers * (expert_p - active_p)
