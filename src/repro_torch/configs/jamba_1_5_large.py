"""Jamba-1.5-Large-398B [hybrid]: Mamba+attention 1:7 interleave, MoE 16e
top-2, GQA kv=8.  [arXiv:2403.19887; same constants as
repro/configs/jamba_1_5_large.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MambaConfig, MoEConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    attn_every=8,                   # 1 attention layer per 8 (1:7 with Mamba)
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    moe_every=2,                    # MoE on alternate layers (Jamba)
    group_size=8,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, attn_every=4, group_size=4, dtype="float32",
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128), moe_every=2,
    )
