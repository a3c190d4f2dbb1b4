"""Snowflake Arctic-480B [moe]: 128 experts top-2 + dense FFN residual.
[hf:Snowflake/snowflake-arctic-base; same constants as
repro/configs/arctic_480b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True),
    group_size=5,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, group_size=1, dtype="float32",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, dense_residual=True),
    )
