"""DBRX-132B [moe]: 16 experts top-4 fine-grained, GQA kv=8.
[hf:databricks/dbrx-base; same constants as repro/configs/dbrx_132b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352, head_dim=128,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    group_size=4,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, group_size=1, dtype="float32",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
    )
