"""Qwen2.5-14B [dense]: GQA 40/8, QKV bias, 48 layers, untied 152064
vocab.  [hf:Qwen/Qwen2.5 family; same constants as
repro/configs/qwen2_5_14b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1e6,
    group_size=4,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, group_size=1, dtype="float32",
    )
