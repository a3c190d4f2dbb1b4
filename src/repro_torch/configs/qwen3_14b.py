"""Qwen3-14B [dense]: qk-norm, GQA 40/8, head_dim 128, untied 151936
vocab.  [hf:Qwen/Qwen3-8B family; same constants as
repro/configs/qwen3_14b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    group_size=4,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, group_size=1, dtype="float32",
    )
