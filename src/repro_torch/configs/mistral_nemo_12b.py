"""Mistral-Nemo-12B [dense]: GQA 32/8 at head_dim 128, so the q width
(4096) is not d_model (5120); 128k context, untied 131072 vocab.
[hf:mistralai/Mistral-Nemo-Base-2407; same constants as
repro/configs/mistral_nemo_12b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1e6,
    group_size=4,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, group_size=1, dtype="float32",
    )
