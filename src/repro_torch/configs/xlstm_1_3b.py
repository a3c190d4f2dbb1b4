"""xLSTM-1.3B [ssm]: mLSTM blocks with sLSTM every 8th (7:1), d_ff=0 (the
blocks carry their own projections).  [arXiv:2405.04517; same constants as
repro/configs/xlstm_1_3b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,
    group_size=8,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        vocab=256, slstm_every=2, group_size=2, dtype="float32",
    )
