"""Gemma3-1B [dense]: MQA (kv=1), 5:1 local:global sliding window, tied
embeddings, 262k vocab.  [hf:google/gemma-3-1b-pt; same constants as
repro/configs/gemma3_1b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    local_window=512, local_ratio=5, rope_theta=1e6,
    post_block_norm=True, tie_embeddings=True,
    # 2 groups of 13 with globals at in-group positions 5 and 11: 4 global
    # layers in 26, the reference's layer pattern (not HF's exact phase).
    group_size=13,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, local_window=8, group_size=6, dtype="float32",
    )
