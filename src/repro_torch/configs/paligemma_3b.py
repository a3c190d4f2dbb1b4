"""PaliGemma-3B [vlm]: a SigLIP patch prefix (stub embeddings of width
1152, projected) before a gemma decoder: 18 layers, d_model 2048, MQA 8/1
at head_dim 256, tied 257216 vocab; the 256 patch tokens attend
bidirectionally (prefix-LM).  [arXiv:2407.07726; same constants as
repro/configs/paligemma_3b.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, head_dim=256,
    tie_embeddings=True,
    prefix_len=256,                 # 16x16 SigLIP patches at 224px
    group_size=3,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, prefix_len=4, group_size=1, dtype="float32",
    )
