"""BERT-base: the paper's Table-2 transformer benchmark (encoder-only),
modeled as a dense LM backbone served causally, as the reference serves
it: LayerNorm, the GELU MLP with biases, MHA 12/12 at head_dim 64, untied
30522 vocab.  [same constants as repro/configs/bert_base.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="bert-base", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=30522, head_dim=64,
    mlp_variant="gelu", norm="ln",
    group_size=2,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, group_size=1, dtype="float32",
    )
