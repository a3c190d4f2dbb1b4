"""Whisper-medium [audio]: 24 + 24 layer encoder-decoder, d_model 1024, 16
heads (kv 16: MHA) at head_dim 64, the GELU MLP, LayerNorm, untied 51865
vocab.  The conv frontend is a stub: the encoder takes precomputed
1500-frame embeddings.  [arXiv:2212.04356; same constants as
repro/configs/whisper_medium.py]"""
import dataclasses

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, head_dim=64,
    mlp_variant="gelu", norm="ln",
    encoder_layers=24, encoder_seq=1500,
    group_size=4,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, encoder_layers=2, encoder_seq=16,
        group_size=1, dtype="float32",
    )
