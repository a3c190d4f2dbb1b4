"""The optimizer of the training path (port of repro/optim): AdamW with
clipping, the warmup-cosine schedule and compressed moments, and int8
gradient compression with error feedback."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    BlockQ,
    adamw_init,
    adamw_update,
    global_norm,
    warmup_cosine,
)

__all__ = [
    "AdamWConfig",
    "BlockQ",
    "adamw_init",
    "adamw_update",
    "warmup_cosine",
    "global_norm",
]
