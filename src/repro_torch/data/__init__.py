"""Training data (port of repro/data): synthetic LM batches and a device
prefetcher."""

from repro_torch.data.pipeline import Prefetcher, SyntheticLMData, to_device

__all__ = ["SyntheticLMData", "Prefetcher", "to_device"]
