"""Serving host stack of the port: paged KV cache, prefill planning,
requests and priority classes, the scheduler, speculative drafting and the
engine.  The engine itself is imported from `serving.engine`."""

from repro_torch.serving.request import (GREEDY, PRIORITIES, RequestSpec,
                                         SamplingParams, priority_rank)
from repro_torch.serving.speculative import (NgramDrafter, SpecConfig,
                                             bucket_for, coerce_spec,
                                             verify_buckets)

__all__ = ["GREEDY", "NgramDrafter", "PRIORITIES", "RequestSpec",
           "SamplingParams", "SpecConfig", "bucket_for", "coerce_spec",
           "priority_rank", "verify_buckets"]
