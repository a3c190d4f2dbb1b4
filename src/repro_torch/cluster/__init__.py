"""Cluster layer of the port (of repro/cluster): so far only the
block-granular prompt-prefix cache.  The replicas, router, traffic and
metrics modules are not ported yet."""

from repro_torch.cluster.prefix_cache import PrefixCache

__all__ = ["PrefixCache"]
