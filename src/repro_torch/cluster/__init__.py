"""Multi-replica serving: replica pool + router + prefix cache + traffic
(port of repro/cluster).

The cluster layer scales the single-``Engine`` serving stack the same way
the paper scales a single PE: keep every compute unit fed and share the
memory pool.  Five modules:

  replica.py      — N engines, thread-per-replica, each on its own CUDA
                    stream; device-pinned when there is more than one card
  router.py       — bounded admission + shed policy + pure routing
                    policies (round-robin / least-loaded / prefix-affinity)
  prefix_cache.py — radix-tree prompt-prefix cache over the refcounted KV
                    block pool (serving/kv_cache.py)
  traffic.py      — seeded workload generation + trace record/replay
  metrics.py      — cluster-wide aggregation (tail TTFT, occupancy,
                    prefix hit rate, shed rate)

Everything is lazy: importing ``repro_torch.cluster`` pulls in no engine
or model module until a symbol is touched.
"""

_LAZY = {
    "ClusterMetrics": ("repro_torch.cluster.metrics", "ClusterMetrics"),
    "ClusterRequest": ("repro_torch.cluster.replica", "ClusterRequest"),
    "POLICIES": ("repro_torch.cluster.router", "POLICIES"),
    "PrefixCache": ("repro_torch.cluster.prefix_cache", "PrefixCache"),
    "Replica": ("repro_torch.cluster.replica", "Replica"),
    "ReplicaPool": ("repro_torch.cluster.replica", "ReplicaPool"),
    "ReplicaView": ("repro_torch.cluster.replica", "ReplicaView"),
    "Router": ("repro_torch.cluster.router", "Router"),
    "TenantStats": ("repro_torch.cluster.router", "TenantStats"),
    "Trace": ("repro_torch.cluster.traffic", "Trace"),
    "TraceItem": ("repro_torch.cluster.traffic", "TraceItem"),
    "TrafficConfig": ("repro_torch.cluster.traffic", "TrafficConfig"),
    "aggregate": ("repro_torch.cluster.metrics", "aggregate"),
    "generate": ("repro_torch.cluster.traffic", "generate"),
    "mixed_traffic": ("repro_torch.cluster.traffic", "mixed_traffic"),
    "pick_least_loaded": ("repro_torch.cluster.router", "pick_least_loaded"),
    "pick_prefix_affinity": ("repro_torch.cluster.router", "pick_prefix_affinity"),
    "pick_round_robin": ("repro_torch.cluster.router", "pick_round_robin"),
    "replay": ("repro_torch.cluster.traffic", "replay"),
    "shared_system_prompt": ("repro_torch.cluster.traffic", "shared_system_prompt"),
    "slo_snapshot": ("repro_torch.cluster.metrics", "slo_snapshot"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'repro_torch.cluster' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
