"""Live utilization gauges: achieved throughput vs the analytic bound (port
of repro/obs/mfu.py, on the H100's peaks).

The paper's headline number is *measured utilization* — how close the
generated instance runs to its cycle model's prediction (81.89-99.34%
across workloads, Table 2).  This module is that comparison lifted to the
serving stack, computed live per tick instead of after the fact:

  * **utilization** (per phase) = modeled step time / measured step time.
    The modeled time is the analytic bound from the same model the
    autotuner ranks with: the H100 roofline model of the hand kernels'
    launches (`tuning/model.py::predict` summed over the step's projection
    GeMMs at the hand rule's plans, launch overhead included) vs the
    roofline terms of the whole step (compute at the H100's peak FLOP/s,
    weights streamed once per step at its HBM rate), whichever binds.  This is the paper's temporal-utilization analogue: 1.0 means
    the step ran exactly as fast as the model says the hardware allows.
  * **mfu** (per phase) = useful model FLOPs / (measured time x peak
    FLOP/s), with useful FLOPs = 2 x active params x committed tokens
    (`launch/roofline.py::model_flops`' inference formula) — the
    cross-paper-comparable Model FLOPs Utilization figure.

Phases are accounted separately (prefill / decode / verify) because their
bounds differ by orders of magnitude: a decode step is weight-bandwidth
bound at M=slots rows, a prefill chunk amortizes the same weight traffic
over C token rows, and a speculative verify step runs M=slots x (K+1).

The gauges are a few float adds per tick (the bound is memoized per
(phase, rows)) — cheap enough to stay on by default; `EngineMetrics` and
`ClusterMetrics` surface them in `summary()`.

NOTE on absolute values: the constants are the H100 SXM's published peaks
(989 TFLOP/s bf16, 3.35 TB/s).  A step measured on the CPU (the plain
versions) reads a utilization of a fraction of a percent against them; only
a run on the card gives a device figure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

from repro_torch.core import hw
from repro_torch.launch.roofline import model_flops
from repro_torch.tuning import model as tmodel
from repro_torch.tuning.candidates import GemmShape, rule_spec

PEAK_FLOPS_BF16 = hw.PEAK_FLOPS_BF16     # H100 SXM, dense (core/hw.py)
HBM_BW = hw.HBM_BW

PHASES = ("prefill", "decode", "verify")

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


@dataclasses.dataclass
class PhaseStat:
    """Accumulated measurements for one serving phase."""

    time_s: float = 0.0      # measured wall time in this phase's steps
    flops: float = 0.0       # useful model FLOPs (committed tokens)
    tokens: int = 0          # committed tokens
    rows: int = 0            # executed GeMM rows (padding slots included)
    steps: int = 0
    bound_s: float = 0.0     # accumulated analytic lower-bound time

    def merge(self, other: "PhaseStat") -> None:
        self.time_s += other.time_s
        self.flops += other.flops
        self.tokens += other.tokens
        self.rows += other.rows
        self.steps += other.steps
        self.bound_s += other.bound_s


class MfuMeter:
    """Per-phase utilization/MFU accounting for one model config."""

    def __init__(self, cfg, *, peak_flops: float = PEAK_FLOPS_BF16,
                 hbm_bw: float = HBM_BW):
        self.arch = cfg.name
        self.dtype = cfg.dtype
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        active = cfg.active_param_count()
        # one committed token: the inference formula of launch/roofline.py
        self.flops_per_token = model_flops(
            cfg, {"kind": "decode", "seq_len": 1, "global_batch": 1})
        self.param_bytes = active * _DTYPE_BYTES.get(cfg.dtype, 2)
        self.phases: Dict[str, PhaseStat] = {p: PhaseStat() for p in PHASES}
        self._cfg = cfg
        self._bound_cache: Dict[int, float] = {}

    # -- recording -----------------------------------------------------------

    def note(self, phase: str, *, tokens: int, rows: int, time_s: float
             ) -> None:
        """Account one step: `tokens` committed, `rows` GeMM rows executed
        (padding slots included), `time_s` measured wall time."""
        st = self.phases[phase]
        st.time_s += time_s
        st.tokens += tokens
        st.rows += rows
        st.steps += 1
        st.flops += tokens * self.flops_per_token
        st.bound_s += self.step_bound_s(rows)

    def step_bound_s(self, rows: int) -> float:
        """Analytic lower-bound time for one step executing `rows` token
        rows: max of the roofline terms (compute at peak, weights streamed
        once at HBM bandwidth) and the cycle model's predicted time for the
        step's dense-projection GeMMs.  Memoized — the engine only ever
        executes a handful of distinct row counts (slots, chunk buckets,
        verify widths)."""
        cached = self._bound_cache.get(rows)
        if cached is not None:
            return cached
        compute_s = rows * self.flops_per_token / self.peak_flops
        memory_s = self.param_bytes / self.hbm_bw
        bound = max(compute_s, memory_s, self._gemm_step_s(rows))
        self._bound_cache[rows] = bound
        return bound

    def _gemm_step_s(self, rows: int) -> float:
        """Modeled time (tuning/model.py) of the step's per-layer projection
        GeMMs at M=rows, each at the hand rule's plan, launch overhead
        included: the same model the autotuner ranks plans with.  Covers
        only the dense projections and the head (MoE experts and the
        recurrences are outside it); the roofline terms in step_bound_s
        cover the rest, and the bound takes the max.  Nothing here may
        fail quietly: a bound that silently read 0 would hide a fault."""
        cfg = self._cfg
        d, ff, vocab = cfg.d_model, cfg.d_ff, cfg.vocab
        hd = cfg.resolved_head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        shapes = []
        for kind in cfg.layer_kinds():
            if kind in ("attn", "attn_local"):
                shapes += [
                    GemmShape(rows, d, hq * hd),   # q
                    GemmShape(rows, d, hkv * hd),  # k
                    GemmShape(rows, d, hkv * hd),  # v
                    GemmShape(rows, hq * hd, d),   # o
                ]
            if cfg.moe is None and ff:        # xLSTM's blocks have no FFN
                up = [GemmShape(rows, d, ff)] * (2 if cfg.mlp_variant == "swiglu" else 1)
                shapes += up + [GemmShape(rows, ff, d)]

        def t(shape, kmajor=False):
            spec = rule_spec(shape, self.dtype, kmajor=kmajor)
            return tmodel.predict(spec, shape, self.dtype, kmajor=kmajor).time_s

        per_group = sum(t(s) for s in shapes)
        head = t(GemmShape(rows, d, vocab), kmajor=cfg.tie_embeddings)
        return cfg.n_groups * per_group + head

    # -- reporting -----------------------------------------------------------

    def utilization(self, phase: str) -> float:
        """Modeled time / measured time for this phase (the paper's
        temporal-utilization analogue; 0.0 before any step ran)."""
        st = self.phases[phase]
        return st.bound_s / st.time_s if st.time_s > 0 else 0.0

    def mfu(self, phase: str) -> float:
        """Useful model FLOPs / (measured time x peak FLOP/s)."""
        st = self.phases[phase]
        return (st.flops / (st.time_s * self.peak_flops)
                if st.time_s > 0 else 0.0)

    def active_phases(self) -> Iterable[str]:
        return [p for p in PHASES if self.phases[p].steps]

    def merge(self, other: "MfuMeter") -> "MfuMeter":
        """Fold another meter's phase stats into self (cluster aggregation
        over same-config replicas); returns self."""
        for p in PHASES:
            self.phases[p].merge(other.phases[p])
        return self

    @classmethod
    def merged(cls, meters: Iterable["MfuMeter"]) -> Optional["MfuMeter"]:
        meters = [m for m in meters if m is not None]
        if not meters:
            return None
        out = cls(meters[0]._cfg, peak_flops=meters[0].peak_flops,
                  hbm_bw=meters[0].hbm_bw)
        for m in meters:
            out.merge(m)
        return out

    def summary(self) -> str:
        """Compact per-phase fragment for EngineMetrics.summary():
        ``util[decode]=0.12% mfu[decode]=0.03% ...`` (active phases only).
        """
        parts = []
        for p in self.active_phases():
            parts.append(f"util[{p}]={self.utilization(p):.2%} "
                         f"mfu[{p}]={self.mfu(p):.2%}")
        return " ".join(parts)

    def as_dict(self) -> dict:
        return {
            "arch": self.arch,
            "dtype": self.dtype,
            "peak_flops": self.peak_flops,
            "hbm_bw": self.hbm_bw,
            "phases": {
                p: {
                    "time_s": st.time_s,
                    "flops": st.flops,
                    "tokens": st.tokens,
                    "rows": st.rows,
                    "steps": st.steps,
                    "bound_s": st.bound_s,
                    "utilization": self.utilization(p),
                    "mfu": self.mfu(p),
                }
                for p, st in self.phases.items() if st.steps
            },
        }
