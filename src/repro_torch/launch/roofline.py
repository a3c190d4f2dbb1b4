"""Roofline of one step on one H100 (port of repro/launch/roofline.py).

Three terms per (arch x shape x mesh), in seconds a step, on the card's
published peaks (core/hw.py):

  compute    = FLOPs / peak ops/s at the step's operand width
  memory     = bytes / HBM rate
  collective = collective bytes / link rate: 0 at one card, the only mesh
               the roofline takes until the multi-card dry run (ROADMAP A.2)

The counts come from `launch/step_cost.py` (the reference's from the
compiled HLO through hlo_cost.py).  The reference's `parse_collectives`
and `loop_trip_counts` parse HLO text and have no counterpart: an eager
step's collectives are counted as they dispatch, and its loops run every
iteration.  `model_flops` is the reference's, verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core import hw


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    model_flops_global: float
    chips: int
    peak_memory_bytes: Optional[float] = None
    peak_flops: float = hw.PEAK_FLOPS_BF16
    measured_s: Optional[float] = None      # a measured step, where there is one

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        return 0.0          # one card (`analyze` takes no other)

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (full overlap model)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: remat, attention and padding on top."""
        counted = self.flops_per_device * self.chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops_global / (t * self.chips * self.peak_flops)

    @property
    def measured_mfu(self) -> Optional[float]:
        """Model FLOPs utilization at the measured step time, if any."""
        if not self.measured_s:
            return None
        return self.model_flops_global / (self.measured_s * self.chips * self.peak_flops)

    def row(self) -> Dict[str, object]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound": self.bound,
            "step_time_s": self.step_time_s, "measured_s": self.measured_s,
            "useful_flops_ratio": self.useful_flops_ratio, "mfu": self.mfu,
            "measured_mfu": self.measured_mfu,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "peak_memory_bytes": self.peak_memory_bytes,
        }


def model_flops(cfg, shape: Dict) -> float:
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for inference."""
    n = cfg.active_param_count()
    kind, S, B = shape["kind"], shape["seq_len"], shape["global_batch"]
    if kind == "train":
        return 6.0 * n * S * B
    if kind == "prefill":
        return 2.0 * n * S * B
    # decode: one token per sequence
    return 2.0 * n * 1 * B


def analyze(*, arch: str, shape_name: str, shape: Dict, cfg, cost, mesh_name: str = "single",
            chips: int = 1, peak_memory_bytes: Optional[float] = None,
            measured_s: Optional[float] = None) -> Roofline:
    """The roofline of a counted step (`step_cost.StepCost`), on the peak
    of the config's operand width, with a measured step time where there
    is one.  One card only: the multi-card dry run is ROADMAP A.2."""
    if chips != 1:
        raise NotImplementedError("the port's roofline covers one card; the multi-card dry "
                                  "run is ROADMAP A.2")
    return Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name,
        flops_per_device=float(cost.flops), bytes_per_device=float(cost.bytes_accessed),
        collective_bytes=float(cost.collective_bytes),
        model_flops_global=model_flops(cfg, shape), chips=chips,
        peak_memory_bytes=peak_memory_bytes, peak_flops=hw.peak_ops(cfg.dtype),
        measured_s=measured_s,
    )
