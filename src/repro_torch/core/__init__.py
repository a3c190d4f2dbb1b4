"""OpenGeMM core: the paper's contribution as a composable library (port of
repro/core, which imports no JAX; the port keeps its own copy).

  dataflow      - 6-loop GeMM dataflow, tiling math, utilization definitions
  generator     - OpenGeMMConfig design-time parameterization (paper Table 1)
  simulator     - cycle model of the platform + Fig. 5 ablation harness
  workloads     - im2col GeMM extraction for the paper's four DNNs
  gemmini_model - Gemmini baseline for the Fig. 7 comparison
  hw            - the H100's published peaks (the reference's holds a TPU's)

The reference's `TpuGemmSpec` has no counterpart: a design point becomes a
launch plan of the hand kernels through `OpenGeMMConfig.launch_spec`.
"""

from repro_torch.core.dataflow import (
    Dataflow,
    GemmShape,
    SpatialUnrolling,
    TemporalUnrolling,
    aggregate_utilization,
)
from repro_torch.core.generator import CASE_STUDY, OpenGeMMConfig
from repro_torch.core.simulator import (
    OpenGeMMSimulator,
    WorkloadReport,
    ablation_architectures,
    fig5_median_utilizations,
    random_fig5_shapes,
)

__all__ = [
    "Dataflow",
    "GemmShape",
    "SpatialUnrolling",
    "TemporalUnrolling",
    "aggregate_utilization",
    "OpenGeMMConfig",
    "CASE_STUDY",
    "OpenGeMMSimulator",
    "WorkloadReport",
    "ablation_architectures",
    "fig5_median_utilizations",
    "random_fig5_shapes",
]
