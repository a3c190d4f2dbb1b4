"""repro_torch.quant: int8 (w8a8) quantization, the paper's deployment
precision as an execution mode (port of repro/quant).

  modes      precision-mode switch ("float" / "w8a8" / "w8a8-calibrated")
             read by kernels/ops.py::linear on every call
  params     QuantTensor + quantize_params: int8-resident weights with
             per-column scales, made once at load
  calibrate  activation observers over calibration batches -> static
             activation-scale table (replays the unpaged `forward`)
  report     per-layer quantization error + end-to-end quality delta

The serving engine does this under
``Engine(cfg, precision="w8a8-calibrated")`` (plain "w8a8" skips the
calibration and quantizes activations per row on the fly):

    from repro_torch import quant
    table = quant.collect_scales(params, cfg, batches)
    qparams = quant.quantize_params(params, cfg=cfg, scales=table)
    with quant.precision("w8a8-calibrated"):
        logits, state = paged_decode_step(qparams, cfg, state, tokens)

`calibrate` and `report` are submodules; the calibration function is
exported as `collect_scales`, as in the reference.
"""

from repro_torch.quant import modes
from repro_torch.quant.calibrate import (
    ScaleTable,
    make_observer,
    synthetic_batches,
)
from repro_torch.quant.calibrate import calibrate as collect_scales
from repro_torch.quant.modes import MODES, get_mode, precision, set_mode
from repro_torch.quant.params import (
    QUANT_KEYS,
    QuantTensor,
    dequantize_params,
    quantize_leaf,
    quantize_params,
    quantized_leaf_count,
    weight_bytes,
)
from repro_torch.quant.report import (
    eval_nll,
    format_error_table,
    layer_error_rows,
    quality_delta,
)

__all__ = [
    "modes",
    "MODES",
    "get_mode",
    "precision",
    "set_mode",
    "QUANT_KEYS",
    "QuantTensor",
    "dequantize_params",
    "quantize_leaf",
    "quantize_params",
    "quantized_leaf_count",
    "weight_bytes",
    "ScaleTable",
    "collect_scales",
    "make_observer",
    "synthetic_batches",
    "eval_nll",
    "format_error_table",
    "layer_error_rows",
    "quality_delta",
]
