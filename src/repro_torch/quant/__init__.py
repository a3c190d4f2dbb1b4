"""repro_torch.quant: int8 (w8a8) quantization, the paper's deployment
precision as an execution mode (port of repro/quant).

  modes   precision-mode switch ("float" / "w8a8" / "w8a8-calibrated")
          read by kernels/ops.py::linear on every call
  params  QuantTensor + quantize_params: int8-resident weights with
          per-column scales, made once at load

The serving engine does this under ``Engine(cfg, precision="w8a8")``:

    from repro_torch import quant
    qparams = quant.quantize_params(params, cfg=cfg)
    with quant.precision("w8a8"):
        logits, state = paged_decode_step(qparams, cfg, state, tokens)

The reference's `calibrate` and `report` modules replay the unpaged
forward, which the port does not have yet; they come with it.
"""

from repro_torch.quant import modes
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
]
