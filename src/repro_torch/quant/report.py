"""Quantization reporting: per-layer weight error + end-to-end quality delta
(port of repro/quant/report.py).

  1. *Where* does precision go?  `layer_error_rows` compares each
     int8-resident weight against its float original (relative Frobenius
     error, max abs error, column-scale spread).  The reference has one row
     per stacked leaf over all groups ("blocks.sub0.mixer.wq"); the port
     keeps its layers in a flat list and has one row per layer
     ("layers.0.mixer.wq"), a difference by design.
  2. *How much* does it cost end to end?  `quality_delta` evaluates the
     same held-out batches through `forward` in float and in a w8a8 mode
     and reports the NLL delta.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List

import numpy as np
import torch

from repro_torch.quant import modes
from repro_torch.quant.calibrate import _tokens_of
from repro_torch.quant.params import QuantTensor, dequantize_leaf


# ---------------------------------------------------------------------------
# per-layer weight error
# ---------------------------------------------------------------------------

def layer_error_rows(params_float, params_quant) -> List[Dict[str, Any]]:
    """One row per int8-resident weight: path, shape, relative Frobenius
    error and max abs error of dequantize(quantize(w)) vs w, the per-column
    scale spread (max / median), and whether it carries a static
    activation scale.  Worst layers first."""
    rows: List[Dict[str, Any]] = []

    def walk(f_tree, q_tree, path):
        if isinstance(q_tree, (dict, list)):
            items = q_tree.items() if isinstance(q_tree, dict) else enumerate(q_tree)
            for k, qv in items:
                fv = None
                if isinstance(f_tree, dict):
                    fv = f_tree.get(k)
                elif isinstance(f_tree, list):
                    fv = f_tree[k]
                walk(fv, qv, path + (str(k),))
            return
        if not isinstance(q_tree, QuantTensor):
            return
        if f_tree is None and path == ("head_q",):
            f_tree = params_float["embed"].t()
        if f_tree is None:
            return
        w = f_tree.detach().to(torch.float32).cpu().numpy()
        deq = dequantize_leaf(q_tree).cpu().numpy()
        scales = q_tree.scale.cpu().numpy()
        denom = float(np.linalg.norm(w)) or 1.0
        rows.append({
            "path": ".".join(path),
            "shape": tuple(q_tree.q.shape),
            "rel_err": float(np.linalg.norm(deq - w)) / denom,
            "max_abs_err": float(np.max(np.abs(deq - w))),
            "scale_spread": float(scales.max() / max(np.median(scales), 1e-12)),
            "calibrated": q_tree.act_scale is not None,
        })

    walk(params_float, params_quant, ())
    rows.sort(key=lambda r: -r["rel_err"])
    return rows


def format_error_table(rows: List[Dict[str, Any]], *, top: int = 0) -> str:
    """Fixed-width table of `layer_error_rows` output (worst layers first)."""
    shown = rows[:top] if top else rows
    width = max([len(r["path"]) for r in shown] + [5])
    lines = [f"{'layer':<{width}}  {'shape':>18}  {'rel_err':>9}  "
             f"{'max_abs':>9}  {'spread':>7}  calib"]
    for r in shown:
        lines.append(
            f"{r['path']:<{width}}  {str(r['shape']):>18}  "
            f"{r['rel_err']:>9.5f}  {r['max_abs_err']:>9.5f}  "
            f"{r['scale_spread']:>7.2f}  {'yes' if r['calibrated'] else 'no'}"
        )
    if top and len(rows) > top:
        lines.append(f"... {len(rows) - top} more layers")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# end-to-end quality delta
# ---------------------------------------------------------------------------

def eval_nll(params, cfg, batches: Iterable, *, mode: str = "float") -> float:
    """Mean next-token NLL over batches (dicts with "tokens" and "labels",
    (B, S) each), through `forward` under a precision mode, on the device
    the parameters live on."""
    from repro_torch.models import model as M   # deferred: models import quant

    device = params["embed"].device
    losses = []
    with torch.no_grad(), modes.precision(mode):
        for b in batches:
            logits = M.forward(params, cfg, {"tokens": _tokens_of(b, device)})
            logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
            del logits
            ll = torch.gather(logp, -1, _tokens_of(b["labels"], device)[..., None])
            losses.append(float(-ll.mean()))
            del logp
    return float(np.mean(losses))


def quality_delta(params_float, params_quant, cfg, batches, *,
                  mode: str = "w8a8") -> Dict[str, float]:
    """Float-vs-quantized NLL on the same batches: the end-to-end cost of
    the int8 deployment.  `batches`: dicts with "tokens" and "labels"."""
    batches = list(batches)
    f = eval_nll(params_float, cfg, batches, mode="float")
    q = eval_nll(params_quant, cfg, batches, mode=mode)
    return {
        "float_nll": f,
        "quant_nll": q,
        "delta_nll": q - f,
        "rel_delta": (q - f) / max(abs(f), 1e-12),
        "mode": mode,
    }
