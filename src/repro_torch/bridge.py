"""One-way parameter bridge from the reference's parameter tree.

The reference makes parameters with `jax.random` and stacks each group's
layers on a leading n_groups axis; a test converts that tree to numpy
(`jax.tree_util.tree_map(np.asarray, params)`) and hands it here, so both
packages compute on the same numbers.  This module imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig
from repro_torch.kernels.gemm import aligned_rows


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    # bfloat16 has no numpy dtype of its own: go through float32 (exact).
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtype)


# Leaves the reference makes float32 whatever the model dtype: Mamba's b_dt,
# A_log and D (models/ssm.py:44-47), the mLSTM / sLSTM gate biases b_i and
# b_f (:262-263, :406), and the MoE router (models/moe.py:32).
FLOAT32_LEAVES = frozenset({"b_dt", "A_log", "D", "b_i", "b_f", "router"})


def params_from_reference(params_np: Dict[str, Any], cfg: ArchConfig,
                          device) -> dict:
    """Reference params (nested dict of numpy arrays) -> port params.

    Layer g * group_size + i of the flat list takes slice g of the stacked
    `params_np["blocks"]["sub{i}"]` leaves, whatever they are (projections,
    QKV biases, q/k norms, RMS weights or LayerNorm {"scale", "bias"}
    dicts, the SwiGLU or GELU MLP's matrices and biases, whisper's
    "cross" / "norm_cross", the Mamba / mLSTM / sLSTM leaves, the router
    and the stacked experts (E, d, ff)); encoder block e takes slice e of
    `params_np["encoder_blocks"]`, stacked on encoder_layers.  The
    leaves the reference keeps in float32 at any model dtype
    (`FLOAT32_LEAVES`: the recurrences' biases, A_log, D, the router) stay
    float32; the others take the model dtype.  Layers, an untied "head" and
    paligemma's "projector" are stored as `init_model` stores them (matrix
    rows 16-byte aligned)."""
    dt = cfg.torch_dtype

    def convert(tree, g=None, name=None):
        if isinstance(tree, dict):
            return {k: convert(v, g, k) for k, v in tree.items()}
        a = np.asarray(tree)
        leaf_dt = torch.float32 if name in FLOAT32_LEAVES else dt
        return _tensor(a if g is None else a[g], leaf_dt, device)

    out = {
        "embed": convert(params_np["embed"]),
        "final_norm": convert(params_np["final_norm"]),
        "layers": [blocks.stored(convert(params_np["blocks"][f"sub{i}"], g))
                   for g in range(cfg.n_groups) for i in range(cfg.group_size)],
    }
    if not cfg.tie_embeddings:
        out["head"] = aligned_rows(convert(params_np["head"]))
    if "encoder_blocks" in params_np:       # stacked on encoder_layers
        out["encoder_blocks"] = [blocks.stored(convert(params_np["encoder_blocks"], e))
                                 for e in range(cfg.encoder_layers)]
        out["encoder_norm"] = convert(params_np["encoder_norm"])
    if "projector" in params_np:
        out["projector"] = aligned_rows(convert(params_np["projector"]))
    return out


def param_count(params: dict, *, min_dim: int = 1) -> int:
    """Elements of every tensor of at least `min_dim` dimensions in a port
    parameter dict (min_dim=2 counts the matrices only, as
    `ArchConfig.param_count` does: it leaves out the norm vectors)."""
    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(count(v) for v in tree)
        return tree.numel() if tree.dim() >= min_dim else 0
    return count(params)


def scales_from_reference(table) -> Dict[str, float]:
    """A reference `ScaleTable` (or its `scales` dict) as the plain dict of
    per-tensor activation scales `quant.quantize_params(scales=...)` takes;
    the keys ("blocks.{g}.sub{i}.mixer.wq", ..., "head") are shared."""
    return {k: float(v) for k, v in getattr(table, "scales", table).items()}
