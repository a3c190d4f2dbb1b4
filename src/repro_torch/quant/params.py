"""Int8-resident model parameters: quantize weights once at load time (port
of repro/quant/params.py).

`quantize_params` replaces every eligible projection matrix with a
`QuantTensor`: int8 codes plus float32 per-output-column scales, so weight
memory drops and the serving hot path never re-quantizes a weight:
`ops.linear` sees the `QuantTensor` and goes straight to the int8 GeMM with
the stored scales.

Eligibility is by leaf name (`QUANT_KEYS`), with one rule beside it, as in
the reference: a dict with a "router" (an MoE FFN) stays float whole.  Its
experts reuse the MLP leaf names but run through the per-expert float
GeMMs (models/moe.py), not `ops.linear`; Arctic's dense residual inside it
stays float too, and the router itself is no `QUANT_KEYS` name (under
w8a8 it takes the int8 path on the fly).  Embeddings, norms, biases, convs
and the recurrences' gate / dt projections stay float.

Layout: `QuantTensor.q` has the reference's logical (K, N) shape, but it is
the `.t()` view of an (N, K) tensor, so each output column's K codes are
contiguous and the int8 GeMM kernel streams them as 16-byte loads.  The
codes and scales are bit-identical to quantizing the (K, N) matrix along
axis -2, as the reference does.

The port keeps its layers in a flat list (the reference stacks each
group's layers on a leading axis), so `quantized_leaf_count` counts every
layer's matrices: (reference count - 1) * n_groups + 1, the last one the
head ("head_q" of a tied model, "head" of an untied one); whisper's
encoder blocks count one per block and matrix, paligemma's "projector"
one.  Biases and norm vectors stay float.

Calibrated activation scales (quant/calibrate.py, keys
"blocks.{g}.sub{i}.mixer.wq", ..., "head") ride on `QuantTensor.act_scale`
and are read only in "w8a8-calibrated" mode.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.kernels import ref

# Leaf names that quantize well and sit on the serving hot path.
QUANT_KEYS = frozenset({
    "wq", "wk", "wv", "wo",                 # attention projections
    "w_gate", "w_up", "w_down",             # MLP (swiglu / gelu) + mLSTM up/down
    "w_in", "w_out",                        # mamba in/out projections
    "w_q", "w_k", "w_v",                    # mLSTM q/k/v projections
    "w_ff_up", "w_ff_down",                 # sLSTM GLU feed-forward
    "head",                                 # untied LM head
    "projector",                            # VLM vision projector
})


class QuantTensor(NamedTuple):
    """An int8-resident weight: q int8 (K, N) (a view of an (N, K) tensor),
    scale f32 (1, N), and optionally a static per-tensor activation scale
    (consumed only in "w8a8-calibrated" mode)."""

    q: torch.Tensor
    scale: torch.Tensor
    act_scale: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        n = self.q.numel() + 4 * self.scale.numel()
        if self.act_scale is not None:
            n += 4 * self.act_scale.numel()
        return n


def quantize_leaf(w: torch.Tensor, act_scale=None) -> QuantTensor:
    """Per-output-column symmetric int8 quantization of one weight matrix
    w (K, N) (K is the contraction axis, matching y = x @ w)."""
    if w.dim() != 2:
        raise ValueError(f"quantize_leaf takes a (K, N) matrix, got {tuple(w.shape)}")
    w_nk = w.to(torch.float32).t().contiguous()          # (N, K), K contiguous
    q, s = ref.quantize_ref(w_nk, -1)                    # (N, K), (N, 1)
    if act_scale is not None:
        act_scale = torch.as_tensor(act_scale, dtype=torch.float32, device=w.device)
    return QuantTensor(q=q.t(), scale=s.reshape(1, -1), act_scale=act_scale)


def dequantize_leaf(t: QuantTensor) -> torch.Tensor:
    return ref.dequantize_ref(t.q, t.scale)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(tree, path)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _act_scale(table: Dict[str, float], path: tuple, cfg) -> Optional[float]:
    """The static activation scale of the leaf at `path`, or None, under
    the reference's key for it.

    Layer L of the flat list is sub{L % group_size} of group
    L // group_size.  As the reference's stacked leaves are calibrated for
    all groups or none (params.py:77-90), a layer leaf takes its scale only
    if every group has an entry for its sub{i} path.  Encoder block e is
    slice e of the reference's "encoder_blocks" stack, which takes one
    entry for all of them ("encoder_blocks.mixer.wq").  Any other leaf
    ("projector", "head") is keyed by its path."""
    if path[0] == "encoder_blocks":
        return table.get(".".join(map(str, (path[0],) + path[2:])))
    if path[0] != "layers":
        return table.get(".".join(map(str, path)))
    gs = cfg.group_size
    sub = f"sub{path[1] % gs}." + ".".join(map(str, path[2:]))
    vals = [table.get(f"blocks.{g}.{sub}") for g in range(cfg.n_groups)]
    return None if any(v is None for v in vals) else vals[path[1] // gs]


def quantize_params(params: Dict[str, Any], *, cfg=None,
                    scales=None) -> Dict[str, Any]:
    """A copy of `params` with every `QUANT_KEYS` weight int8-resident.

    `scales` is an optional `calibrate.ScaleTable` (or a plain dict of
    per-tensor activation scales, from either package); matching entries
    are attached as static `act_scale`s for "w8a8-calibrated" mode.

    With `cfg.tie_embeddings`, an int8 copy of the
    transposed embedding table is added under "head_q", so the tied head is
    not re-quantized every step; the float table stays (the embedding
    lookup gathers from it)."""
    table = getattr(scales, "scales", scales) or {}
    if table and cfg is None:
        raise ValueError("quantize_params needs cfg to place calibrated scales")

    def walk(tree, path, keys):
        if isinstance(tree, dict):
            if "router" in tree:                 # MoE: the experts stay float
                keys = frozenset()
            return {k: walk(v, path + (k,), keys) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (i,), keys) for i, v in enumerate(tree)]
        if isinstance(tree, QuantTensor):        # already quantized: idempotent
            return tree
        if (path and path[-1] in keys and isinstance(tree, torch.Tensor)
                and tree.dim() >= 2 and path[0] != "embed"):
            return quantize_leaf(tree, _act_scale(table, path, cfg) if table else None)
        return tree

    out = walk(params, (), QUANT_KEYS)
    if cfg is not None and getattr(cfg, "tie_embeddings", False):
        out["head_q"] = quantize_leaf(params["embed"].t(), table.get("head"))
    return out


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Float reconstruction of a quantized parameter tree ("head_q" dropped:
    the float embedding table is still present and authoritative)."""
    tree = {k: v for k, v in params.items() if k != "head_q"}
    return _walk(tree, lambda t, _: dequantize_leaf(t)
                 if isinstance(t, QuantTensor) else t)


def weight_bytes(params: Dict[str, Any]) -> int:
    """Total parameter bytes, counting QuantTensors at their packed size."""
    total = 0
    for t in _leaves(params):
        if isinstance(t, QuantTensor):
            total += t.nbytes
        else:
            total += t.numel() * t.element_size()
    return total


def quantized_leaf_count(params: Dict[str, Any]) -> int:
    return sum(isinstance(t, QuantTensor) for t in _leaves(params))
