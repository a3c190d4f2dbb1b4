"""Gradient compression with error feedback (int8, 128-wide block scales):
port of repro/optim/compression.py.

For data parallelism across slow links the gradient all-reduce carries
int8 codes and f32 block scales instead of bf16 or f32; error feedback
keeps each leaf's quantization residual and adds it back before the next
compression, so the scheme is unbiased in the long run.  Plain PyTorch on
the port's trees (repro_torch.tree), as the reference is plain jnp.

    ef = init_error_feedback(grads)
    q_grads, ef = compress_with_feedback(grads, ef)
    # ... all-reduce q_grads ...
    grads = decompress(q_grads, grads)
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.optim.adamw import BlockQ, _bq_decode, _bq_encode, _moments


def init_error_feedback(grads) -> Any:
    return tree_lib.map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                   device=g.device), grads)


def compress_with_feedback(grads, ef_state) -> Tuple[Any, Any]:
    """(a tree of BlockQ in the grads' structure, the new error-feedback
    state)."""
    out = []
    for g, e in zip(tree_lib.leaves(grads), tree_lib.leaves(ef_state)):
        corrected = g.to(torch.float32) + e
        q = _bq_encode(corrected)
        out.append((q, corrected - _bq_decode(q, g.shape)))
    return (tree_lib.unflatten(grads, [o[0] for o in out]),
            tree_lib.unflatten(grads, [o[1] for o in out]))


def decompress(q_grads, template) -> Any:
    flat_t = tree_lib.leaves(template)
    flat_q = _moments(q_grads, True)
    return tree_lib.unflatten(template, [_bq_decode(q, t.shape).to(t.dtype)
                                         for q, t in zip(flat_q, flat_t)])


def compressed_bytes(q_grads) -> int:
    """Wire size of the compressed payload (int8 codes + f32 block scales)."""
    return sum(b.q.numel() + b.scale.numel() * 4 for b in _moments(q_grads, True))
