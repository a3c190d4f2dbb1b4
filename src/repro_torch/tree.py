"""Parameter trees of the training path: nested dicts, lists and tuples
(NamedTuples included) whose leaves are tensors or Python numbers.

The port's counterpart of the `jax.tree_util` calls the reference's
optimizer, checkpoints and supervisor make.  Dicts are walked in sorted key
order, as `jax.tree_util` walks them, lists and tuples in index order; the
order is fixed, so a flattened tree lines up with another of the same
structure (params, grads, AdamW moments) and with a checkpoint's leaves.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_paths(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf, in the fixed order; a path is the tuple of
    keys and indices from the root."""
    kids = _children(tree)
    if kids is None:
        yield path, tree
        return
    for key, sub in kids:
        yield from leaves_with_paths(sub, path + (key,))


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, values) -> Any:
    """A tree of `template`'s structure whose leaves are `values` (any
    iterable, consumed in the fixed order)."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        if isinstance(t, tuple):
            items = [build(x) for x in t]
            return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def map_tree(fn: Callable, tree) -> Any:
    """`fn` applied to every leaf, in a tree of the same structure."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
