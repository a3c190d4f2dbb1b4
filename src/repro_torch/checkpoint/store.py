"""Checkpointing: atomic, async (port of repro/checkpoint/store.py).

  * atomic commit: writes go to `step_N.tmp/`, then are renamed to
    `step_N/`; a crashed writer never corrupts the latest checkpoint, and
    a leftover `.tmp` is never read;
  * leaves are flattened in the fixed order of `repro_torch.tree` (dict
    keys sorted, lists in order) and stored on the host as numpy arrays,
    one `<i>.npy` file a leaf (the reference writes one `arrays.npz`,
    whose zip adds a CRC pass over every byte: 12 GB for gemma3-1b's
    training state); bf16 leaves are stored as f32 (exact; numpy has no bf16) and
    listed in the manifest, Python numbers as int64 / float64;
  * restore builds each leaf like the template's (dtype, shape, strides:
    a row-padded `aligned_rows` matrix comes back row-padded) on the
    template's device or the one named;
  * async: `AsyncCheckpointer` copies the tree to the host at once, writes
    in a background thread, and raises a write's error at the next `wait`;
  * GC: `keep_last` prunes old steps.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib


def _host(leaf):
    """A leaf as a host numpy array (bf16 as f32) and whether it was bf16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        bf16 = t.dtype == torch.bfloat16
        return (t.to(torch.float32) if bf16 else t).cpu().numpy(), bf16
    return np.asarray(leaf), False


def snapshot(tree: Any) -> Any:
    """`tree` with every tensor leaf copied to the host (bf16 stays bf16),
    so a background write reads values the training loop cannot change."""
    return tree_lib.map_tree(
        lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor) else x, tree)


def save_checkpoint(path: str, step: int, tree: Any, *, keep_last: int = 3) -> str:
    """Blocking save.  Returns the committed directory."""
    leaves = tree_lib.leaves(tree)
    tmp = os.path.join(path, f"step_{step}.tmp")
    final = os.path.join(path, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    bf16 = {}
    for i, leaf in enumerate(leaves):
        a, was_bf16 = _host(leaf)
        if was_bf16:
            bf16[str(i)] = "bfloat16"
        np.save(os.path.join(tmp, f"{i}.npy"), a)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "num_leaves": len(leaves), "bf16_leaves": bf16}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic commit
    _gc(path, keep_last)
    return final


def _gc(path: str, keep_last: int) -> None:
    steps = sorted(latest_steps(path))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(path, f"step_{s}"), ignore_errors=True)


def latest_steps(path: str) -> List[int]:
    """Every committed step under `path` (a `.tmp` or a directory without
    its manifest is not one)."""
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(path, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
    return out


def latest_step(path: str) -> Optional[int]:
    steps = latest_steps(path)
    return max(steps) if steps else None


def _like(a: np.ndarray, leaf, device):
    if not isinstance(leaf, torch.Tensor):
        return type(leaf)(a.item()) if isinstance(leaf, (int, float)) else a
    dev = leaf.device if device is None else torch.device(device)
    out = torch.empty_strided(leaf.shape, leaf.stride(), dtype=leaf.dtype, device=dev)
    out.copy_(torch.from_numpy(a))
    return out


def restore_checkpoint(path: str, step: int, template: Any, device=None) -> Any:
    """The tree saved at `step`, in `template`'s structure, each tensor leaf
    made like the template's (dtype, shape, strides) on `device` (None: the
    template leaf's)."""
    d = os.path.join(path, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_lib.leaves(template)
    if manifest["num_leaves"] != len(leaves):
        raise ValueError(f"checkpoint {d} holds {manifest['num_leaves']} leaves, the "
                         f"template {len(leaves)}")
    out = [_like(np.load(os.path.join(d, f"{i}.npy")), leaf, device)
           for i, leaf in enumerate(leaves)]
    return tree_lib.unflatten(template, out)


class AsyncCheckpointer:
    """Snapshot to the host synchronously, write in a background thread."""

    def __init__(self, path: str, keep_last: int = 3):
        self.path = path
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = snapshot(tree)

        def work():
            try:
                save_checkpoint(self.path, step, host_tree, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
