"""PyTorch / CUDA port of the `repro` serving stack for NVIDIA Hopper.

The JAX package `repro` is the reference; this package mirrors its
subpackage layout (`configs`, `models`, `kernels`, `serving`, `cluster`,
`launch`, and for training `optim`, `data`, `checkpoint`, `runtime`) so
each module names its counterpart.  It imports `torch` and
numpy only —
never `jax`, never `repro` — and every Pallas TPU kernel on its path is a
hand-written CUDA kernel under `kernels/csrc/`.

Entry points (`Engine`, `launch.serve`, `launch.train`, `init_model`) run on the card by
default and raise when no CUDA device is present; pass ``device="cpu"`` to
run the kernels' plain PyTorch versions instead.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises rather than silently falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev
