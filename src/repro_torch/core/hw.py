"""The card's published peaks, held once for the whole port.

NVIDIA H100 80GB HBM3 (SXM), as `nvidia-smi` names it; 700.00 W limit.
These are the datasheet's dense peaks, not measurements: a card set below
700 W, or a kernel that misses its tensor-core path, runs slower.  Every
bound of the port reads them here: the tuner's analytic model
(`tuning/model.py`), the MFU gauges (`obs/mfu.py`), the kernels' cost
functions (`kernels/cost.py`), the roofline (`launch/roofline.py`) and the
dry run (`launch/dryrun.py`), and `chip_smoke.py`'s bounds.

The reference's repro/core/hw.py holds a TPU's peaks for the same role;
none of its numbers carries over.
"""

HBM_BW = 3.35e12                                  # bytes/s
PEAK_OPS = {8: 1979e12, 16: 989e12, 32: 67e12}    # dense ops/s by operand bits
                                                  # (32: f32 outside the tensor cores)
PEAK_FLOPS_BF16 = PEAK_OPS[16]
CLOCK_HZ = 1.98e9                                 # SM boost clock
H100_SMS = 132                                    # streaming multiprocessors
L2_BYTES = 50e6                                   # L2 cache
DEVICE_BYTES = 80e9                               # device memory, as the card is sold

_DTYPE_BITS = {"int8": 8, "bfloat16": 16, "float16": 16, "float32": 32}


def peak_ops(dtype) -> float:
    """The dense peak for operands of `dtype` (a name such as "bfloat16",
    or a torch dtype)."""
    return PEAK_OPS[_DTYPE_BITS[str(dtype).replace("torch.", "")]]
