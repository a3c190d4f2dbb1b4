"""What one eager step computes, moves and holds, counted as it runs (port of
repro/launch/hlo_cost.py).

The reference parses the compiled HLO of a step: FLOPs of its dots, bytes
of its executed ops, collective bytes, each loop body multiplied by its
trip count.  PyTorch has no HLO, and an eager step runs every loop
iteration, so there is no trip count to recover: `analyze(fn, *args)` runs
the step once under one `TorchDispatchMode` and counts every op it
dispatches, on any device.  On the "meta" device nothing is computed or
allocated, so a step of hundreds of billions of parameters counts in
seconds (launch/dryrun.py); every hand kernel's wrapper has a meta route
that reports the kernel's own cost (kernels/cost.py).

  flops            PyTorch ops by `torch.utils.flop_counter`'s formulas
                   (the backward included), plus the hand kernels' counts
  bytes_accessed   each op's input and output bytes (views and empty
                   allocations move none; an indexed write or read moves
                   the rows it touches, not the whole table): the eager
                   step's own traffic, unfused; the hand kernels' bytes
                   from their cost functions
  peak_live_bytes  the most bytes of storages made inside the step alive at
                   once (storages, not views; what lived before the step,
                   such as the parameters, is not counted)
  collective_*     result bytes and counts of c10d collectives by op (empty
                   at world size 1)
  *_by_source      FLOPs and bytes by source: a hand kernel by its name
                   ("kernel:gemm"), a PyTorch op by the innermost frame of
                   src/repro_torch on its Python stack ("models/layers.py:
                   rms_norm"), an op of the backward by the forward op it
                   differentiates ("backward of models/layers.py:rms_norm",
                   tied through the autograd sequence number); ops with no
                   such frame under "unattributed".  launch/diagnose.py
                   prints these.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import os
import sys
import threading
import weakref
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNATTRIBUTED = "unattributed"
# Frames of the counting tools themselves never name a source.
_TOOL_FILES = ("launch/step_cost.py", "launch/diagnose.py", "kernels/cost.py")
# The plain versions of the hand kernels (the CPU's path) group under their kernel.
_KERNEL_FILES = {"kernels/gemm.py": "gemm", "kernels/gemm_pipelined.py": "gemm_pipelined",
                 "kernels/gemm_int8.py": "gemm_int8", "kernels/quant.py": "quantize_rows",
                 "kernels/flash_decode.py": "flash_decode",
                 "kernels/flash_attention.py": "flash_attention"}
_SHARED_FILES = ("kernels/ref.py",)

_aten = torch.ops.aten
# Ops that move no bytes: allocations without a fill, aliases, metadata.
_NO_TRAFFIC = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default, _aten.detach.default, _aten.alias.default,
    _aten._local_scalar_dense.default,
}
_METADATA = {
    _aten.sym_size.default, _aten.sym_stride.default, _aten.sym_numel.default,
    _aten.sym_storage_offset.default, _aten.size.default, _aten.stride.default,
    _aten.numel.default, _aten.dim.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.storage_offset.default,
    torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "c10d_functional")
# Indexed writes touch the rows they write, not all of self (as the
# reference's hlo_cost.py charges a dynamic-update-slice at the update's
# size): the other operands, read, and as much of self, written.
_INDEXED_WRITES = {"index_copy_", "index_copy", "index_put_", "index_put", "_index_put_impl_",
                   "index_add_", "index_add", "scatter_", "scatter", "scatter_add_",
                   "scatter_add", "masked_scatter_", "index_fill_"}
# Indexed reads touch the rows they gather: the output, read and written,
# and the indices.
_INDEXED_READS = {"embedding", "index_select", "gather", "index", "take"}


def kernel_source(name: str) -> str:
    return f"kernel:{name}"


@functools.lru_cache(maxsize=None)
def _relative(filename: str) -> Optional[str]:
    """`filename`'s path inside src/repro_torch, or None outside it."""
    path = os.path.abspath(filename)
    if path.startswith(PACKAGE_DIR + os.sep):
        return path[len(PACKAGE_DIR) + 1:].replace(os.sep, "/")
    norm = "/" + filename.replace(os.sep, "/")
    i = norm.rfind("/repro_torch/")
    return norm[i + len("/repro_torch/"):] if i >= 0 else None


def frame_source(frames: Iterable[Tuple[str, str]], in_backward: bool,
                 forward_source: Callable[[], Optional[str]]) -> str:
    """The source of an op from its Python frames (filename, function),
    innermost first.  In the forward: the innermost frame in
    src/repro_torch (a hand kernel's module: "kernel:<module>").  In the
    backward the autograd engine runs the op: it belongs to the forward
    op that `forward_source()` names ("backward of ..."), unless a frame of
    the package runs it before the engine does (a Function's own backward,
    or a checkpointed group recomputed: `torch/utils/checkpoint.py` on the
    stack), which names it as in the forward."""
    own, engine_first, recompute = None, False, False
    for filename, func in frames:
        rel = _relative(filename)
        if rel is None:
            norm = filename.replace(os.sep, "/")
            if "torch/utils/checkpoint.py" in norm:
                recompute = True
            elif "torch/autograd/" in norm and own is None:
                engine_first = True
            continue
        if own is None and rel not in _TOOL_FILES and rel not in _SHARED_FILES:
            own = (kernel_source(_KERNEL_FILES[rel]) if rel in _KERNEL_FILES
                   else f"{rel}:{func}")
            if not in_backward:
                return own
    if in_backward and not recompute and (own is None or engine_first):
        fwd = forward_source()
        return f"backward of {fwd}" if fwd else UNATTRIBUTED
    return own or UNATTRIBUTED


def _python_frames(skip: int = 2):
    f = sys._getframe(skip)
    while f is not None:
        yield f.f_code.co_filename, f.f_code.co_name
        f = f.f_back


class Sources:
    """Each dispatched op's source, from its Python frames (`frame_source`).

    A backward op names the forward op that made its autograd node.  The
    node's sequence number says which op that was, but sequence numbers
    count per thread, and on the card the autograd engine runs the backward
    (and a checkpointed group's recompute, which makes nodes of its own)
    on a thread of its own.  So the forward's nodes take their source into
    their `metadata` when the backward first reaches them, and a node made
    in the backward is found by (thread, sequence number).

    A node that Python has touched keeps its Python object for as long as
    it lives, and a graph of such nodes frees itself recursively, a node's
    destructor releasing the next: a chain as deep as a 1024-step sLSTM
    loop per layer overflowed the C stack when the step returned.  So
    every node touched here is held (`held`) until `release()`, which
    drops them parents first: each node then dies alone, its children
    still held.  (A custom Function's node is held through its context
    object, which holds the node weakly: such a node dies with its last
    parent, its children still held.)"""

    def __init__(self):
        self.by_seq: Dict[Tuple[int, int], str] = {}
        self.forward_thread: Optional[int] = None
        self.held: Dict[int, object] = {}

    def __call__(self, skip: int) -> str:
        node = torch._C._current_autograd_node()
        tid = threading.get_ident()
        if node is not None:   # to the end: held in the order the backward runs them
            self.held[id(node)] = self.held.pop(id(node), node)
        if node is None:
            self.forward_thread = tid
            src = frame_source(_python_frames(skip), False, lambda: None)
        else:
            src = frame_source(_python_frames(skip), True, lambda: self._node_source(node, tid))
        if src != UNATTRIBUTED and not src.startswith("backward of "):
            # the node this op just made, if it made one, takes its source
            self.by_seq.setdefault((tid, torch._C._autograd._get_sequence_nr() - 1), src)
        return src

    def _node_source(self, node, tid: int) -> Optional[str]:
        if "repro_source" not in node.metadata:
            self._tag_forward_graph(node)
        src = node.metadata.get("repro_source")
        return src or self.by_seq.get((tid, node._sequence_nr()))

    def _tag_forward_graph(self, root) -> None:
        """Give `root` and every node below it not yet tagged the source of
        the forward op that made it (None for a node the backward made)."""
        stack = [root]
        while stack:
            n = stack.pop()
            if n is None or "repro_source" in n.metadata:
                continue
            self.held.setdefault(id(n), n)
            n.metadata["repro_source"] = self.by_seq.get((self.forward_thread, n._sequence_nr()))
            stack.extend(f for f, _ in n.next_functions)

    def release(self) -> None:
        """Drop the held nodes in the order the backward last touched them
        (class docstring): the engine runs a node only after every node
        that feeds it a gradient, so each node goes after its parents."""
        nodes = list(self.held.values())
        self.held.clear()
        for i in range(len(nodes)):
            nodes[i] = None


@dataclasses.dataclass
class StepCost:
    """One step's counts (module docstring); `launches` is the hand
    kernels' launches by name."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_live_bytes: int = 0
    collective_bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_count: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_source: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_source: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def collective_bytes(self) -> float:
        return sum(self.collective_bytes_by_op.values())


def _tensors(tree, out=None) -> list:
    """The tensors in nested lists, tuples and dicts, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements `t` addresses: a broadcast (stride 0)
    dimension is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


class _CountingMode(TorchDispatchMode):
    def __init__(self, result: StepCost):
        super().__init__()
        self.r = result
        self.sources = Sources()
        self.live = 0
        self.live_keys = set()
        self.flops = collections.defaultdict(float)
        self.bytes = collections.defaultdict(float)

    def add(self, source: str, flops: float, nbytes: float) -> None:
        self.flops[source] += flops
        self.bytes[source] += nbytes

    def kernel(self, name: str, c: kcost.Cost) -> None:
        self.add(kernel_source(name), c.ops, c.nbytes)
        self.r.launches[name] = self.r.launches.get(name, 0) + 1

    # -- live storages ------------------------------------------------------------

    def _track(self, outs, ins) -> None:
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in in_keys or key in self.live_keys:
                continue
            n = st.nbytes()
            self.live_keys.add(key)
            self.live += n
            self.r.peak_live_bytes = max(self.r.peak_live_bytes, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self.live_keys.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        if func not in _NO_TRAFFIC and func._overloadpacket not in flop_registry \
                and not func.is_view:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if func.is_view or func in _NO_TRAFFIC:
            if func not in (_aten._local_scalar_dense.default, _aten.lift_fresh.default):
                self._track([] if func.is_view else outs, ins)
            return out
        flops = 0.0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        name = packet.__name__
        if name in _INDEXED_WRITES:
            nbytes = 2 * sum(_nbytes(t) for t in ins[1:])
        elif name in _INDEXED_READS:
            nbytes = 2 * sum(_nbytes(t) for t in outs) + sum(
                _nbytes(t) for t in ins if not t.is_floating_point())
        else:
            nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        ns = func.namespace
        if ns in _COLLECTIVE_NAMESPACES:
            self.r.collective_bytes_by_op[name] = (
                self.r.collective_bytes_by_op.get(name, 0.0) + sum(_nbytes(t) for t in outs))
            self.r.collective_count[name] = self.r.collective_count.get(name, 0) + 1
        self.add(self.sources(3), flops, nbytes)
        self._track(outs, ins)
        return out


LABEL = "repro_source: "


class LabelMode(TorchDispatchMode):
    """Runs each op inside `torch.profiler.record_function(LABEL + its
    source)`, so a profile names the source of every kernel an op launched
    (launch/diagnose.py), whatever thread ran it."""

    def __init__(self):
        super().__init__()
        self.sources = Sources()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        with torch.profiler.record_function(LABEL + self.sources(3)):
            return func(*args, **kwargs)


def analyze(fn: Callable, *args, **kwargs) -> StepCost:
    """Run fn(*args, **kwargs) once and count it (module docstring)."""
    result = StepCost()
    mode = _CountingMode(result)
    try:
        with kcost.recording(mode.kernel), mode:
            out = fn(*args, **kwargs)
        del out
    finally:
        mode.sources.release()
    result.flops_by_source = dict(mode.flops)
    result.bytes_by_source = dict(mode.bytes)
    result.flops = sum(mode.flops.values())
    result.bytes_accessed = sum(mode.bytes.values())
    return result
