"""Activation calibration: observers over calibration batches -> scale table
(port of repro/quant/calibrate.py).

Static ("w8a8-calibrated") activation quantization needs one number per
projection: the scale that maps the layer's typical activation range onto
[-127, 127].  `calibrate` collects those numbers by running the model over a
few calibration batches with the `quant.modes` activation tap installed:

  * the unpaged forward is replayed eagerly, group by group, as the
    reference replays it: layers g * group_size .. + group_size - 1 of the
    flat `params["layers"]` list form group g, and attention runs through
    `blockwise_attention` (the flash-attention kernel on the card);
  * each group's weights are registered by python identity
    (`id(w) -> "blocks.{g}.sub{i}.mixer.wq"`, the reference's dotted names),
    so a captured (activation, weight) pair maps to its parameter path with
    no call-order assumptions, and a table made by either package feeds the
    other;
  * per-path `Observer`s reduce the stream of activations to a scale.

The observers are a copy of the reference's (numpy only; the port imports
nothing of `repro`):

  absmax           running max of |x| -- tightest coverage, outlier-sensitive
  moving_average   EMA of the per-batch absmax (momentum m)
  percentile       running max of the per-batch |x| percentile (e.g. 99.9)

Determinism: observers are pure numpy over a deterministic capture order, so
the same params + batches always produce bit-identical tables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.quant import modes

EPS = 1e-8


# ---------------------------------------------------------------------------
# observers (a copy of the reference's)
# ---------------------------------------------------------------------------

class Observer:
    """Reduces a stream of |activation| matrices to quantization scales."""

    def observe(self, a: np.ndarray) -> None:  # a = |x| as (rows, K) f32
        raise NotImplementedError

    def end_batch(self) -> None:
        """Batch boundary hook (only the moving-average observer cares)."""

    def stat(self, per_channel: bool = False) -> np.ndarray:
        raise NotImplementedError

    def scale(self, per_channel: bool = False) -> np.ndarray:
        return np.maximum(self.stat(per_channel), EPS) / 127.0


class AbsmaxObserver(Observer):
    def __init__(self):
        self._ch: Optional[np.ndarray] = None

    def observe(self, a: np.ndarray) -> None:
        ch = a.max(axis=0)
        self._ch = ch if self._ch is None else np.maximum(self._ch, ch)

    def stat(self, per_channel: bool = False) -> np.ndarray:
        assert self._ch is not None, "observer saw no data"
        return self._ch if per_channel else self._ch.max()


class MovingAverageObserver(Observer):
    """EMA of the per-batch absmax.  Within a batch the pending statistic is
    a max (commutative — robust to capture-call ordering); the EMA applies
    once per `end_batch`, so the result is deterministic for a given batch
    sequence."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self._ema: Optional[np.ndarray] = None
        self._pending: Optional[np.ndarray] = None

    def observe(self, a: np.ndarray) -> None:
        ch = a.max(axis=0)
        self._pending = ch if self._pending is None else np.maximum(self._pending, ch)

    def end_batch(self) -> None:
        if self._pending is None:
            return
        if self._ema is None:
            self._ema = self._pending
        else:
            m = self.momentum
            self._ema = m * self._ema + (1.0 - m) * self._pending
        self._pending = None

    def stat(self, per_channel: bool = False) -> np.ndarray:
        ema = self._ema if self._ema is not None else self._pending
        assert ema is not None, "observer saw no data"
        return ema if per_channel else ema.max()


class PercentileObserver(Observer):
    """Running max of the per-batch |x| percentile: clips the outlier tail.
    (Max-of-per-batch-percentiles approximates the pooled percentile without
    retaining every activation; exact for the 100th percentile.)"""

    def __init__(self, percentile: float = 99.9):
        self.percentile = percentile
        self._val: Optional[float] = None
        self._ch: Optional[np.ndarray] = None

    def observe(self, a: np.ndarray) -> None:
        v = float(np.percentile(a, self.percentile))
        ch = np.percentile(a, self.percentile, axis=0)
        self._val = v if self._val is None else max(self._val, v)
        self._ch = ch if self._ch is None else np.maximum(self._ch, ch)

    def stat(self, per_channel: bool = False) -> np.ndarray:
        assert self._val is not None, "observer saw no data"
        return self._ch if per_channel else np.float64(self._val)


OBSERVERS = {
    "absmax": AbsmaxObserver,
    "moving_average": MovingAverageObserver,
    "percentile": PercentileObserver,
}


def make_observer(name: str, **kwargs) -> Observer:
    if name not in OBSERVERS:
        raise ValueError(f"unknown observer {name!r}; known: {sorted(OBSERVERS)}")
    return OBSERVERS[name](**kwargs)


# ---------------------------------------------------------------------------
# the scale table
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScaleTable:
    """Per-site activation scales: `scales` (per-tensor, what the int8 GeMM
    consumes) and `channel_scales` (per-channel, for outlier diagnosis in
    quant/report.py).  Keys are dotted param paths, group-indexed for the
    scanned blocks: "blocks.0.sub1.mixer.wq", "head", ..."""

    scales: Dict[str, float]
    channel_scales: Dict[str, np.ndarray]
    observer: str
    batches: int

    def get(self, path: str, default=None):
        return self.scales.get(path, default)

    def __len__(self) -> int:
        return len(self.scales)


# ---------------------------------------------------------------------------
# calibration run
# ---------------------------------------------------------------------------

def _register(idmap: Dict[int, str], prefix: str, tree: Any) -> None:
    """Map id(leaf) -> "prefix.key.key" for every tensor leaf of `tree`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _register(idmap, f"{prefix}.{k}", v)
    else:
        idmap[id(tree)] = prefix


def _tokens_of(batch, device) -> torch.Tensor:
    """batch["tokens"] (or the batch itself: an array or tensor) as an int64
    tensor on `device`."""
    if isinstance(batch, dict):
        batch = batch["tokens"]
    if isinstance(batch, torch.Tensor):
        return batch.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(batch, np.int64)).to(device)


def calibrate(params, cfg, batches: Iterable, *, observer: str = "absmax",
              **observer_kwargs) -> ScaleTable:
    """Collect per-layer activation scales over `batches` (each a (B, S)
    token array or tensor, or a dict with a "tokens" key), on the device
    the parameters live on.

    Replays `forward` eagerly group by group with the activation tap
    installed, in float mode; for the decoder families only (encdec and
    vlm raise, as in the reference).  The head site is fed to the tap directly:
    the observer reads only the head's input, so the (B * S, vocab) logits
    are never computed."""
    from repro_torch.models import blocks   # deferred: models import quant
    from repro_torch.models import model as M

    if cfg.family in M.UNPAGED_FAMILIES:
        raise NotImplementedError(
            f"calibration not wired for family {cfg.family!r}")
    observers: Dict[str, Observer] = {}
    idmap: Dict[int, str] = {}

    def tap(x, w):
        path = idmap.get(id(w))
        if path is None:
            return      # unregistered weight
        obs = observers.get(path)
        if obs is None:
            obs = observers[path] = make_observer(observer, **observer_kwargs)
        a = np.abs(x.detach().to(torch.float32).cpu().numpy()).reshape(-1, x.shape[-1])
        obs.observe(a)

    device = params["embed"].device
    n_batches = 0
    with torch.no_grad(), modes.precision("float"), modes.activation_capture(tap):
        for batch in batches:
            tokens = _tokens_of(batch, device)
            x = M._embed_tokens(params, cfg, tokens)
            positions = torch.arange(tokens.shape[1], device=device)
            for g in range(cfg.n_groups):
                gl = M.group_layers(params, cfg, g)
                idmap.clear()
                for i, layer in enumerate(gl):
                    _register(idmap, f"blocks.{g}.sub{i}", layer)
                x = blocks.apply_group(x, gl, cfg, positions=positions)
            x = blocks._norm(x, params["final_norm"], cfg)
            idmap.clear()
            head = params["embed"] if cfg.tie_embeddings else params["head"]
            idmap[id(head)] = "head"
            tap(x, head)
            n_batches += 1
            for obs in observers.values():
                obs.end_batch()

    return ScaleTable(
        scales={k: float(o.scale()) for k, o in sorted(observers.items())},
        channel_scales={
            k: np.asarray(o.scale(per_channel=True), np.float64)
            for k, o in sorted(observers.items())
        },
        observer=observer,
        batches=n_batches,
    )


def synthetic_batches(cfg, *, n: int = 2, batch: int = 2, seq: int = 32,
                      seed: int = 0) -> List[np.ndarray]:
    """Deterministic synthetic token batches for calibration smoke paths
    (real deployments pass held-out data); the reference's draw."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
            for _ in range(n)]
