"""Decode-attention tuning: the split count of K2, cached like GeMM plans.

Port of repro/tuning/decode.py.  The reference tunes two knobs of its paged
flash-decode kernel: `num_splits` and `cols_per_iter`.  On the card the
axis is `num_splits` alone (`cols_per_iter` only drives the plain version,
and stays at its default): candidates are the rule's count
(`flash_decode.decode_splits`, first, so the tuner can only match or beat
it) and the powers of two up to the table extent, each legal when one
split's columns fit the kernel's shared memory.

The tuned shape is the decode step's, Sq = 1, and the winner is bound with
`flash_decode.set_decode_spec` for every Sq: a verify step of Sq <= 16
positions then sums each position's keys in the splits the decode step
sums them in, so its rows equal the decode step's bit for bit.  (A spec
tuned per Sq, as the reference's `sq=` allows, would break that.)

"analytic" ranks by a bytes model of the H100 (the pool's K and V read
once at 3.35 TB/s, stretched by the waves of blocks over the SMs, plus the
split partials, a launch per kernel); "wallclock" times the kernel on the
card at the full table extent over L2-cold copies of the pool, summed over
the stack's windows by their layer counts (gemma3-1b: 4 global layers, 22
of window 512).  Winners share the GeMM registry (cache.py) under an
``fd...|flash_decode`` key.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels.flash_decode import FlashDecodeSpec
from repro_torch.tuning import model as tmodel
from repro_torch.tuning.autotuner import (L2_BYTES, MARGIN, ROUNDS, Autotuner,
                                          TuneResult, get_tuner, pick)
from repro_torch.tuning.cache import MODEL_TAG, CacheEntry
from repro_torch.tuning.candidates import H100_SMS

_MAX_SPLITS = 64


class DecodeShape(NamedTuple):
    """The decode-attention problem, as the tuner keys it."""

    slots: int        # decode batch width B
    kv_heads: int
    groups: int       # Hq // Hkv (GQA fan-in)
    head_dim: int
    sq: int           # query positions per step (1 decode, K+1 verify)
    block_size: int   # pool block tokens
    max_blocks: int   # block-table columns per slot
    # (window, layers) of the stack's attention layers; window 0: global
    windows: Tuple[Tuple[int, int], ...] = ((0, 1),)


def decode_cache_key(shape: DecodeShape, dtype, mode: str = "analytic",
                     device: str = MODEL_TAG, *,
                     kv_dtype=None) -> str:
    """Registry key: the shape, the query and pool dtypes, the card, and
    the wall-clock suffix of `Autotuner.key`."""
    name = str(dtype).replace("torch.", "")
    kv = str(kv_dtype or dtype).replace("torch.", "")
    wins = ",".join(f"{w}:{n}" for w, n in shape.windows)
    key = (f"fd{shape.slots}x{shape.kv_heads}h{shape.groups}g"
           f"{shape.head_dim}d{shape.sq}q|bs{shape.block_size}x{shape.max_blocks}"
           f"|w{wins}|{name}" + (f"/{kv}" if kv != name else "")
           + f"|flash_decode|{device}")
    if mode != "analytic":
        key += f"|{mode}"
    return key


def _row_tiles(shape: DecodeShape) -> int:
    rows = shape.groups * (1 if shape.sq <= _fd.INVARIANT_SQ else shape.sq)
    return -(-rows // _fd._row_tile(rows))


def enumerate_decode_specs(shape: DecodeShape, *, sms: int = H100_SMS
                           ) -> List[FlashDecodeSpec]:
    """Legal split counts, the rule's first, then ascending powers of two;
    each split holds at most the kernel's table entries per split."""
    rule = _fd.decode_splits(shape.slots, shape.kv_heads, _row_tiles(shape),
                             shape.max_blocks, sms)
    counts = [rule]
    s = 1
    while s <= min(_MAX_SPLITS, shape.max_blocks):
        if s != rule:
            counts.append(s)
        s *= 2
    return [FlashDecodeSpec(num_splits=n) for n in counts
            if -(-shape.max_blocks // n) <= _fd._MAX_SPLIT_COLS]


def predict_decode_cost(spec: FlashDecodeSpec, shape: DecodeShape, *,
                        sms: int = H100_SMS, pool_bytes: int = 2) -> float:
    """Predicted seconds of one decode-attention call per layer, summed
    over the stack's windows: the keys a query can see read once (K and V,
    `pool_bytes` an element), stretched by the waves of blocks over the
    SMs (a split past a window's reach is a block that exits at once), the
    split partials written and read back, a launch per kernel."""
    seq = shape.max_blocks * shape.block_size
    rows = shape.groups * shape.sq
    splits = max(1, min(spec.num_splits, shape.max_blocks))
    total = 0.0
    for window, layers in shape.windows:
        keys = min(seq, window) if window else seq
        nbytes = 2 * shape.slots * shape.kv_heads * keys * shape.head_dim * pool_bytes
        live = max(1, -(-splits * keys // seq))
        blocks = shape.slots * shape.kv_heads * _row_tiles(shape) * live
        t = nbytes / tmodel.HBM_BW * tmodel._waves(blocks, sms) + tmodel.LAUNCH_S
        if splits > 1:
            t += (2 * shape.slots * shape.kv_heads * splits * rows * (shape.head_dim + 2)
                  * 4 / tmodel.HBM_BW + tmodel.LAUNCH_S)
        total += layers * t
    return total


def _time_candidates(tuner: Autotuner, cands: List[FlashDecodeSpec],
                     shape: DecodeShape, dtype, kv_dtype) -> List[float]:
    """Seconds of each candidate on the card: the stack's decode-attention
    calls (each window times its layers) at the full table extent, over
    L2-cold copies of the pool, each call one replay of a CUDA graph of
    repeated launches timed with CUDA events, the best of ROUNDS."""
    from repro_torch.serving import kv_cache as kvc

    dev = tuner.device
    B, mb, bs = shape.slots, shape.max_blocks, shape.block_size
    Hkv, D = shape.kv_heads, shape.head_dim
    qdt = torch.bfloat16 if "bfloat16" in str(dtype) else torch.float32
    int8 = "int8" in str(kv_dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    nb = B * mb + 1
    per_pool = 2 * nb * bs * Hkv * D * (1 if int8 else qdt.itemsize)
    copies = max(1, min(32, -(-2 * L2_BYTES // per_pool)))
    pools = []
    for _ in range(copies):
        c = kvc.init_paged_kv(nb, bs, Hkv, D, qdt, dev,
                              kv_precision="int8" if int8 else "float")
        if int8:
            c.k.copy_(torch.randint(-127, 128, c.k.shape, generator=g, device=dev))
            c.v.copy_(torch.randint(-127, 128, c.v.shape, generator=g, device=dev))
            c.k_scale.uniform_(0.001, 0.02, generator=g)
            c.v_scale.uniform_(0.001, 0.02, generator=g)
        else:
            c.k.copy_(torch.randn(c.k.shape, generator=g, device=dev))
            c.v.copy_(torch.randn(c.v.shape, generator=g, device=dev))
        pools.append(c)
    tables = (torch.arange(B * mb, dtype=torch.int32, device=dev) + 1).reshape(B, mb)
    index = torch.full((B,), mb * bs - shape.sq, dtype=torch.int32, device=dev)
    q = torch.randn((B, shape.sq, Hkv * shape.groups, D), generator=g, device=dev).to(qdt)
    iters = max(10, min(200, 4 * copies))
    scores = [float("inf")] * len(cands)
    try:
        for _ in range(ROUNDS):
            for i, spec in enumerate(cands):
                t = 0.0
                for window, layers in shape.windows:
                    calls = [lambda c=c, s=spec, w=window: _fd.flash_decode_attention(
                        q, c, tables, index, window=w or None, spec=s) for c in pools]
                    t += layers * tuner._time_graph(calls, iters)
                scores[i] = min(scores[i], t)
    finally:
        del pools, q
        torch.cuda.empty_cache()
    return scores


def tune_decode(shape: DecodeShape, dtype="bfloat16", *, kv_dtype=None,
                mode: Optional[str] = None, tuner: Optional[Autotuner] = None,
                force: bool = False) -> TuneResult:
    """Best FlashDecodeSpec for `shape` (`kv_dtype`: the pool's, "int8" for
    an int8 pool; None: `dtype`), cached in the tuner's registry.  `mode`
    defaults to the tuner's; it must match it (a wall-clock search needs
    the tuner's card).  A wall-clock query never resolves from an entry of
    another source."""
    t = tuner or get_tuner()
    mode = mode or t.mode
    if mode != t.mode:
        raise ValueError(f"tune_decode mode {mode!r} on a {t.mode!r} tuner")
    key = decode_cache_key(shape, dtype, mode, t.tag, kv_dtype=kv_dtype)
    if not force:
        hit = t.cache.get(key)
        if hit is not None and hit.source == mode:
            return TuneResult(spec=hit.spec, score=hit.score, source=hit.source,
                              from_cache=True, rule_score=hit.rule_score)
    t0 = time.monotonic()
    cands = enumerate_decode_specs(shape, sms=t.sms)
    if mode == "wallclock":
        scores = _time_candidates(t, cands, shape, dtype, kv_dtype or dtype)
        win = pick(scores, MARGIN)
    else:
        pb = 1 if "int8" in str(kv_dtype) else (4 if "float32" in str(dtype) else 2)
        scores = [predict_decode_cost(s, shape, sms=t.sms, pool_bytes=pb) for s in cands]
        win = pick(scores, 0.0)
    seconds = time.monotonic() - t0
    t.tuning_s += seconds
    t.cache.put(key, CacheEntry(spec=cands[win], score=scores[win], source=mode,
                                rule_score=scores[0]), persist=t.persist)
    return TuneResult(spec=cands[win], score=scores[win], source=mode,
                      candidates=len(cands), rule_spec=cands[0], rule_score=scores[0],
                      seconds=seconds, timings=tuple(zip(cands, scores)))


def serving_decode_shape(cfg, *, slots: int, block_size: int, max_blocks: int,
                         sq: int = 1) -> Optional[DecodeShape]:
    """The decode-attention problem one serving engine launches every
    tick, with the stack's windows, or None for stacks with no attention
    layer (xLSTM: nothing to tune)."""
    kinds = cfg.layer_kinds()
    wins = []
    for kind, window in (("attn", 0), ("attn_local", cfg.local_window or 0)):
        n = sum(k == kind for k in kinds) * cfg.n_groups
        if n:
            wins.append((window, n))
    if not wins:
        return None
    return DecodeShape(slots=slots, kv_heads=cfg.n_kv_heads,
                       groups=cfg.n_heads // cfg.n_kv_heads,
                       head_dim=cfg.resolved_head_dim, sq=sq,
                       block_size=block_size, max_blocks=max_blocks,
                       windows=tuple(wins))


def tune_decode_for_serving(cfg, *, slots: int, block_size: int, max_blocks: int,
                            mode: Optional[str] = None, dtype: Optional[str] = None,
                            kv_precision: str = "float",
                            tuner: Optional[Autotuner] = None,
                            verbose: bool = False) -> Optional[TuneResult]:
    """Engine-warmup entry: tune the Sq = 1 decode shape and return the
    result (None when the stack has no attention layer).  The engine binds
    its spec with `flash_decode.set_decode_spec` before capturing its
    steps."""
    shape = serving_decode_shape(cfg, slots=slots, block_size=block_size,
                                 max_blocks=max_blocks)
    if shape is None:
        return None
    r = tune_decode(shape, dtype or cfg.dtype, mode=mode, tuner=tuner,
                    kv_dtype="int8" if kv_precision == "int8" else None)
    if verbose:
        hit = "cache" if r.from_cache else r.source
        print(f"autotune[decode]: splits={r.spec.num_splits} for {cfg.name} "
              f"(bs{shape.block_size}x{shape.max_blocks}, {kv_precision} pool, {hit})")
    return r
