"""Launch-plan autotuner for the hand kernels (port of repro/tuning).

  candidates  - the legal launch plans of K1 / K6 / the int8 GeMMs per
                (shape, dtype): split count, tile, ring depth, one launch
                or two; the hand rule's always among them
  model       - analytic ranking by an H100 roofline model
  cache       - JSON winner registry with an in-memory LRU front, keyed by
                the card
  autotuner   - search + cache orchestration, `tuned_gemm` entry point,
                the dispatch switch and `scope`
  decode      - K2's split count for paged decode attention (same
                registry, `fd...|flash_decode` keys)

Quick use::

    from repro_torch.tuning import tuned_gemm
    c = tuned_gemm(a, b)                      # best known plan, cached

    from repro_torch import tuning
    tuning.enable()                           # GeMM calls naming no plan
    ...                                       # now dispatch through the tuner

Set ``REPRO_AUTOTUNE=1`` to enable dispatch at import, and
``REPRO_TUNE_CACHE=/path.json`` to relocate the winner registry.
"""

from repro_torch.tuning.autotuner import (
    Autotuner,
    TuneResult,
    disable,
    enable,
    env_truthy,
    get_tuner,
    is_enabled,
    scope,
    set_tuner,
    tuned_gemm,
    tuned_spec,
)
from repro_torch.tuning.cache import (CacheEntry, TuneCache, cache_key,
                                      default_cache_path, device_tag)
from repro_torch.tuning.candidates import (GemmShape, dtype_bits, enumerate_tiles,
                                           rule_spec)
from repro_torch.tuning.decode import (
    DecodeShape,
    decode_cache_key,
    enumerate_decode_specs,
    predict_decode_cost,
    serving_decode_shape,
    tune_decode,
    tune_decode_for_serving,
)
from repro_torch.tuning.model import TilePrediction, predict, predict_clocks

__all__ = [
    "DecodeShape",
    "decode_cache_key",
    "enumerate_decode_specs",
    "predict_decode_cost",
    "serving_decode_shape",
    "tune_decode",
    "tune_decode_for_serving",
    "Autotuner",
    "TuneResult",
    "TuneCache",
    "CacheEntry",
    "GemmShape",
    "TilePrediction",
    "cache_key",
    "default_cache_path",
    "device_tag",
    "dtype_bits",
    "enumerate_tiles",
    "rule_spec",
    "predict",
    "predict_clocks",
    "enable",
    "disable",
    "env_truthy",
    "is_enabled",
    "get_tuner",
    "set_tuner",
    "scope",
    "tuned_gemm",
    "tuned_spec",
]
