"""The port's tile autotuner (repro_torch/tuning) against the reference's
(repro/tuning) and its own rules: candidate legality (the rule always
among them, the split-K scratch respected), analytic ranking, the cache,
dispatch through an enabled tuner, the kernel registry, and the plan
identity the speculative path rests on (one split count for every M up to
64).  Wall-clock ranking needs the card: here it must raise, and its
selection logic runs over a stand-in timer (tests/test_torch_gpu.py times
the real kernels)."""

import json
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import tuning as rtuning
from repro.serving import engine as rengine
from repro_torch import configs as tconfigs
from repro_torch import tuning
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import registry as tregistry
from repro_torch.kernels.gemm import GemmLaunchSpec
from repro_torch.serving import engine as tengine
from repro_torch.serving import kv_cache as tkvc
from repro_torch.tuning import autotuner as tautotuner

G = tuning.GemmShape
SMS = 132
# gemma3-1b's projections and head (K, N): q, k / v, o, gate / up, down, head.
GEMMA_KN = [(1152, 1024), (1152, 256), (1024, 1152), (1152, 6912), (6912, 1152),
            (1152, 262144)]
WORKLOAD_SHAPES = [G(8, 1152, 6912), G(8, 6912, 1152), G(64, 1152, 1024)]


def _tuner(tmp_path, **kw):
    return tuning.Autotuner(cache=tuning.TuneCache(path=str(tmp_path / "tc.json")), **kw)


def _fake_wallclock(monkeypatch, times=None):
    """A wall-clock tuner without the card: no device, and candidate times
    from `times(spec)` (default: the analytic model's)."""
    monkeypatch.setattr(tautotuner, "_measuring_device", lambda device: None)
    calls = []

    def fake(self, cands, shape, dtype, backend, kmajor):
        calls.append(shape)
        return [times(s) if times else tuning.predict(s, shape, dtype,
                                                      backend=backend).time_s
                for s in cands]

    monkeypatch.setattr(tuning.Autotuner, "_time_specs", fake)
    return calls


def test_workload_shapes_come_from_extraction():
    """The shapes the engine pre-tunes are the reference's serving shapes."""
    for arch in ("gemma3-1b", "qwen3-14b", "jamba-1.5-large-398b", "dbrx-132b"):
        want = rengine.serving_gemm_shapes(rconfigs.get(arch), slots=8, chunks=[64, 32])
        got = tengine.serving_gemm_shapes(tconfigs.get(arch), slots=8, chunks=[64, 32])
        assert [(s.M, s.K, s.N) for s in got] == [(s.M, s.K, s.N) for s in want]
    # xLSTM's blocks have no FFN (d_ff 0): the head alone (the reference's
    # list raises on the zero width)
    xl = tconfigs.get("xlstm-1.3b")
    assert [(s.K, s.N) for s in tengine.serving_gemm_shapes(xl, slots=8)] == \
        [(xl.d_model, xl.vocab)]
    assert {(s.K, s.N) for s in WORKLOAD_SHAPES} <= {
        (s.K, s.N) for s in tengine.serving_gemm_shapes(tconfigs.get("gemma3-1b"), slots=8)}


# -- candidate enumeration ---------------------------------------------------


@pytest.mark.parametrize("mkn", [(8, 1152, 6912), (64, 6912, 1152), (1, 1152, 262144),
                                 (300, 1024, 1152)])
@pytest.mark.parametrize("dtype,backend", [("bfloat16", "tiled"), ("float32", "tiled"),
                                           ("bfloat16", "pipelined"), ("int8", "w8a8")])
def test_candidates_legal(mkn, dtype, backend):
    g = G(*mkn)
    cands = tuning.enumerate_tiles(g, dtype, backend=backend)
    assert cands and len(cands) == len(set(cands))
    eb = 1 if backend == "w8a8" else tuning.dtype_bits(dtype) // 8
    rows = 64 if g.M <= 64 else g.M
    for s in cands:
        plan = tgemm.gemm_plan(rows, g.N, g.K, False, SMS, eb, s.splits, s.swap)
        assert plan.splits == s.splits                     # no empty split
        assert tgemm.plan_fits(plan, SMS)                  # workspace, counters
        assert s.splits <= tgemm.MAX_SPLITS[True]
        if g.M > tgemm.SWAP_ROWS or backend == "w8a8":
            assert s.swap == (g.M <= tgemm.SWAP_ROWS)      # no tile axis
        assert (s.depth in (2, 3, 4)) if backend == "pipelined" else s.depth == 0
        assert s.fused or (backend == "w8a8" and g.M <= 16)


def test_candidates_include_default_and_respect_cap():
    g = G(8, 1152, 6912)
    rule = tuning.rule_spec(g)
    assert rule == GemmLaunchSpec(splits=3, swap=True)
    for cap in (None, 4):
        cands = tuning.enumerate_tiles(g, "bfloat16", max_candidates=cap)
        assert cands[0] == rule
        if cap is not None:
            assert len(cands) <= cap


def test_candidates_never_exceed_padded_problem():
    """No plan splits K finer than its stages, and the tile axis is offered
    only where the rule itself swaps (M <= 16)."""
    g = G(8, 128, 128)                        # two bf16 K stages
    cands = tuning.enumerate_tiles(g, "bfloat16")
    assert {s.splits for s in cands} == {1, 2}
    assert {s.swap for s in cands} == {True, False}
    assert {s.swap for s in tuning.enumerate_tiles(G(17, 128, 128))} == {False}


def test_candidates_respect_the_splitk_scratch():
    """At M <= 64 a plan serves every M up to 64, so its partials are sized
    at 64 rows: wide outputs cannot split far, and a head of more tiles than
    SMs not at all (one arrival counter per SM)."""
    for K, N in GEMMA_KN:
        for s in tuning.enumerate_tiles(G(8, K, N)):
            ws = s.splits * 64 * N if s.splits > 1 else 0
            assert ws <= tgemm.workspace_elems(SMS)
    assert {s.splits for s in tuning.enumerate_tiles(G(8, 1152, 262144))} == {1}
    assert max(s.splits for s in tuning.enumerate_tiles(G(8, 1152, 6912))) == 4


# -- analytic model + ranking ------------------------------------------------


def test_predict_is_positive_and_padding_aware():
    """Positive, utilization in (0, 1], and aware of waves: one block per
    output tile (8 blocks on 132 SMs) predicts slower than the rule's
    wave-filling split."""
    g = G(8, 1152, 1024)
    lone = tuning.predict(GemmLaunchSpec(splits=1), g, "bfloat16")
    rule = tuning.predict(tuning.rule_spec(g), g, "bfloat16")
    assert lone.clocks > 0 and 0 < lone.utilization <= 1
    assert 0 < rule.utilization <= 1 and rule.gops(g) > 0
    assert lone.clocks > rule.clocks


def test_analytic_ranking_deterministic(tmp_path):
    g = G(8, 1152, 6912)
    results = [_tuner(tmp_path / str(i), persist=False).tune(g, "bfloat16")
               for i in range(3)]
    assert len({r.spec for r in results}) == 1
    assert len({r.score for r in results}) == 1


@pytest.mark.parametrize("shape", WORKLOAD_SHAPES)
def test_tuned_beats_or_matches_default(shape, tmp_path):
    """Under the model the tuned plan is never worse than the rule's."""
    tuner = _tuner(tmp_path, persist=False)
    for dtype, backend in (("bfloat16", "tiled"), ("int8", "w8a8"),
                           ("bfloat16", "pipelined")):
        res = tuner.tune(shape, dtype, backend=backend)
        rule = tuning.rule_spec(shape, dtype, backend=backend)
        kw = dict(backend=backend)
        assert tuning.predict_clocks(res.spec, shape, dtype, **kw) <= \
            tuning.predict_clocks(rule, shape, dtype, **kw)
        assert res.rule_spec == rule and res.score <= res.rule_score


# -- cache -------------------------------------------------------------------


def test_cache_json_roundtrip(tmp_path):
    path = str(tmp_path / "tc.json")
    cache = tuning.TuneCache(path=path)
    spec = GemmLaunchSpec(splits=5, swap=False, depth=4, fused=False)
    key = tuning.cache_key(G(8, 1152, 6912), "bfloat16", "pipelined")
    cache.put(key, tuning.CacheEntry(spec=spec, score=1.25e-5, source="analytic",
                                     rule_score=2e-5))
    raw = json.load(open(path))               # human-readable on disk
    assert raw[key]["splits"] == 5 and raw[key]["kind"] == "gemm"
    assert raw[key]["source"] == "analytic"
    fresh = tuning.TuneCache(path=path)
    hit = fresh.get(key)
    assert hit is not None and hit.spec == spec and hit.score == 1.25e-5
    assert hit.rule_score == 2e-5
    # decode entries share the registry
    dkey = tuning.decode_cache_key(tuning.DecodeShape(8, 1, 4, 256, 1, 16, 75), "bfloat16")
    fresh.put(dkey, tuning.CacheEntry(spec=tfd.FlashDecodeSpec(num_splits=16),
                                      score=1.0, source="analytic"))
    assert tuning.TuneCache(path=path).get(dkey).spec == tfd.FlashDecodeSpec(num_splits=16)


def test_cache_hit_path(tmp_path):
    """A second tune of the same problem resolves from the cache, also in a
    fresh cache on the same file; up to 64 rows the key leaves M out."""
    tuner = _tuner(tmp_path)
    g = WORKLOAD_SHAPES[0]
    first = tuner.tune(g, "bfloat16")
    assert not first.from_cache and first.candidates > 1
    again = tuner.tune(G(40, g.K, g.N), "bfloat16")
    assert again.from_cache and again.spec == first.spec
    assert tuner.cache.hits >= 1
    tuner2 = tuning.Autotuner(cache=tuning.TuneCache(path=tuner.cache.path))
    cold = tuner2.tune(g, "bfloat16")
    assert cold.from_cache and cold.spec == first.spec
    assert not tuner2.tune(G(65, g.K, g.N), "bfloat16").from_cache


def test_cache_lru_eviction_keeps_disk(tmp_path):
    cache = tuning.TuneCache(path=str(tmp_path / "tc.json"), lru_size=2)
    spec = GemmLaunchSpec(splits=1)
    keys = [f"k{i}" for i in range(4)]
    for k in keys:
        cache.put(k, tuning.CacheEntry(spec=spec, score=1.0, source="analytic"))
    assert len(cache._lru) == 2
    assert len(cache) == 4
    assert cache.get(keys[0]) is not None


def test_wallclock_mode_does_not_reuse_analytic_winners(tmp_path, monkeypatch):
    """The mode is part of the key: a wall-clock tune after an analytic one
    searches again, and each mode then hits its own entry."""
    path = str(tmp_path / "tc.json")
    g = G(8, 1152, 1024)
    analytic = tuning.Autotuner(cache=tuning.TuneCache(path=path))
    assert not analytic.tune(g, "bfloat16").from_cache
    calls = _fake_wallclock(monkeypatch)
    wallclock = tuning.Autotuner(cache=tuning.TuneCache(path=path), mode="wallclock")
    res = wallclock.tune(g, "bfloat16")
    assert not res.from_cache and res.source == "wallclock" and calls == [g]
    assert analytic.tune(g, "bfloat16").from_cache
    assert wallclock.tune(g, "bfloat16").from_cache and calls == [g]


def test_wallclock_does_not_trust_analytic_fallback(tmp_path, monkeypatch):
    """An entry of another source under the wall-clock key (the port never
    writes one; a registry may hold one) does not satisfy a wall-clock tune."""
    path = str(tmp_path / "tc.json")
    g = G(8, 1152, 1024)
    _fake_wallclock(monkeypatch)
    capable = tuning.Autotuner(cache=tuning.TuneCache(path=path), mode="wallclock")
    capable.cache.put(capable.key(g, "bfloat16", "tiled"), tuning.CacheEntry(
        spec=GemmLaunchSpec(splits=1), score=0.0, source="analytic"))
    second = capable.tune(g, "bfloat16")
    assert not second.from_cache and second.source == "wallclock"
    assert capable.tune(g, "bfloat16").from_cache


def test_search_space_params_separate_cache_keys(tmp_path):
    """Explicit depth sweeps and candidate caps do not alias the default key."""
    tuner = _tuner(tmp_path)
    g = G(8, 6912, 1152)
    tuner.tune(g, "bfloat16", backend="pipelined")
    res = tuner.tune(g, "bfloat16", backend="pipelined", depth=4)
    assert not res.from_cache and res.spec.depth == 4
    capped = tuning.Autotuner(cache=tuner.cache, max_candidates=2)
    assert not capped.tune(g, "bfloat16").from_cache
    assert not tuner.tune(g, "bfloat16", backend="tiled").from_cache
    assert not tuner.tune(g, "bfloat16", kmajor=True).from_cache
    with pytest.raises(ValueError):
        tuner.tune(g, "bfloat16", backend="pipelined", depth=5)


def test_env_truthy_disables_on_zero():
    from repro_torch.tuning.autotuner import env_truthy

    assert not env_truthy("0") and not env_truthy("false") and not env_truthy("")
    assert not env_truthy(None) and not env_truthy("off")
    assert env_truthy("1") and env_truthy("true") and env_truthy("yes")
    for v in ("0", "false", "", "off", "1", "true", "yes", None):
        assert env_truthy(v) == rtuning.env_truthy(v)


def test_memory_only_cache_never_touches_disk(tmp_path):
    path = tmp_path / "never-created.json"
    cache = tuning.TuneCache(path=str(path), persistent=False)
    cache.put("k", tuning.CacheEntry(spec=GemmLaunchSpec(splits=1), score=1.0,
                                     source="analytic"))
    cache.save()
    assert not path.exists()
    assert cache.get("k") is not None


def test_corrupt_cache_file_is_ignored(tmp_path):
    path = tmp_path / "tc.json"
    path.write_text("{not json")
    cache = tuning.TuneCache(path=str(path))
    assert len(cache) == 0 and cache.get("anything") is None
    # an entry of a kind the port does not know (the reference's TPU tile)
    path.write_text(json.dumps({"k": {"tm": 8, "tk": 128, "tn": 128, "score": 1.0,
                                      "source": "analytic"}}))
    assert tuning.TuneCache(path=str(path)).get("k") is None


def test_default_cache_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    assert tuning.default_cache_path().endswith("torch-tunecache.json")
    assert tuning.default_cache_path() != rtuning.default_cache_path()
    monkeypatch.setenv("REPRO_TUNE_CACHE", "/x/y.json")
    assert tuning.default_cache_path() == "/x/y.json"


# -- tuned_gemm end to end ---------------------------------------------------


@pytest.mark.parametrize("mkn", [(64, 128, 128), (100, 200, 150), (129, 256, 130)])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tuned_gemm_matches_oracle(mkn, dtype, tmp_path):
    """The port's tuned_gemm against the reference's tuned_gemm (Pallas
    interpreter) on the same seeded numpy inputs: int8 exact, f32 within
    1e-4 (sums of <= 256 products reordered)."""
    m, k, n = mkn
    rng = np.random.default_rng(0)
    if dtype == "int8":
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    else:
        a = rng.standard_normal((m, k)).astype(np.float32)
        b = rng.standard_normal((k, n)).astype(np.float32)
    rt = rtuning.Autotuner(cache=rtuning.TuneCache(path=str(tmp_path / "r.json")))
    want = np.asarray(rtuning.tuned_gemm(jnp.asarray(a), jnp.asarray(b),
                                         backend="interpret", tuner=rt))
    got = tuning.tuned_gemm(torch.from_numpy(a), torch.from_numpy(b),
                            tuner=_tuner(tmp_path)).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_wallclock_mode_interpret(tmp_path, monkeypatch):
    """Wall-clock mode needs the card: it raises on the CPU, never falling
    back to the model.  Its selection (over a stand-in timer) keeps the rule
    unless a candidate beats it by more than the margin, and a candidate
    that fails to launch raises instead of being skipped."""
    with pytest.raises((RuntimeError, ValueError)):
        tuning.Autotuner(mode="wallclock")
    with pytest.raises(ValueError):
        tuning.Autotuner(mode="wallclock", device="cpu")
    g = G(8, 1152, 1024)
    rule = tuning.rule_spec(g)
    # 2 % faster: within the margin, the rule stays
    _fake_wallclock(monkeypatch, lambda s: 1.0 if s == rule else 0.98)
    t = tuning.Autotuner(cache=tuning.TuneCache(persistent=False), mode="wallclock")
    assert t.tune(g, "bfloat16").spec == rule
    # 10 % faster: the first such candidate wins
    _fake_wallclock(monkeypatch, lambda s: 1.0 if s == rule else
                    (0.9 if s == GemmLaunchSpec(splits=4, swap=False) else 0.99))
    t = tuning.Autotuner(cache=tuning.TuneCache(persistent=False), mode="wallclock")
    r = t.tune(g, "bfloat16")
    assert r.spec == GemmLaunchSpec(splits=4, swap=False)
    assert r.rule_score == 1.0 and r.score == 0.9 and len(r.timings) == r.candidates

    def broken(s):
        if s.splits == 2:
            raise RuntimeError("gemm kernel launch failed: cudaError_t 9")
        return 1.0

    _fake_wallclock(monkeypatch, broken)
    t = tuning.Autotuner(cache=tuning.TuneCache(persistent=False), mode="wallclock")
    with pytest.raises(RuntimeError, match="launch failed"):
        t.tune(g, "bfloat16")
    assert tautotuner.pick([1.0, 0.98, 0.975], 0.03) == 0
    assert tautotuner.pick([1.0, 0.96, 0.5], 0.03) == 2


def test_ops_dispatch_through_enabled_tuner(tmp_path):
    """enable() routes GeMM calls that name no plan through the tuner (the
    float GeMM, the w8a8 GeMM); disabled, the default path is inert; an
    explicit spec bypasses the tuner."""
    tuner = _tuner(tmp_path)
    old = tuning.get_tuner()
    a = torch.randn(8, 128)
    b = torch.randn(128, 64)
    try:
        tuning.set_tuner(tuner)
        tops.gemm(a, b)
        assert len(tuner.cache) == 0               # disabled: inert
        tuning.enable()
        out = tops.gemm(a, b)
        torch.testing.assert_close(out, a @ b, rtol=1e-5, atol=1e-5)
        assert len(tuner.cache) == 1
        from repro_torch.quant.params import QuantTensor

        w_q = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
        qt = QuantTensor(q=w_q.t(), scale=torch.rand(64) / 127)
        tops.linear(a, qt)
        assert len(tuner.cache) == 2 and any("w8a8" in k for k in tuner.cache.dump())
        before = len(tuner.cache)
        tops.gemm(torch.randn(8, 256), torch.randn(256, 64),
                  spec=GemmLaunchSpec(splits=1))
        assert len(tuner.cache) == before
    finally:
        tuning.disable()
        tuning.set_tuner(old)


def test_split_count_is_independent_of_m_up_to_64(tmp_path):
    """A verify row equals a decode row bit for bit only if its split count
    does: for every gemma3-1b (K, N), the plan tuned at the decode M = 8
    resolves for every M up to 64 and splits K the same way there."""
    tuner = _tuner(tmp_path, persist=False)
    for K, N in GEMMA_KN:
        for dtype, backend in (("bfloat16", "tiled"), ("int8", "w8a8")):
            spec = tuner.tune(G(8, K, N), dtype, backend=backend).spec
            eb = 1 if backend == "w8a8" else 2
            splits = set()
            for M in (1, 2, 8, 16, 24, 40, 64):
                r = tuner.tune(G(M, K, N), dtype, backend=backend)
                assert r.from_cache and r.spec == spec
                splits.add(tgemm.gemm_plan(M, N, K, False, SMS, eb, spec.splits,
                                           spec.swap).splits)
            assert len(splits) == 1, (K, N, backend, splits)


def test_gemm_launch_spec_json_and_validation():
    s = GemmLaunchSpec(splits=3, swap=False, depth=2, fused=False)
    assert GemmLaunchSpec.from_json(json.loads(json.dumps(s.to_json()))) == s
    with pytest.raises(ValueError):
        GemmLaunchSpec(splits=0)
    with pytest.raises(ValueError):
        GemmLaunchSpec(splits=1, depth=5)
    # the plan follows the spec: the tile only at M <= 16
    assert tgemm.gemm_plan(8, 1024, 1152, False, SMS, 2, 4, False).bm == 64
    assert tgemm.gemm_plan(40, 1024, 1152, False, SMS, 2, 4, True).bm == 64
    assert tgemm.gemm_plan(8, 1024, 1152, False, SMS, 2, 4, None).bm == 16


# -- decode-attention tuning -------------------------------------------------


def test_decode_tuning_candidates_cache_and_binding(tmp_path):
    """K2's candidates (the rule's split count first, the powers of two),
    the analytic pick, its cache entry, and the bound spec reaching the
    dispatch entry the model calls."""
    cfg = tconfigs.get("gemma3-1b")
    shape = tuning.serving_decode_shape(cfg, slots=8, block_size=16, max_blocks=75)
    assert shape.windows == ((0, 4), (512, 22))
    cands = tuning.enumerate_decode_specs(shape)
    assert cands[0].num_splits == tfd.decode_splits(8, 1, 1, 75, SMS) == 33
    assert [c.num_splits for c in cands[1:]] == [1, 2, 4, 8, 16, 32, 64]
    tuner = _tuner(tmp_path)
    r = tuning.tune_decode(shape, "bfloat16", tuner=tuner)
    assert r.score <= r.rule_score and r.rule_spec == cands[0]
    assert tuning.tune_decode(shape, "bfloat16", tuner=tuner).from_cache
    assert not tuning.tune_decode(shape, "bfloat16", kv_dtype="int8", tuner=tuner).from_cache
    assert tuning.serving_decode_shape(tconfigs.get("xlstm-1.3b"), slots=8,
                                       block_size=16, max_blocks=75) is None
    with pytest.raises(ValueError):
        tuning.tune_decode(shape, "bfloat16", mode="wallclock", tuner=tuner)
    # the bound spec is what a spec-less call takes (cols_per_iter drives the
    # plain version on the CPU)
    seen = []
    real = tfd.ref_paged_decode

    def spy(*a, cols_per_iter=8, **kw):
        seen.append(cols_per_iter)
        return real(*a, cols_per_iter=cols_per_iter, **kw)

    cache = tkvc.init_paged_kv(5, 4, 1, 16, torch.float32, "cpu")
    q = torch.randn(1, 1, 2, 16)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    try:
        tfd.ref_paged_decode = spy
        tfd.paged_decode_attention(q, cache, tables, 3)
        with tuning.scope(None, tfd.FlashDecodeSpec(num_splits=2, cols_per_iter=1)):
            tfd.paged_decode_attention(q, cache, tables, 3)
        tfd.paged_decode_attention(q, cache, tables, 3)
    finally:
        tfd.ref_paged_decode = real
    assert seen == [8, 1, 8]
    assert tfd.get_decode_spec() is None
    with pytest.raises(TypeError):
        tfd.set_decode_spec(GemmLaunchSpec(splits=1))


# -- thread-local scopes ------------------------------------------------------


def _in_threads(n, fn, timeout=60):
    errors = []

    def run(i):
        try:
            fn(i)
        except BaseException as e:          # reported by the test thread
            errors.append(e)
            raise

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"
    if errors:
        raise errors[0]


def test_scope_binds_per_thread_when_interleaved(tmp_path):
    """Two threads enter and leave `tuning.scope` with their own tuners and
    decode plans, interleaved (the first leaves while the second is still
    inside): each sees only its own, inside `enable` / `disable` /
    `set_tuner` / `set_decode_spec` change its own block alone, and the
    process-wide state is what it was before and after."""
    tuners = [_tuner(tmp_path / f"t{i}") for i in range(2)]
    specs = [tfd.FlashDecodeSpec(num_splits=2 + i, cols_per_iter=1) for i in range(2)]
    before = (tuning.is_enabled(), tuning.get_tuner(), tfd.get_decode_spec())
    gates = [threading.Barrier(2, timeout=30) for _ in range(4)]
    seen = {}

    def view():
        return tuning.is_enabled(), tuning.get_tuner(), tfd.get_decode_spec()

    def worker(i):
        gates[0].wait()
        if i == 1:
            gates[1].wait()                  # thread 0 is inside first
        with tuning.scope(tuners[i], specs[i]):
            if i == 0:
                gates[1].wait()
            gates[2].wait()                  # both inside
            seen[i, "in"] = view()
            if i == 0:
                tuning.disable()
                tfd.set_decode_spec(None)
                seen[0, "changed"] = view()
            else:
                tuning.set_tuner(tuners[0])
                seen[1, "changed"] = view()
                tuning.set_tuner(tuners[1])
            if i == 1:
                gates[3].wait()              # thread 0 has left
                seen[1, "after_other_left"] = view()
        if i == 0:
            seen[0, "out"] = view()
            gates[3].wait()

    _in_threads(2, worker)
    for i in range(2):
        assert seen[i, "in"] == (True, tuners[i], specs[i])
    assert seen[0, "changed"] == (False, tuners[0], None)
    assert seen[1, "changed"] == (True, tuners[0], specs[1])
    assert seen[1, "after_other_left"] == (True, tuners[1], specs[1])
    assert seen[0, "out"] == before
    assert view() == before


def test_scope_nesting_and_outside_meaning_unchanged(tmp_path):
    """Outside any scope `enable` / `set_tuner` / `set_decode_spec` act
    process-wide, as before; a scope(None) keeps the outer tuner with
    tuning disabled; each exit restores its thread's state."""
    t1, t2 = _tuner(tmp_path / "a"), _tuner(tmp_path / "b")
    old = tuning.get_tuner()
    spec = tfd.FlashDecodeSpec(num_splits=4, cols_per_iter=2)
    try:
        tuning.set_tuner(t1)
        tuning.enable()
        tfd.set_decode_spec(spec)
        got = []
        _in_threads(1, lambda i: got.append((tuning.is_enabled(), tuning.get_tuner(),
                                             tfd.get_decode_spec())))
        assert got == [(True, t1, spec)]        # process-wide: other threads see it
        with tuning.scope(t2):
            assert (tuning.is_enabled(), tuning.get_tuner(), tfd.get_decode_spec()) == \
                (True, t2, None)
            with tuning.scope(None):
                assert (tuning.is_enabled(), tuning.get_tuner()) == (False, t2)
            assert tuning.is_enabled() and tuning.get_tuner() is t2
        assert (tuning.is_enabled(), tuning.get_tuner(), tfd.get_decode_spec()) == \
            (True, t1, spec)
    finally:
        tuning.disable()
        tuning.set_tuner(old)
        tfd.set_decode_spec(None)


def test_scope_stress_many_threads(tmp_path):
    """More threads than cores, a short switch interval: every thread keeps
    seeing its own tuner and plan across many scope entries."""
    n = 16
    tuners = [tuning.Autotuner(cache=tuning.TuneCache(persistent=False)) for _ in range(n)]
    specs = [tfd.FlashDecodeSpec(num_splits=i + 1, cols_per_iter=1) for i in range(n)]
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(i):
            for _ in range(300):
                with tuning.scope(tuners[i], specs[i]):
                    assert tuning.get_tuner() is tuners[i]
                    assert tfd.get_decode_spec() is specs[i] and tuning.is_enabled()
                assert tfd.get_decode_spec() is None and not tuning.is_enabled()

        _in_threads(n, worker)
    finally:
        sys.setswitchinterval(prev)
    assert tfd.get_decode_spec() is None and not tuning.is_enabled()


# -- kernel registry ---------------------------------------------------------


def test_registry_builtins():
    assert {"tiled", "pipelined", "dequant", "w8a8"} <= set(tregistry.registered_kernels())


def test_registry_rejects_duplicates_and_unknown():
    with pytest.raises(ValueError):
        tregistry.register_kernel("tiled", lambda a, b, **kw: None)
    with pytest.raises(KeyError):
        tregistry.make_kernel("no-such-kernel")


def test_registry_memoizes_specializations():
    """A variant is one function, handed out as the same object every time,
    that takes its launch plan per call."""
    assert tregistry.make_kernel("tiled") is tregistry.make_kernel("tiled")
    a, b = torch.randn(8, 64), torch.randn(64, 32)
    for spec in (None, GemmLaunchSpec(splits=2, swap=False)):
        torch.testing.assert_close(tregistry.make_kernel("tiled")(a, b, spec=spec), a @ b,
                                   rtol=1e-5, atol=1e-5)


def test_registered_kernel_is_dispatchable():
    calls = []

    def fn(a, b, *, out_dtype=None, spec=None):
        calls.append(spec)
        return a @ b

    tregistry.register_kernel("test-variant", fn)
    try:
        assert tregistry.make_kernel("test-variant") is fn
        a = torch.ones(16, 16)
        tregistry.make_kernel("test-variant")(a, a, spec=GemmLaunchSpec(splits=1))
        assert calls == [GemmLaunchSpec(splits=1)]
    finally:
        tregistry._REGISTRY.pop("test-variant", None)
