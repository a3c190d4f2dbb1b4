"""The slice as a whole on the CPU: a tuned, traced port Engine against the
reference's tuned, traced Engine on the same weights and traffic
(gemma3-1b smoke, float32, speculative): greedy tokens, the lifecycle
event names, every request's flow chain, the allocator, scheduler and
drafter counters, and `as_dict`'s keys; then the engine's own rules: the
plans it tuned bind its steps whatever the process-wide tuner says
afterwards, tracing changes no token or counter, and wall-clock tuning
needs the card."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import tuning as rtuning
from repro.kernels import flash_decode as rfd
from repro.models import model as RM
from repro.obs import chrome_trace_events as r_events
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import tuning
from repro_torch.kernels import flash_decode as tfd
from repro_torch.obs import chrome_trace_events as t_events
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import RequestSpec as TSpec

ARCH = "gemma3-1b"
KW = dict(slots=2, max_seq=64, block_size=4, max_chunk=8, speculative=True)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = rconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _traffic(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(5):
        p = rng.integers(0, vocab, size=int(rng.integers(4, 12))).astype(np.int32)
        out.append((np.concatenate([p, p]), int(rng.integers(3, 9))))
    return out


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """Both engines tuned (analytic), traced and served; the reference's
    process-wide tuning state is restored afterwards."""
    rcfg, rparams, tcfg, tparams = models
    d = tmp_path_factory.mktemp("tune")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("REPRO_TUNE_CACHE", str(d / "ref.json"))
        reng = REngine(rcfg, rparams, autotune=True, trace=True, **KW)
        reng.warmup()
        mp.setenv("REPRO_TUNE_CACHE", str(d / "port.json"))
        teng = TEngine(tcfg, tparams, device="cpu", autotune=True, trace=True, **KW)
        teng.warmup()
    finally:
        mp.undo()
        rtuning.disable()
        rtuning.set_tuner(None)
        rfd.set_decode_spec(None)
    try:
        for p, n in _traffic(rcfg.vocab):
            reng.submit(RSpec(prompt=p, max_new=n))
            teng.submit(TSpec(prompt=p, max_new=n))
        reng.run()
        teng.run()
    finally:
        rtuning.disable()
        rtuning.set_tuner(None)
    return reng, teng


def test_tuned_traced_engine_matches_reference(runs):
    reng, teng = runs
    assert sorted(teng.results) == sorted(reng.results)
    for rid, toks in reng.results.items():
        np.testing.assert_array_equal(teng.results[rid], np.asarray(toks))
    assert teng.metrics.spec_ticks == reng.metrics.spec_ticks > 0
    # the tuner ran before warmup and the engine holds it
    assert teng.tuner is not None and len(teng.tune_results) == 5
    assert teng.decode_spec is not None and not tuning.is_enabled()


def test_lifecycle_events_and_flow_chains_match_reference(runs):
    reng, teng = runs
    rev, tev = r_events([reng.tracer]), t_events([teng.tracer])
    assert {e["name"] for e in tev} == {e["name"] for e in rev}

    def chains(evs, pid):
        out = {}
        for e in evs:
            if e.get("cat") == "flow":
                out.setdefault(e["id"] - (pid << 24), []).append(e["ph"])
        return out

    assert chains(tev, teng.tracer.pid) == chains(rev, reng.tracer.pid)
    for ph in ("B", "E", "b", "e", "C", "i"):
        assert sum(e["ph"] == ph for e in tev) == sum(e["ph"] == ph for e in rev), ph


def test_counters_and_metrics_match_reference(runs):
    reng, teng = runs
    assert teng.alloc.stats() == reng.alloc.stats()
    for k in ("admitted_total", "peak_queue_depth", "rejected", "preemptions"):
        assert getattr(teng.scheduler, k) == getattr(reng.scheduler, k), k
    for k in ("draft_calls", "draft_hits", "drafted_tokens"):
        assert getattr(teng.drafter, k) == getattr(reng.drafter, k), k
    td, rd = teng.metrics.as_dict(), reng.metrics.as_dict()
    assert set(rd) <= set(td)
    for k in ("requests", "prefill_chunks", "prefill_tokens", "decode_steps",
              "decode_tokens", "peak_blocks_in_use", "spec_ticks", "acceptance_rate",
              "cold_compiles"):
        assert td[k] == rd[k], k
    assert set(td["mfu"]["phases"]) == set(rd["mfu"]["phases"])
    for p, st in rd["mfu"]["phases"].items():
        for k in ("tokens", "rows", "steps", "flops"):
            assert td["mfu"]["phases"][p][k] == st[k], (p, k)


def test_tuner_change_after_warmup_has_no_effect(models, tmp_path, monkeypatch):
    """The engine runs its steps under the tuner and decode plan it tuned:
    a later set_tuner / enable / disable / set_decode_spec reaches neither
    its eager steps (here) nor its graphs (captured with its plans)."""
    _, _, tcfg, tparams = models
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tc.json"))
    eng = TEngine(tcfg, tparams, device="cpu", autotune=True, **KW)
    eng.warmup()
    mine = eng.tuner
    other = tuning.Autotuner(cache=tuning.TuneCache(persistent=False))
    seen = []
    real = tfd.ref_paged_decode

    def spy(*a, cols_per_iter=8, **kw):
        seen.append(cols_per_iter)
        return real(*a, cols_per_iter=cols_per_iter, **kw)

    hits = mine.cache.hits
    tuning.set_tuner(other)
    tuning.enable()
    tfd.set_decode_spec(tfd.FlashDecodeSpec(num_splits=3, cols_per_iter=1))
    monkeypatch.setattr(tfd, "ref_paged_decode", spy)
    try:
        eng.submit(TSpec(prompt=np.arange(1, 9), max_new=4))
        out = eng.run()
    finally:
        tuning.disable()
        tuning.set_tuner(None)
        tfd.set_decode_spec(None)
    assert len(out[0]) == 4
    assert mine.cache.hits > hits and len(other.cache) == 0
    assert seen and set(seen) == {eng.decode_spec.cols_per_iter}


def test_tracing_changes_no_token_or_counter(models):
    _, _, tcfg, tparams = models
    outs = []
    for trace in (True, False):
        eng = TEngine(tcfg, tparams, device="cpu", trace=trace, **KW)
        eng.warmup()
        for p, n in _traffic(tcfg.vocab):
            eng.submit(TSpec(prompt=p, max_new=n))
        outs.append((eng.run(), eng.alloc.stats(), eng.metrics.decode_steps,
                     eng.scheduler.admitted_total))
    (r1, s1, d1, a1), (r2, s2, d2, a2) = outs
    assert all(np.array_equal(r1[k], r2[k]) for k in r1) and sorted(r1) == sorted(r2)
    assert (s1, d1, a1) == (s2, d2, a2)


def test_wallclock_tuning_needs_the_card(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="card"):
        TEngine(tcfg, tparams, device="cpu", autotune=True, tune_mode="wallclock", **KW)
    with pytest.raises(ValueError):
        TEngine(tcfg, tparams, device="cpu", tune_mode="fastest", **KW)
