"""Priority classes and KV-swap preemption of the port on the CPU, against
the reference (gemma3-1b smoke, float32, the reference's weights bridged):
RequestSpec and SamplingParams validation, the scheduler's class-ranked
admission on the same script as the reference's, the swap round trip of
float and int8 pools into fresh block ids, a preempted victim's tokens
equal to an unpreempted run's and to the reference's preempting engine's,
preemption never evicting the same or a better class, refusal on a
recurrent stack, and the serve CLI with every new flag."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import model as RM
from repro.serving import kv_cache as rkvc
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro.serving.request import SamplingParams as RSampling
from repro.serving.scheduler import Phase as RPhase
from repro.serving.scheduler import Scheduler as RScheduler
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models.config import ArchConfig
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import (GREEDY, PRIORITIES, RequestSpec,
                                         SamplingParams, priority_rank)
from repro_torch.serving.scheduler import Phase, Scheduler

ARCH = "gemma3-1b"
KW = dict(slots=1, max_seq=64, block_size=4, num_blocks=12)


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


def test_request_spec_validation():
    p = np.arange(4, dtype=np.int32)
    spec = RequestSpec(prompt=[1, 2, 3], max_new=2)
    assert spec.prompt.dtype == np.int32 and not spec.prompt.flags.writeable
    assert spec.sampling is GREEDY and spec.sampling.is_greedy
    assert (spec.priority, spec.tenant) == ("interactive", "default")
    assert PRIORITIES == ("interactive", "batch")
    for bad in (dict(prompt=[], max_new=1), dict(prompt=p, max_new=0),
                dict(prompt=p, max_new=1, priority="urgent")):
        with pytest.raises(ValueError):
            RequestSpec(**bad)
    with pytest.raises(TypeError):
        RequestSpec(prompt=p, max_new=1, sampling="hot")
    for bad in (dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.max_new = 9
    assert not SamplingParams(temperature=0.5).is_greedy
    assert SamplingParams(temperature=-1.0).is_greedy
    assert priority_rank("interactive") < priority_rank("batch")
    with pytest.raises(ValueError):
        priority_rank("gold")


def test_scheduler_class_ranked_admission_matches_reference():
    """The same submit / admit / preempt / finish script on both
    schedulers: the same queue orders, admissions, seeds, counters; a
    blocked head blocks every class behind it."""
    rng = np.random.default_rng(0)
    scheds = {"r": (RScheduler(slots=2), RSpec, RSampling, RPhase),
              "t": (Scheduler(slots=2), RequestSpec, SamplingParams, Phase)}
    reqs = {k: [] for k in scheds}
    budget = {"ok": True}
    script = ["b", "i", "b", "i:seed", "admit", "preempt", "admit", "b", "i",
              "block", "admit", "unblock", "admit", "finish", "admit"]
    log = {k: [] for k in scheds}
    for op in script:
        for k, (sched, Spec, Samp, Ph) in scheds.items():
            if op in ("b", "i", "i:seed"):
                prio = "batch" if op == "b" else "interactive"
                samp = Samp(temperature=0.5, seed=99) if op == "i:seed" else Samp()
                r = sched.submit(Spec(prompt=rng.integers(0, 9, size=3) if k == "r"
                                      else reqs["r"][len(reqs[k])].prompt,
                                      max_new=2, priority=prio, sampling=samp))
                reqs[k].append(r)
                log[k].append(("submit", r.rid, r.sample_seed, r.priority))
            elif op == "admit":
                got = sched.admit(lambda r: budget["ok"])
                log[k].append(("admit", [(s, r.rid) for s, r in got]))
                for _, r in got:
                    if r.phase is Ph.PREFILL:
                        r.phase = Ph.DECODE
                        r.out_tokens.append(1)
            elif op == "preempt":
                victim = max((r for r in sched.slots if r is not None),
                             key=lambda r: r.rid)
                log[k].append(("preempt", sched.preempt(victim), victim.rid))
            elif op == "finish":
                r = next(r for r in sched.slots if r is not None)
                log[k].append(("finish", sched.release(r), r.rid))
            else:
                budget["ok"] = op == "unblock"
            log[k].append(("queue", [r.rid for r in sched.queue],
                           sched.next_queued().rid if sched.next_queued() else None))
    assert log["t"] == log["r"]
    t, r = scheds["t"][0], scheds["r"][0]
    assert (t.preemptions, t.admitted_total, t.peak_queue_depth, t.has_work) == \
        (r.preemptions, r.admitted_total, r.peak_queue_depth, r.has_work)
    assert reqs["t"][3].sample_seed == 99 and reqs["t"][0].sample_seed == 0


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
def test_swap_round_trip_into_fresh_ids(kv_precision):
    """swap_out_blocks -> the blocks overwritten -> swap_in_blocks into
    other (fresh) ids restores every byte, scales included, in place; the
    payload equals the reference's on the same pools and keeps the pool's
    dtypes."""
    rng = np.random.default_rng(6)
    nb, bs, H, D = 7, 4, 2, 8
    if kv_precision == "int8":
        arrays = [rng.integers(-127, 128, size=(nb, bs, H, D)).astype(np.int8)
                  for _ in range(2)]
        arrays += [rng.uniform(0.1, 1.0, size=(nb, bs, H)).astype(np.float32)
                   for _ in range(2)]
    else:
        arrays = [rng.normal(size=(nb, bs, H, D)).astype(np.float32) for _ in range(2)]
    ref = rkvc.PagedKVCache(*(jnp.asarray(a) for a in arrays))
    caches = [tkvc.PagedKVCache(*(torch.from_numpy(a.copy()) for a in arrays)),
              tkvc.PagedKVCache(*(torch.from_numpy(a.copy() * 2) for a in arrays))]
    ids, fresh = [3, 1, 5], [6, 2, 4]
    saved = tkvc.swap_out_blocks(caches, ids)
    want = rkvc.swap_out_blocks((ref,), ids)[0]
    assert sorted(saved[0]) == sorted(want)
    for name, w in want.items():
        assert saved[0][name].dtype == caches[0]._asdict()[name].dtype
        np.testing.assert_array_equal(saved[0][name].numpy(), w)
    before = [[t.clone() for t in c if t is not None] for c in caches]
    ptrs = [[t.data_ptr() for t in c if t is not None] for c in caches]
    for c in caches:
        for t in c:
            if t is not None:
                t.zero_()
    tkvc.swap_in_blocks(caches, fresh, saved)
    assert [[t.data_ptr() for t in c if t is not None] for c in caches] == ptrs
    for c, b in zip(caches, before):
        for t, old in zip([t for t in c if t is not None], b):
            np.testing.assert_array_equal(t[fresh].numpy(), old[ids].numpy())
    with pytest.raises(TypeError):
        tkvc.swap_out_blocks([object()], ids)


def _engine(tcfg, tparams, **kw):
    eng = TEngine(tcfg, tparams, device="cpu", **{**KW, **kw})
    eng.warmup()
    return eng


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
def test_preempted_victim_restores_token_identical(models, kv_precision):
    """An interactive arrival preempts the decoding batch request; after
    its KV comes back the victim's tokens equal an undisturbed run's and
    the reference's preempting engine's, with the same swap counts; the
    allocator invariant holds after every tick."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(7)
    batch_p = rng.integers(0, rcfg.vocab, size=6).astype(np.int32)
    inter_p = rng.integers(0, rcfg.vocab, size=4).astype(np.int32)
    kw = dict(KW, kv_precision=kv_precision)
    out = {}
    for name, Eng, Spec in (("ref", REngine, RSpec), ("port", TEngine, RequestSpec)):
        eng = (Eng(rcfg, params=rparams, preempt=True, **kw) if name == "ref"
               else Eng(tcfg, tparams, device="cpu", preempt=True, **kw))
        eng.warmup()
        b = eng.submit(Spec(prompt=batch_p, max_new=10, priority="batch"))
        for _ in range(6):
            eng.tick()
            eng.alloc.check()
        i = eng.submit(Spec(prompt=inter_p, max_new=3, priority="interactive"))
        while eng.tick():
            eng.alloc.check()
        m = eng.metrics
        out[name] = (eng.results[b.rid], eng.results[i.rid], m.preemptions,
                     m.swap_out_blocks, m.swap_in_blocks)
        if name == "port":
            assert m.preemptions >= 1 and m.swap_out_blocks == m.swap_in_blocks > 0
            assert eng.scheduler.preemptions == m.preemptions and b.preemptions >= 1
            assert eng.alloc.in_use == 0 and eng.metrics.cold_compiles == 0
            assert [r.preemptions for r in m.requests if r.rid == b.rid] == [b.preemptions]
            assert "preemptions=" in m.summary()
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])
    assert out["port"][2:] == out["ref"][2:]
    base = _engine(tcfg, tparams, kv_precision=kv_precision)
    bb = base.submit(RequestSpec(prompt=batch_p, max_new=10, priority="batch"))
    np.testing.assert_array_equal(out["port"][0], base.run()[bb.rid])


def test_preemption_with_prefix_and_speculation_restores_token_identical(models):
    """A victim whose prompt was seeded from the prefix cache and which
    decodes speculatively is swapped out (its shared blocks lose only its
    refs) and restored into private blocks: its tokens equal an
    undisturbed run's."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(8)
    pat = rng.integers(0, tcfg.vocab, size=4).astype(np.int32)
    prompt = np.tile(pat, 3)
    kw = dict(slots=1, max_seq=48, block_size=4, num_blocks=30, prefix_cache=True,
              speculative=3)
    eng = _engine(tcfg, tparams, preempt=True, **kw)
    eng.submit(RequestSpec(prompt=prompt, max_new=4, priority="batch"))
    eng.run()
    victim = eng.submit(RequestSpec(prompt=prompt, max_new=14, priority="batch"))
    for _ in range(4):
        eng.tick()
        eng.alloc.check()
    assert victim.cached_tokens > 0 and victim.out_tokens
    eng.submit(RequestSpec(prompt=pat, max_new=3))
    while eng.tick():
        eng.alloc.check()
    assert eng.metrics.preemptions == 1 and eng.metrics.prefix_hits >= 1
    assert eng.alloc.in_use == eng.prefix_cache.cached_blocks
    base = _engine(tcfg, tparams, **kw)
    base.submit(RequestSpec(prompt=prompt, max_new=4))
    bb = base.submit(RequestSpec(prompt=prompt, max_new=14))
    np.testing.assert_array_equal(eng.results[victim.rid], base.run()[bb.rid])


def test_preempt_never_evicts_same_or_higher_class(models):
    """A batch arrival does not preempt a decoding interactive request,
    nor a decoding batch request."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(8)
    for running in ("interactive", "batch"):
        eng = _engine(tcfg, tparams, preempt=True)
        a = eng.submit(RequestSpec(prompt=rng.integers(0, tcfg.vocab, size=4),
                                   max_new=6, priority=running))
        for _ in range(4):
            eng.tick()
        eng.submit(RequestSpec(prompt=rng.integers(0, tcfg.vocab, size=4),
                               max_new=2, priority="batch"))
        eng.run()
        eng.alloc.check()
        assert eng.metrics.preemptions == 0 and a.preemptions == 0
        assert eng.metrics.peak_queue_depth == 1


def test_preempt_and_prefix_cache_refused_on_recurrent_stack(models):
    """A stack with a layer kind other than attention cannot swap or share
    its state through KV blocks: both switches raise."""
    _, _, tcfg, tparams = models

    @dataclasses.dataclass(frozen=True)
    class Hybrid(ArchConfig):
        def layer_kinds(self):
            return ("mamba",) + super().layer_kinds()[1:]

    cfg = Hybrid(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(ArchConfig)})
    for kw in (dict(preempt=True), dict(prefix_cache=True)):
        with pytest.raises(ValueError, match="attention-only"):
            TEngine(cfg, tparams, device="cpu", slots=1, max_seq=32, **kw)


def test_serve_cli_all_flags(models, capsys):
    """`--speculative --temperature 0.8 --preempt --priority-classes
    interactive=0.5,batch=0.5 --prefix-cache --device cpu` serves every
    request its budget, in vocab, and replays; the same flags without
    sampling print the reference CLI's tokens."""
    _, _, tcfg, tparams = models
    argv = ["--arch", ARCH, "--requests", "4", "--slots", "2", "--prompt-len", "8",
            "--gen-len", "5", "--chunk", "4", "--block-size", "4", "--speculative",
            "--preempt", "--priority-classes", "interactive=0.5,batch=0.5",
            "--prefix-cache"]
    sampled = argv + ["--temperature", "0.8", "--top-k", "20", "--top-p", "0.9"]
    a = tserve.main(sampled + ["--device", "cpu"], params=tparams)
    b = tserve.main(sampled + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (4, 5) and bool(((a >= 0) & (a < tcfg.vocab)).all())
    text = capsys.readouterr().out
    assert "sampled=" in text and "verify [2, 3, 5]" in text
    want = rserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit):
        tserve.main(argv + ["--device", "cpu", "--priority-classes", "gold=1"],
                    params=tparams)
