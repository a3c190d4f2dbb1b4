"""The port's speculative decoding against the reference on the CPU
(float32 smoke configs, the reference's weights bridged): the speculative
Engine's tokens equal the reference's speculative Engine's and the port's
non-speculative Engine's (gemma3-1b and qwen3-14b, float and w8a8 with an
int8 KV pool, with an eos, with the prefix cache, under pool pressure with
eviction, at exact max_new budgets), `paged_verify_step` against the
reference's verify pass, and the host decisions (KV rewind, copy-on-write,
refcounted frees, verify buckets, the n-gram drafter, the prefix cache)
equal to the reference's on the same scripts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.cluster.prefix_cache import PrefixCache as RPrefixCache
from repro.models import blocks as RB
from repro.models import model as RM
from repro.serving import kv_cache as rkvc
from repro.serving import speculative as rspec
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.cluster import PrefixCache as TPrefixCache
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving import speculative as tspec
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import RequestSpec as TSpec
from test_torch_dense_archs import build

K = 4
KW = dict(slots=2, max_seq=64, block_size=4, max_chunk=8)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            if arch == "gemma3-1b":
                rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
                rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
                tparams = bridge.params_from_reference(
                    jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
                cache[arch] = (rcfg, rparams, tcfg, tparams)
            else:
                cache[arch] = build(arch)
        return cache[arch]
    return get


def _workload(vocab, seed=0):
    """Repetitive prompts (own-history drafts), a random one, and a repeat
    (corpus drafts of the true continuation)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, vocab, size=3).astype(np.int32)
    return [(np.tile(pat, 4), 10),
            (rng.integers(0, vocab, size=9).astype(np.int32), 7),
            (np.tile(pat, 4), 12),
            (rng.integers(0, vocab, size=5).astype(np.int32), 6)]


def _serve(eng, work, *, eos=None, spec_cls=TSpec, check_every_tick=False):
    eng.warmup()
    reqs = [eng.submit(spec_cls(prompt=p, max_new=g, eos_token=eos)) for p, g in work]
    if check_every_tick:
        while eng.scheduler.has_work:
            assert eng.tick()
            eng.alloc.check()
        res = eng.results
    else:
        res = eng.run()
    eng.alloc.check()
    assert eng.metrics.cold_compiles == 0
    return [res[r.rid] for r in reqs]


def _three_way(models, work, *, eos=None, check_every_tick=False, **kw):
    """Serve `work` on the reference's speculative Engine, the port's
    speculative Engine and the port's plain Engine; assert the tokens equal
    and return (port speculative engine, reference engine)."""
    rcfg, rparams, tcfg, tparams = models
    kw = {**KW, **kw}
    reng = REngine(rcfg, params=rparams, speculative=rspec.SpecConfig(k=K), **kw)
    want = _serve(reng, work, eos=eos, spec_cls=RSpec)
    teng = TEngine(tcfg, tparams, device="cpu", speculative=tspec.SpecConfig(k=K), **kw)
    got = _serve(teng, work, eos=eos, check_every_tick=check_every_tick)
    plain = _serve(TEngine(tcfg, tparams, device="cpu", **kw), work, eos=eos)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    m, rm = teng.metrics, reng.metrics
    assert (m.spec_ticks, m.spec_draft_tokens, m.spec_accepted_tokens, m.decode_steps) == \
        (rm.spec_ticks, rm.spec_draft_tokens, rm.spec_accepted_tokens, rm.decode_steps)
    if teng.prefix_cache is None:
        assert teng.alloc.in_use == 0
    else:
        assert teng.alloc.in_use == teng.prefix_cache.cached_blocks
    return teng, reng


@pytest.mark.parametrize("precision,kv_precision", [("float", "float"), ("w8a8", "int8")])
@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-14b"])
def test_speculative_token_identical(built, arch, precision, kv_precision):
    """Speculation on gives the reference's speculative tokens and the
    port's non-speculative tokens, with the same drafts and acceptances."""
    models = built(arch)
    teng, _ = _three_way(models, _workload(models[2].vocab), precision=precision,
                         kv_precision=kv_precision)
    m = teng.metrics
    assert m.spec_ticks > 0 and 0 < m.spec_accepted_tokens <= m.spec_draft_tokens
    assert m.decode_tok_per_tick > 1.0
    assert "spec_ticks=" in m.summary() and "accept=" in m.summary()
    assert teng.scheduler.queue == [] and teng.metrics.peak_queue_depth == 4


def test_speculative_token_identical_with_eos(built):
    """An eos inside an accepted draft stops the request where the
    non-speculative engine stops."""
    models = built("gemma3-1b")
    tcfg, tparams = models[2], models[3]
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tcfg.vocab, size=8).astype(np.int32)
    [stream] = _serve(TEngine(tcfg, tparams, device="cpu", **KW), [(prompt, 12)])
    eos = int(stream[len(stream) // 2])
    teng, _ = _three_way(models, [(prompt, 12), (prompt, 12)], eos=eos)
    for toks in teng.results.values():
        assert eos in toks.tolist() and toks.tolist().index(eos) == len(toks) - 1


def test_speculative_token_identical_with_prefix_cache(built):
    """Requests seeded from shared blocks speculate past the shared boundary
    and never rewind into a forked block."""
    models = built("gemma3-1b")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, models[2].vocab, size=8).astype(np.int32)
    work = [(shared, 8),
            (np.concatenate([shared, rng.integers(0, models[2].vocab, size=3)
                             .astype(np.int32)]), 8),
            (shared, 8)]
    teng, reng = _three_way(models, work, prefix_cache=True, check_every_tick=True)
    m = teng.metrics
    assert m.prefix_hits > 0 and m.spec_ticks > 0
    assert (m.prefix_lookups, m.prefix_hits, m.prefix_hit_tokens) == \
        (reng.metrics.prefix_lookups, reng.metrics.prefix_hits,
         reng.metrics.prefix_hit_tokens)


def test_speculative_under_pool_pressure_with_eviction(built):
    """A pool tight enough that cached prefixes must be evicted for
    admission: the allocator invariant holds after every tick and the
    tokens equal the reference's."""
    rcfg, rparams, tcfg, tparams = built("gemma3-1b")
    rng = np.random.default_rng(4)
    shared = rng.integers(0, tcfg.vocab, size=8).astype(np.int32)
    work = [(shared, 8)] * 4 + [(rng.integers(0, tcfg.vocab, size=7).astype(np.int32), 8)
                                for _ in range(2)]
    kw = dict(slots=2, max_seq=24, block_size=4, num_blocks=10, max_chunk=8,
              prefix_cache=True)
    reng = REngine(rcfg, params=rparams, speculative=rspec.SpecConfig(k=K), **kw)
    want = _serve(reng, work, spec_cls=RSpec)
    teng = TEngine(tcfg, tparams, device="cpu", speculative=tspec.SpecConfig(k=K), **kw)
    got = _serve(teng, work, check_every_tick=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert len(g) == 8
    assert teng.metrics.spec_ticks > 0
    assert teng.prefix_cache.evicted_blocks == reng.prefix_cache.evicted_blocks > 0


def test_speculative_exact_max_new_budget(built):
    """Corpus drafts make acceptance near total; the per-slot limit still
    ends every request at exactly its budget."""
    models = built("gemma3-1b")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, models[2].vocab, size=6).astype(np.int32)
    budgets = (11, 7, 5, 3)
    teng, _ = _three_way(models, [(prompt, g) for g in budgets], slots=1)
    for rid, g in enumerate(budgets):
        assert len(teng.results[rid]) == g
    assert teng.metrics.spec_accepted_tokens > 0


# -- the verify step against the reference's verify pass -----------------------


def _lived_states(models, lengths, block_size=4, max_blocks=8):
    """The same prompts prefilled into both packages' paged states."""
    rcfg, rparams, tcfg, tparams = models
    B = len(lengths)
    nb = 1 + B * max_blocks
    rstate = RM.init_paged_decode_state(rcfg, B, num_blocks=nb, block_size=block_size,
                                        max_blocks_per_slot=max_blocks)
    tstate = TM.init_paged_decode_state(tcfg, B, num_blocks=nb, block_size=block_size,
                                        max_blocks_per_slot=max_blocks, device="cpu")
    tables = np.arange(1, nb, dtype=np.int32).reshape(B, max_blocks)
    rstate = rstate._replace(block_tables=jnp.asarray(tables))
    tstate.block_tables.copy_(torch.from_numpy(tables))
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for slot, n in enumerate(lengths):
            toks = rng.integers(0, rcfg.vocab, size=(1, n)).astype(np.int32)
            _, rstate = RM.prefill_chunk(rparams, rcfg, rstate, jnp.asarray(toks),
                                         jnp.int32(slot))
            _, tstate = TM.prefill_chunk(tparams, tcfg, tstate,
                                         torch.from_numpy(toks.astype(np.int64)), slot)
    return rstate, tstate


@pytest.mark.parametrize("S", [2, 3, 5])
def test_paged_verify_step_matches_reference(built, S):
    """Logits of the verify pass (the reference's trunk and head at the same
    positions), greedy tokens, accepted counts and lengths, at mixed limits,
    eos ids and active slots; drafts copy the greedy tokens in part so
    acceptance runs stop at different columns."""
    models = built("gemma3-1b")
    rcfg, rparams, tcfg, tparams = models
    lengths = [5, 11, 3, 16]
    B = len(lengths)
    rstate, tstate = _lived_states(models, lengths)
    rng = np.random.default_rng(S)
    tokens = rng.integers(0, rcfg.vocab, size=(B, S)).astype(np.int32)
    # The greedy continuation of each slot's first column, from the port.
    with torch.no_grad():
        probe = TM._verify_trunk(tparams, tcfg, TM.PagedDecodeState(
            caches=[tkvc.PagedKVCache(*(t.clone() if t is not None else None for t in c))
                    for c in tstate.caches],
            block_tables=tstate.block_tables.clone(),
            lengths=tstate.lengths.clone()), torch.from_numpy(tokens.astype(np.int64)))
    g0 = probe.argmax(-1).numpy()
    tokens[0, 1:] = g0[0, :-1]          # slot 0's first draft matches
    tokens[1, 1:2] = g0[1, :1]
    active = np.array([True, True, False, True])
    limits = np.array([S, 2, 1, S], np.int32)
    eos = np.array([-1, -1, -1, int(g0[3, 0])], np.int32)
    positions = rstate.lengths[:, None] + jnp.arange(S, dtype=jnp.int32)[None, :]
    x = RM._embed_tokens(rparams, rcfg, jnp.asarray(tokens))
    x, _ = RM._trunk_step(rparams, rcfg, x, positions, rstate.caches, rstate.lengths,
                          rstate.block_tables, collect_states=True)
    want_logits = np.asarray(RM._unembed(RB._norm(x, rparams["final_norm"], rcfg),
                                         rparams, rcfg))
    greedy, n_new, new_r = RM.paged_verify_step(
        rparams, rcfg, rstate, jnp.asarray(tokens), jnp.asarray(active),
        jnp.asarray(limits), jnp.asarray(eos))
    args = [torch.from_numpy(a) for a in (tokens.astype(np.int64), active, limits, eos)]
    with torch.no_grad():
        logits = TM._verify_trunk(tparams, tcfg, TM.PagedDecodeState(
            caches=[tkvc.PagedKVCache(*(t.clone() if t is not None else None for t in c))
                    for c in tstate.caches],
            block_tables=tstate.block_tables, lengths=tstate.lengths.clone()), args[0])
        tg, tn, new_t = TM.paged_verify_step(tparams, tcfg, tstate, *args)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=3e-4, atol=3e-4)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(greedy))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n_new))
    np.testing.assert_array_equal(new_t.lengths.numpy(), np.asarray(new_r.lengths))
    n = tn.numpy()
    assert n[2] == 0 and n[1] <= 2 and n[3] == 1 and n[0] >= 2


def test_verify_launch_plans_are_row_invariant(monkeypatch):
    """What keeps speculative tokens identical to decode tokens on the
    card: K1's plan splits K the same way at every M up to 64 rows (the
    verify steps' M = 16, 24, 40 as the decode step's M = 8), and K2 takes
    the split count of one position for a step of up to 16 positions per
    slot, on gemma3-1b's and qwen3-14b's shapes at 132 SMs."""
    from repro_torch.kernels import flash_decode as tfd
    from repro_torch.kernels import gemm as tgemm

    for K, N, kmajor in [(1152, 1024, False), (1152, 256, False), (1024, 1152, False),
                         (1152, 6912, False), (6912, 1152, False), (1152, 262144, True),
                         (5120, 1024, False), (17408, 5120, False), (5120, 151936, False)]:
        for eb in (2, 4, 1):
            one = tgemm.gemm_plan(1, N, K, kmajor, 132, eb)
            for M in range(2, 65):
                plan = tgemm.gemm_plan(M, N, K, kmajor, 132, eb)
                assert (plan.splits, plan.kps, plan.bk) == (one.splits, one.kps, one.bk), (M, K, N)
    monkeypatch.setitem(tfd._SM_COUNT, 0, 132)
    tables = torch.zeros((8, 75), dtype=torch.int32)
    for hq, hkv in ((4, 1), (40, 8)):
        want = tfd.decode_splits(8, hkv, 1, 75, 132)
        for sq in range(1, tfd.INVARIANT_SQ + 1):
            q = torch.zeros((8, sq, hq, 16))
            assert _launch_splits_on(tfd, q, tables, hkv) == want, (hq, sq)
        assert _launch_splits_on(tfd, torch.zeros((1, 64, hq, 16)), tables[:1], hkv) == \
            tfd.decode_splits(1, hkv, hq // hkv * 64 // 16, 75, 132)


def _launch_splits_on(tfd, q, tables, hkv):
    """`launch_splits` for shapes only, with the SM count of device 0."""
    class Dev:
        index = 0
    q = type("Q", (), {"shape": q.shape, "device": Dev()})()
    return tfd.launch_splits(q, tables, hkv)


def test_verify_refuses_recurrent_state(built):
    """The seam that selects each recurrent layer's state at the accepted
    position (tests/test_torch_families.py holds it against the reference)
    refuses a cache that is neither a paged pool nor a recurrent state it
    knows."""
    _, _, tcfg, tparams = built("gemma3-1b")
    state = TM.init_paged_decode_state(tcfg, 1, num_blocks=3, block_size=4,
                                       max_blocks_per_slot=2, device="cpu")
    state.caches[0] = object()
    with pytest.raises(NotImplementedError, match="recurrent"):
        TM._commit_verified(state, [], torch.ones(1, dtype=torch.bool),
                            torch.zeros(1, dtype=torch.int64))


# -- host decisions equal to the reference's ----------------------------------


def _pools(slots=2, blocks=10, bs=4, max_blocks=6):
    return ((rkvc.BlockAllocator(blocks, bs), rkvc.BlockTables(slots, max_blocks)),
            (tkvc.BlockAllocator(blocks, bs), tkvc.BlockTables(slots, max_blocks)))


def _same(r, t):
    (ra, rt), (ta, tt) = r, t
    np.testing.assert_array_equal(tt.table, np.asarray(rt.table))
    assert tt.blocks == rt.blocks
    assert (ta.in_use, ta.available, ta.reserved) == (ra.in_use, ra.available, ra.reserved)
    assert {b: ta.refcount(b) for b in range(ta.num_blocks)} == \
        {b: ra.refcount(b) for b in range(ra.num_blocks)}
    ta.check()


def _both(r, t, fn):
    got, want = fn(*t), fn(*r)
    assert got == want
    _same(r, t)
    return got


@pytest.mark.parametrize("script", [
    # reject all (rewind 9 -> 5 tokens), accept all (a no-op), release
    [("reserve", 4), ("ensure", 0, 9), ("rewind", 0, 5, True), ("rewind", 0, 8, True),
     ("release", 0)],
    # across several block boundaries, without re-reservation
    [("ensure", 0, 24), ("rewind", 0, 4, False), ("ensure", 1, 20), ("release", 0),
     ("release", 1)],
    # partial rewinds inside and at block edges, with growth between
    [("reserve", 6), ("ensure", 0, 13), ("rewind", 0, 10, True), ("ensure", 0, 17),
     ("rewind", 0, 12, True), ("ensure", 1, 6), ("rewind", 1, 1, True), ("release", 1)],
], ids=["reject-accept-all", "block-boundaries", "partial"])
def test_rewind_matches_reference(script):
    r, t = _pools()
    for op, *a in script:
        if op == "reserve":
            _both(r, t, lambda al, tb: al.reserve(a[0]))
        elif op == "ensure":
            _both(r, t, lambda al, tb: tb.ensure(a[0], a[1], al))
        elif op == "rewind":
            _both(r, t, lambda al, tb: tb.rewind(a[0], a[1], al, rereserve=a[2]))
        else:
            _both(r, t, lambda al, tb: tb.release(a[0], al, unreserve=al.reserved))
    with pytest.raises(ValueError):
        t[1].rewind(0, 40, t[0])


@pytest.mark.parametrize("length", [6, 4, 0])
def test_rewind_of_a_forked_block_matches_reference(length):
    """Copy-then-rewind: a partial shared tail diverges into a private
    block (the same (src, dst) pair as the reference), an aligned one stays
    shared; the other owner's row is untouched."""
    r, t = _pools()
    _both(r, t, lambda al, tb: tb.ensure(0, 12, al))
    for al, tb, kvc in ((*r, rkvc), (*t, tkvc)):
        tb.seed(1, kvc.fork_blocks(al, list(tb.blocks[0])))
    _same(r, t)
    freed, pair = _both(r, t, lambda al, tb: tb.rewind(1, length, al, rereserve=False))
    assert (pair is not None) == (length % 4 != 0)
    with pytest.raises(RuntimeError):
        t[1].seed(0, [1])                          # seed only an empty row


def test_free_rereserve_skips_shared_blocks():
    r, t = _pools(blocks=6)
    ids = _both(r, t, lambda al, tb: al.alloc(2, reserved=False))
    for al, kvc in ((r[0], rkvc), (t[0], tkvc)):
        kvc.fork_blocks(al, ids[:1])
    assert _both(r, t, lambda al, tb: al.free(ids, rereserve=True)) == 1
    assert t[0].reserved == 1
    with pytest.raises(ValueError):
        t[0].ref([5])                              # not allocated
    with pytest.raises(ValueError):
        t[0].free([ids[1]])                        # double free


def test_copy_blocks_matches_reference():
    rng = np.random.default_rng(6)
    nb, bs, H, D = 6, 4, 2, 8
    k, v = (rng.normal(size=(nb, bs, H, D)).astype(np.float32) for _ in range(2))
    ks, vs = (rng.uniform(0.1, 1, size=(nb, bs, H)).astype(np.float32) for _ in range(2))
    src, dst = [2, 4], [5, 1]
    want = rkvc.copy_blocks(rkvc.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v),
                                              k_scale=jnp.asarray(ks),
                                              v_scale=jnp.asarray(vs)),
                            jnp.asarray(src), jnp.asarray(dst))
    cache = tkvc.PagedKVCache(*(torch.from_numpy(a.copy()) for a in (k, v, ks, vs)))
    ptrs = [t.data_ptr() for t in cache]
    got = tkvc.copy_blocks(cache, src, dst)
    assert [t.data_ptr() for t in got] == ptrs     # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_verify_buckets_and_coerce_spec_match_reference():
    for k in range(1, 17):
        assert tspec.verify_buckets(k) == rspec.verify_buckets(k)
        for d in range(1, k + 1):
            assert tspec.bucket_for(d, k) == rspec.bucket_for(d, k)
    assert tspec.verify_buckets(4) == [2, 3, 5]
    for value in (None, False, True, 3):
        got, want = tspec.coerce_spec(value), rspec.coerce_spec(value)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.k, got.ngram_min, got.ngram_max, got.corpus_size) == \
                (want.k, want.ngram_min, want.ngram_max, want.corpus_size)
    for bad in ("yes", 1.5):
        with pytest.raises(TypeError):
            tspec.coerce_spec(bad)
    for kw in (dict(k=0), dict(ngram_min=3, ngram_max=2), dict(corpus_size=-1)):
        with pytest.raises(ValueError):
            tspec.SpecConfig(**kw)
    with pytest.raises(ValueError):
        tspec.bucket_for(5, 4)


def test_ngram_drafter_matches_reference():
    """Random repetitive histories over a small alphabet, with a rotating
    corpus: the same drafts and lookup counters as the reference's."""
    rng = np.random.default_rng(8)
    cfg = dict(k=4, ngram_min=2, ngram_max=3, corpus_size=3)
    rd, td = rspec.NgramDrafter(rspec.SpecConfig(**cfg)), tspec.NgramDrafter(tspec.SpecConfig(**cfg))
    for i in range(200):
        ctx = rng.integers(0, 6, size=int(rng.integers(1, 30))).astype(np.int32)
        k = int(rng.integers(0, 6))
        np.testing.assert_array_equal(td.draft(ctx, k=k), rd.draft(ctx, k=k))
        if i % 7 == 0:
            stream = rng.integers(0, 6, size=20).astype(np.int32)
            rd.remember(stream)
            td.remember(stream)
    assert (td.draft_calls, td.draft_hits, td.drafted_tokens) == \
        (rd.draft_calls, rd.draft_hits, rd.drafted_tokens)
    assert td.draft_hits > 20 and td.hit_rate == rd.hit_rate


def test_prefix_cache_matches_reference():
    """lookup / insert / evict / clear on the same allocator script: the
    same blocks, counts, stats and refcounts."""
    bs = 4
    ra, ta = rkvc.BlockAllocator(20, bs), tkvc.BlockAllocator(20, bs)
    rc, tc = RPrefixCache(ra, max_blocks=6), TPrefixCache(ta, max_blocks=6)
    rng = np.random.default_rng(9)
    base = rng.integers(0, 50, size=24).astype(np.int32)
    prompts = [base[:13], base[:9], np.concatenate([base[:8], [7, 7, 7, 7, 1]]),
               base[:24], base[:3], np.concatenate([base[:4], base[:20]])]
    for p in prompts:
        got, want = tc.lookup(p), rc.lookup(p)
        assert got == want
        n_full = len(p) // bs
        if n_full:
            rb, tb = ra.alloc(n_full, reserved=False), ta.alloc(n_full, reserved=False)
            assert rb == tb
            assert tc.insert(p[:n_full * bs], tb) == rc.insert(p[:n_full * bs], rb)
            ra.free(rb)
            ta.free(tb)
        assert (tc.cached_blocks, tc.hits, tc.hit_tokens, tc.evicted_blocks) == \
            (rc.cached_blocks, rc.hits, rc.hit_tokens, rc.evicted_blocks)
        assert ta.in_use == ra.in_use
        ta.check()
    assert tc.hits > 0 and tc.evicted_blocks > 0
    assert tc.evict(2) == rc.evict(2)
    with pytest.raises(ValueError):
        tc.insert(base[:5], [1])
    assert tc.clear() == rc.clear() and ta.in_use == 0
    assert repr(tc) == repr(rc) and tc.hit_rate == rc.hit_rate
