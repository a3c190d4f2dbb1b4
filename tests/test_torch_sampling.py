"""The port's sampling head on the CPU: `_adjusted_logits` equal to the
reference's within 1e-6 (rows with ties, top-k and top-p edges), greedy
rows exact argmax, the counter-based stream a pure function of (seed,
index) whatever the batch, the empirical law of `sample_tokens` and of the
verify-sample step's emitted positions within the reference test's
total-variation bar of softmax(adjusted), and the Engine: greedy traffic
identical with sampling on, greedy rows of mixed batches identical,
seeded runs reproducible, different seeds divergent, sampling under
speculation (gemma3-1b smoke, float32, the reference's weights bridged).
The reference's threefry keys are not matched: sampled tokens are held to
distributions, not bits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import RequestSpec as TSpec
from repro_torch.serving.request import SamplingParams

ARCH = "gemma3-1b"
TV_BAR = 0.05                       # tests/test_scheduling.py's bar
KW = dict(slots=2, max_seq=48, block_size=4, max_chunk=8)


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


def _tv(tokens, probs) -> float:
    emp = np.bincount(np.asarray(tokens), minlength=len(probs)) / len(tokens)
    return 0.5 * float(np.abs(emp - probs).sum())


def _softmax(x):
    x = np.asarray(x, np.float64)
    e = np.exp(x - x[np.isfinite(x)].max())
    e[~np.isfinite(x)] = 0.0
    return e / e.sum()


def _assert_adjusted_close(got, want):
    """Within 1e-6 of the reference: the adjusted log-probs on the common
    support, and softmax of each (the sampling law).  The kept sets may
    differ only in tokens whose mass is below float32's resolution of the
    running sum: where the exclusive cumsum of the sorted probabilities
    saturates (top_p = 1 at a low temperature), XLA's windowed f32 cumsum
    and torch's scan round it at different tokens."""
    fg, fw = np.isfinite(got), np.isfinite(want)
    both = fg & fw
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-6)
    pg = torch.softmax(torch.from_numpy(got), -1).numpy()
    pw = torch.softmax(torch.from_numpy(want.copy()), -1).numpy()
    np.testing.assert_allclose(pg, pw, rtol=0, atol=1e-6)
    assert (pg[fg & ~fw].max(initial=0.0), pw[fw & ~fg].max(initial=0.0)) < (1e-6, 1e-6)
    assert fg.sum(axis=-1).min() >= 1
    return int((fg != fw).sum())


def _knob_rows(rng, R, V):
    temp = rng.choice([0.0, 0.5, 1.0, 1.7], size=R).astype(np.float32)
    top_k = rng.choice([0, 1, 2, 3, 5, V, V + 4], size=R).astype(np.int32)
    top_p = rng.choice([1.0, 0.95, 0.6, 0.3, 1e-3], size=R).astype(np.float32)
    return temp, top_k, top_p


@pytest.mark.parametrize("kind", ["random", "ties", "flat", "peaked"])
def test_adjusted_logits_matches_reference(kind):
    """Every knob combination (greedy rows, k = 1 and k past V, top-p that
    keeps only the first token or everything) on rows whose values tie at
    the top-k threshold, all equal, or one dominant."""
    rng = np.random.default_rng({"random": 0, "ties": 1, "flat": 2, "peaked": 3}[kind])
    R, V = 64, 24
    if kind == "random":
        logits = rng.normal(size=(R, V)) * 3
    elif kind == "ties":
        logits = rng.integers(-3, 4, size=(R, V)).astype(np.float64)
    elif kind == "flat":
        logits = np.full((R, V), 0.25)
    else:
        logits = rng.normal(size=(R, V))
        logits[np.arange(R), rng.integers(0, V, size=R)] = 12.0
    logits = logits.astype(np.float32)
    temp, top_k, top_p = _knob_rows(rng, R, V)
    want = np.asarray(RM._adjusted_logits(jnp.asarray(logits), temp, top_k, top_p))
    got = TM._adjusted_logits(torch.from_numpy(logits), torch.from_numpy(temp),
                              torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    differ = _assert_adjusted_close(got, want)
    assert differ <= 16                  # a few saturated tail tokens at most
    if kind != "random":
        assert differ == 0


def test_adjusted_logits_bf16_and_3d_match_reference():
    """bf16 logits (upcast exactly) over (B, S, V) with per-row knobs
    broadcast over S, as the verify-sample step calls it."""
    rng = np.random.default_rng(4)
    B, S, V = 3, 4, 40
    logits = torch.from_numpy(rng.normal(size=(B, S, V)).astype(np.float32)).to(torch.bfloat16)
    temp, top_k, top_p = (np.repeat(a[:, None], S, axis=1) for a in _knob_rows(rng, B, V))
    want = np.asarray(RM._adjusted_logits(
        jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16), temp, top_k, top_p))
    got = TM._adjusted_logits(logits, torch.from_numpy(temp), torch.from_numpy(top_k),
                              torch.from_numpy(top_p)).numpy()
    _assert_adjusted_close(got, want)


def _sample(logits, seeds, gen_idx, temp, top_k, top_p):
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt)
    return TM.sample_tokens(t(logits, torch.float32), t(seeds, torch.int64),
                            t(gen_idx, torch.int64), t(temp, torch.float32),
                            t(top_k, torch.int64), t(top_p, torch.float32)).numpy()


def test_sample_tokens_greedy_rows_exact_argmax():
    """temperature 0 is argmax (the first of tied maxima), and so is top-k
    1 at any temperature on rows without a tie at the top (tied maxima all
    survive top-k); greedy rows beside sampled rows in one batch too."""
    rng = np.random.default_rng(0)
    N, V = 64, 32
    logits = rng.normal(size=(N, V)).astype(np.float32)
    logits[:8, :4] = 5.0                            # ties: the first index wins
    seeds, idx = np.arange(N), np.zeros(N)
    want = np.argmax(logits, -1)
    np.testing.assert_array_equal(
        _sample(logits, seeds, idx, np.zeros(N), np.zeros(N), np.ones(N)), want)
    np.testing.assert_array_equal(
        _sample(logits, seeds, idx, np.full(N, 2.0), np.ones(N), np.ones(N))[8:], want[8:])
    temp = np.where(np.arange(N) % 2, 1.5, 0.0)
    got = _sample(logits, seeds, idx, temp, np.zeros(N), np.ones(N))
    np.testing.assert_array_equal(got[::2], want[::2])
    assert (got[1::2] != want[1::2]).any()


def test_sample_tokens_topk_topp_mask_and_distribution():
    """Truncated tokens never appear; 4096 draws (seeds 0..4095) of the
    untruncated and of the truncated distribution land within the TV bar
    of softmax(adjusted)."""
    rng = np.random.default_rng(1)
    V, N = 8, 4096
    row = rng.normal(size=V).astype(np.float32)
    logits = np.tile(row, (N, 1))
    seeds, idx = np.arange(N), np.zeros(N)
    toks = _sample(logits, seeds, idx, np.ones(N), np.full(N, 3), np.ones(N))
    assert set(toks.tolist()) <= set(np.argsort(row)[-3:].tolist())
    p = 0.6
    probs = _softmax(row)
    keep, mass = set(), 0.0
    for t in np.argsort(-probs):                    # exclusive-cumsum nucleus
        keep.add(int(t))
        mass += probs[t]
        if mass >= p:
            break
    toks_p = _sample(logits, seeds, idx, np.ones(N), np.zeros(N), np.full(N, p))
    assert set(toks_p.tolist()) <= keep
    toks_f = _sample(logits, seeds, idx, np.ones(N), np.zeros(N), np.ones(N))
    assert _tv(toks_f, probs) < TV_BAR
    for temp, k, tp in ((0.8, 5, 0.95), (1.3, 0, 0.8)):
        adj = TM._adjusted_logits(torch.from_numpy(row), temp, k, tp).numpy()
        toks = _sample(logits, seeds, idx, np.full(N, temp), np.full(N, k), np.full(N, tp))
        assert _tv(toks, _softmax(adj)) < TV_BAR


def test_stream_depends_only_on_seed_and_index():
    """The keys and a row's draw are the same alone and inside any batch;
    distinct indices of one seed give distinct keys; other seeds give other
    streams; the uniforms are in (0, 1) and even."""
    one = TM._fold_keys(torch.tensor([7]), torch.tensor([3]))
    many = TM._fold_keys(torch.tensor([1, 7, 9]), torch.tensor([0, 3, 5]))
    assert int(one[0]) == int(many[1])
    keys = TM._fold_keys(torch.full((4096,), 11), torch.arange(4096))
    assert len(set(keys.tolist())) == 4096
    assert (keys != TM._fold_keys(torch.full((4096,), 12), torch.arange(4096))).float().mean() > 0.99
    u = TM._uniform(TM._fold_keys(torch.arange(50000) % 97, torch.arange(50000) // 97))
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    hist = np.bincount((u.numpy() * 10).astype(int), minlength=10) / 50000
    assert np.abs(hist - 0.1).max() < 0.01
    rng = np.random.default_rng(2)
    V = 16
    rows = rng.normal(size=(5, V)).astype(np.float32)
    alone = _sample(rows[2:3], [42], [6], [1.0], [0], [1.0])
    batch = _sample(rows, [1, 3, 42, 5, 9], [0, 1, 6, 2, 3], [0.9, 0, 1.0, 1, 2],
                    [0, 0, 0, 2, 0], [1, 1, 1.0, 0.5, 1])
    assert alone[0] == batch[2]


def test_verify_sample_tail_law_of_emitted_positions():
    """Rejection sampling against a point-mass drafter: over 4096 seeds the
    first emitted position is distributed as p~ of position 0 whatever the
    draft, and the second, where the first draft was kept, as p~ of
    position 1, each within the TV bar, at plain and truncated knobs;
    n_new stops at limits and eos."""
    rng = np.random.default_rng(3)
    N, S, V = 4096, 3, 8
    base = rng.normal(size=(S, V)).astype(np.float32)
    base[0, 2] += 1.5                                # draft 1 likely enough
    logits = torch.from_numpy(np.tile(base, (N, 1, 1)))
    tokens = torch.tensor([[0, 2, 5]] * N)
    active = torch.ones(N, dtype=torch.bool)
    limits = torch.full((N,), S, dtype=torch.int32)
    no_eos = torch.full((N,), -1, dtype=torch.int32)
    seeds, idx = torch.arange(N), torch.zeros(N, dtype=torch.int64)
    for temp, k, tp in ((1.0, 0, 1.0), (0.8, 5, 0.95)):
        knobs = (torch.full((N,), temp), torch.full((N,), k), torch.full((N,), tp))
        out, n_new = TM._verify_sample_tail(logits, tokens, active, limits, no_eos,
                                            *knobs, seeds, idx)
        adj = TM._adjusted_logits(torch.from_numpy(base), temp, k, tp).numpy()
        assert _tv(out[:, 0].numpy(), _softmax(adj[0])) < TV_BAR
        kept = (n_new >= 2).numpy()
        assert kept.sum() > N // 4
        assert _tv(out[kept, 1].numpy(), _softmax(adj[1])) < TV_BAR
        assert bool((n_new >= 1).all() and (n_new <= S).all())
        # the same seeds replay the same tokens
        again, _ = TM._verify_sample_tail(logits, tokens, active, limits, no_eos,
                                          *knobs, seeds, idx)
        assert torch.equal(out, again)
    limits1 = torch.ones(N, dtype=torch.int32)
    _, n1 = TM._verify_sample_tail(logits, tokens, active, limits1, no_eos,
                                   *knobs, seeds, idx)
    assert bool((n1 == 1).all())
    eos = out[:, 0].to(torch.int32)
    _, ne = TM._verify_sample_tail(logits, tokens, active, limits, eos, *knobs, seeds, idx)
    assert bool((ne == 1).all())
    inactive = torch.zeros(N, dtype=torch.bool)
    _, n0 = TM._verify_sample_tail(logits, tokens, inactive, limits, no_eos, *knobs,
                                   seeds, idx)
    assert bool((n0 == 0).all())


def _lived_state(tcfg, tparams, lengths, bs=4, max_blocks=8):
    B = len(lengths)
    nb = 1 + B * max_blocks
    state = TM.init_paged_decode_state(tcfg, B, num_blocks=nb, block_size=bs,
                                       max_blocks_per_slot=max_blocks, device="cpu")
    state.block_tables.copy_(torch.arange(1, nb, dtype=torch.int32).reshape(B, max_blocks))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for slot, n in enumerate(lengths):
            toks = torch.randint(0, tcfg.vocab, (1, n), generator=g)
            _, state = TM.prefill_chunk(tparams, tcfg, state, toks, slot)
    return state


def _clone(state):
    return TM.PagedDecodeState(
        caches=[type(c)(*(t.clone() if t is not None else None for t in c))
                for c in state.caches],
        block_tables=state.block_tables.clone(), lengths=state.lengths.clone())


@pytest.mark.parametrize("S", [2, 5])
def test_verify_sample_step_greedy_rows_equal_verify_step(models, S):
    """Greedy rows of the verify-sample step (temperature 0, in an
    all-greedy batch and beside a sampled row) commit what
    `paged_verify_step` commits; lengths advance by n_new."""
    _, _, tcfg, tparams = models
    state = _lived_state(tcfg, tparams, [6, 9, 3])
    B = 3
    tokens = torch.zeros((B, S), dtype=torch.int64)
    with torch.no_grad():
        for j in range(1, S):      # drafts = each slot's greedy continuation
            tokens[:, j] = TM._verify_trunk(tparams, tcfg, _clone(state),
                                            tokens).argmax(-1)[:, j - 1]
    tokens[1, 1] = (tokens[1, 1] + 1) % tcfg.vocab    # slot 1 rejects at once
    active = torch.tensor([True, True, True])
    limits = torch.tensor([S, S, 2], dtype=torch.int32)
    eos = torch.full((B,), -1, dtype=torch.int32)
    with torch.no_grad():
        want_out, want_n, _ = TM.paged_verify_step(tparams, tcfg, _clone(state), tokens,
                                                   active, limits, eos)
        for temp in ([0.0, 0.0, 0.0], [0.0, 1.0, 0.0]):
            out, n_new, new = TM.paged_verify_sample_step(
                tparams, tcfg, _clone(state), tokens, active, limits, eos,
                torch.tensor(temp), torch.zeros(B, dtype=torch.int64), torch.ones(B),
                torch.arange(B), torch.zeros(B, dtype=torch.int64))
            greedy = [i for i, t in enumerate(temp) if t == 0.0]
            for i in greedy:
                n = int(want_n[i])
                assert int(n_new[i]) == n
                assert torch.equal(out[i, :n], want_out[i, :n])
            assert torch.equal(new.lengths, state.lengths + n_new)
    assert int(want_n[0]) == S and int(want_n[1]) == 1 and int(want_n[2]) == 2


# -- the engine ------------------------------------------------------------------


def _run(tcfg, tparams, work, **kw):
    eng = TEngine(tcfg, tparams, device="cpu", **{**KW, **kw})
    eng.warmup()
    reqs = [eng.submit(spec) for spec in work]
    out = eng.run()
    eng.alloc.check()
    assert eng.alloc.in_use == 0
    return [out[r.rid] for r in reqs], eng


def _prompts(vocab, n, seed, size=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=size).astype(np.int32) for _ in range(n)]


def test_greedy_traffic_identical_with_sampling_on(models):
    """An all-greedy workload on a sampling engine takes the greedy steps:
    the reference's tokens, and no token from the sampling head."""
    rcfg, rparams, tcfg, tparams = models
    prompts = _prompts(rcfg.vocab, 3, seed=3)
    reng = REngine(rcfg, params=rparams, **KW)
    reng.warmup()
    rreqs = [reng.submit(RSpec(prompt=p, max_new=4)) for p in prompts]
    want = reng.run()
    got, eng = _run(tcfg, tparams, [TSpec(prompt=p, max_new=4) for p in prompts],
                    sampling=True)
    for r, g in zip(rreqs, got):
        np.testing.assert_array_equal(g, want[r.rid])
    assert eng.metrics.sampled_tokens == 0 and eng.metrics.cold_compiles == 0
    assert {"decode_sample", "sample1"} <= eng._warmed


def test_sampling_seeded_reproducible_and_divergent(models):
    _, _, tcfg, tparams = models
    prompts = _prompts(tcfg.vocab, 2, seed=4)

    def run(seed):
        sp = SamplingParams(temperature=0.9, top_k=24, top_p=0.95, seed=seed)
        out, eng = _run(tcfg, tparams, [TSpec(prompt=p, max_new=5, sampling=sp)
                                        for p in prompts], sampling=True)
        assert eng.metrics.sampled_tokens == sum(len(t) for t in out)
        assert eng.metrics.cold_compiles == 0
        return out

    a, b, c = run(11), run(11), run(12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_mixed_batch_keeps_greedy_rows_identical(models):
    _, _, tcfg, tparams = models
    gp, sp_prompt = _prompts(tcfg.vocab, 2, seed=5)
    [solo], _ = _run(tcfg, tparams, [TSpec(prompt=gp, max_new=5)])
    (mixed, _), eng = _run(tcfg, tparams, [
        TSpec(prompt=gp, max_new=5),
        TSpec(prompt=sp_prompt, max_new=5, sampling=SamplingParams(temperature=1.0, seed=2))],
        sampling=True)
    np.testing.assert_array_equal(mixed, solo)
    assert eng.metrics.sampled_tokens > 0


def test_sampled_stream_independent_of_batch_neighbours(models):
    """A seeded request draws the same tokens beside one greedy neighbour
    or another: its stream is (seed, index), not the batch."""
    _, _, tcfg, tparams = models
    a, b, c = _prompts(tcfg.vocab, 3, seed=6)
    sp = SamplingParams(temperature=1.2, top_p=0.9, seed=77)
    (x, _), _ = _run(tcfg, tparams, [TSpec(prompt=a, max_new=6, sampling=sp),
                                     TSpec(prompt=b, max_new=6)], sampling=True)
    (y, _), _ = _run(tcfg, tparams, [TSpec(prompt=a, max_new=6, sampling=sp),
                                     TSpec(prompt=c, max_new=3)], sampling=True)
    np.testing.assert_array_equal(x, y)


def test_sampling_under_speculation_reproducible(models):
    """Sampled and greedy requests with speculation on finish their
    budgets, replay with the same seeds, and the greedy ones keep the
    non-speculative greedy tokens."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(7)
    pat = rng.integers(0, tcfg.vocab, size=3).astype(np.int32)
    sp = SamplingParams(temperature=0.7, top_k=8, seed=5)
    work = [TSpec(prompt=np.tile(pat, 4), max_new=10, sampling=sp),
            TSpec(prompt=np.tile(pat, 4), max_new=10),
            TSpec(prompt=np.tile(pat, 4), max_new=9, sampling=sp)]
    a, eng = _run(tcfg, tparams, work, sampling=True, speculative=4)
    b, _ = _run(tcfg, tparams, work, sampling=True, speculative=4)
    plain, _ = _run(tcfg, tparams, work[1:2])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a[1], plain[0])
    assert [len(t) for t in a] == [10, 10, 9]
    m = eng.metrics
    assert m.spec_ticks > 0 and m.sampled_tokens > 0 and m.cold_compiles == 0
    assert any(k.startswith("verify_sample") for k in eng._warmed)


def test_sampled_request_without_sampling_warmup_runs_cold(models):
    """A sampled request on an engine warmed without sampling still
    serves: its two sampling shapes run cold once each, and its tokens
    equal a sampling engine's."""
    _, _, tcfg, tparams = models
    [p] = _prompts(tcfg.vocab, 1, seed=8)
    work = [TSpec(prompt=p, max_new=4, sampling=SamplingParams(temperature=1.0, seed=1))]
    cold, eng = _run(tcfg, tparams, work)
    warm, _ = _run(tcfg, tparams, work, sampling=True)
    np.testing.assert_array_equal(cold[0], warm[0])
    assert eng.metrics.cold_compiles == 2
