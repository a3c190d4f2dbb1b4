"""The port's Engine on the recurrent, hybrid and MoE families against the
reference on the CPU (smoke configs, float32, the reference's weights
bridged): greedy tokens identical to the reference Engine for jamba,
xlstm, dbrx and arctic with more requests than slots (so refilled slots
run the reset of their recurrent state); speculative tokens identical to
the reference's speculative Engine and the port's plain one, and w8a8
tokens identical to the reference's w8a8 Engine, for jamba and xlstm; the
engine's accounting of pools and recurrent state; preemption and the
prefix cache refused on recurrent stacks; and the serve CLI for `--arch
jamba-1.5-large-398b`."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import model as RM
from repro.serving import speculative as rspec
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import ssm as TS
from repro_torch.serving import speculative as tspec
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import RequestSpec as TSpec
from test_torch_families import ARCHS, build

KW = dict(slots=2, max_seq=48, block_size=4, max_chunk=8)


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
            cache[arch] = build(arch)
        return cache[arch]
    return get


def _workload(vocab, seed=0):
    """Five requests over two slots: a repetitive prompt (own-history
    drafts), random ones, and a repeat of the first after it finished
    (drafts of its true continuation from the corpus); unequal budgets."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, vocab, size=3).astype(np.int32)
    return [(np.tile(pat, 4), 6),
            (rng.integers(0, vocab, size=9).astype(np.int32), 9),
            (np.tile(pat, 4), 8),
            (rng.integers(0, vocab, size=5).astype(np.int32), 5),
            (rng.integers(0, vocab, size=13).astype(np.int32), 4)]


def _serve(eng, work, spec_cls=TSpec):
    eng.warmup()
    reqs = [eng.submit(spec_cls(prompt=p, max_new=g)) for p, g in work]
    res = eng.run()
    assert eng.metrics.cold_compiles == 0
    return [res[r.rid] for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_token_identical_to_reference(built, arch):
    rcfg, rparams, tcfg, tparams = built(arch)
    work = _workload(rcfg.vocab)
    reng = REngine(rcfg, params=rparams, **KW)
    want = _serve(reng, work, RSpec)
    teng = TEngine(tcfg, tparams, device="cpu", **KW)
    got = _serve(teng, work)
    for w, g, (_, n) in zip(want, got, work):
        np.testing.assert_array_equal(g, w)
        assert len(g) == n
    m, rm = teng.metrics, reng.metrics
    assert (m.prefill_chunks, m.decode_steps) == (rm.prefill_chunks, rm.decode_steps)
    assert m.kv_pool_bytes == rm.kv_pool_bytes
    assert teng.alloc.in_use == 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_speculative_token_identical(built, arch):
    """Speculation on (k = 4) gives the reference's speculative tokens, with
    the same drafts, acceptances and ticks, and the port's non-speculative
    tokens: verify commits each slot's recurrent state at its accepted
    position."""
    rcfg, rparams, tcfg, tparams = built(arch)
    work = _workload(rcfg.vocab, seed=1)
    reng = REngine(rcfg, params=rparams, speculative=rspec.SpecConfig(k=4), **KW)
    want = _serve(reng, work, RSpec)
    teng = TEngine(tcfg, tparams, device="cpu", speculative=tspec.SpecConfig(k=4), **KW)
    got = _serve(teng, work)
    plain = _serve(TEngine(tcfg, tparams, device="cpu", **KW), work)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)
    m, rm = teng.metrics, reng.metrics
    assert (m.spec_ticks, m.spec_draft_tokens, m.spec_accepted_tokens, m.decode_steps) == \
        (rm.spec_ticks, rm.spec_draft_tokens, rm.spec_accepted_tokens, rm.decode_steps)
    assert m.spec_ticks > 0 and m.spec_accepted_tokens > 0


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-1.3b"])
def test_engine_w8a8_token_identical_to_reference(built, arch):
    """w8a8 weights (an int8 KV pool where the stack has attention): tokens
    identical to the reference's w8a8 Engine, the same weight bytes."""
    rcfg, rparams, tcfg, tparams = built(arch)
    work = _workload(rcfg.vocab, seed=2)
    kw = dict(KW, precision="w8a8", kv_precision="int8")
    reng = REngine(rcfg, params=rparams, **kw)
    want = _serve(reng, work, RSpec)
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    got = _serve(teng, work)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    m, rm = teng.metrics, reng.metrics
    assert (m.weight_bytes, m.weight_bytes_float) == (rm.weight_bytes, rm.weight_bytes_float)
    assert m.kv_pool_bytes == rm.kv_pool_bytes


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_engine_accounts_pools_and_recurrent_state(arch):
    """xLSTM has no attention layer, so no pool: zero pool bytes (no
    division by them) and the summary names only the recurrent state;
    jamba holds one pool a group beside its Mamba states."""
    cfg = tconfigs.get_smoke(arch)
    eng = TEngine(cfg, device="cpu", **KW)
    m = eng.metrics
    states = [c for c in eng.state.caches if isinstance(c, TS.RECURRENT_STATES)]
    assert m.state_bytes == sum(TS.state_bytes(c) for c in states) > 0
    n_attn = sum(k == "attn" for k in cfg.all_layer_kinds())
    assert len(eng.state.caches) - len(states) == n_attn
    assert (m.kv_pool_bytes > 0) == (n_attn > 0)
    assert m.kv_bytes_per_block == m.kv_pool_bytes // eng.num_blocks
    summary = m.summary()
    assert "recurrent_state=" in summary and ("kv_pool=" in summary) == (n_attn > 0)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_preempt_and_prefix_cache_refused_on_recurrent_stacks(arch):
    """KV-swap preemption and the prefix cache hold KV blocks only: a
    recurrent layer's state would be lost, so both refuse, as in the
    reference; swapping a recurrent state out raises."""
    cfg = tconfigs.get_smoke(arch)
    with pytest.raises(ValueError, match="preempt requires an attention-only stack"):
        TEngine(cfg, device="cpu", preempt=True, **KW)
    with pytest.raises(ValueError, match="prefix_cache requires an attention-only stack"):
        TEngine(cfg, device="cpu", prefix_cache=True, **KW)
    from repro_torch.serving import kv_cache as tkvc
    eng = TEngine(cfg, device="cpu", **KW)
    with pytest.raises(TypeError, match="recurrent state is not block-addressable"):
        tkvc.swap_out_blocks(eng.state.caches, [1])


def test_serve_cli_tokens_match_reference(capsys):
    """`--arch jamba-1.5-large-398b --device cpu`: the port's CLI prints the
    reference CLI's tokens for the same argv on the reference CLI's own
    weights."""
    arch = "jamba-1.5-large-398b"
    rparams = RM.init_model(jax.random.PRNGKey(0), rconfigs.get_smoke(arch))
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tconfigs.get_smoke(arch), "cpu")
    argv = ["--arch", arch, "--requests", "3", "--prompt-len", "6",
            "--gen-len", "3", "--chunk", "4", "--block-size", "4"]
    want = rserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(got, want)
    assert f"arch={arch}" in capsys.readouterr().out
