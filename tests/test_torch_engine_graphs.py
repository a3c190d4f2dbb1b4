"""What the engine's CUDA graphs rest on, held on the CPU (gemma3-1b smoke,
float32): `prefill_chunk` with the slot as a device index, the step state
staying at its addresses, the warmed state equal to a fresh one, the greedy
argmax on the device, and the `graphs` switch.  The graphs themselves run
only on a card (tests/test_torch_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as RM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import greedy_ids
from repro_torch.serving.request import RequestSpec as TSpec

ARCH = "gemma3-1b"
TOL = dict(rtol=3e-4, atol=3e-4)      # tests/test_serving.py's bar


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


def _state_tensors(state):
    out = [state.block_tables, state.lengths]
    for cache in state.caches:
        out += [t for t in cache if t is not None]
    return out


def _lived_state(tcfg, kv_precision, slots=3, block_size=4, max_blocks=4):
    """A state whose slots hold 5, 0 and 7 tokens of prefilled prompt."""
    state = TM.init_paged_decode_state(
        tcfg, slots, num_blocks=1 + slots * max_blocks, block_size=block_size,
        max_blocks_per_slot=max_blocks, device="cpu", kv_precision=kv_precision)
    alloc = tkvc.BlockAllocator(1 + slots * max_blocks, block_size)
    tables = tkvc.BlockTables(slots, max_blocks)
    for s in range(slots):
        tables.ensure(s, max_blocks * block_size, alloc)
    tables.copy_to(state.block_tables)
    state.lengths.copy_(torch.tensor([5, 0, 7], dtype=torch.int32))
    return state, tables


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
@pytest.mark.parametrize("slot", [0, 2])
def test_prefill_chunk_device_slot_equals_int_slot(models, kv_precision, slot):
    """The slot as a device index (0-d, (1,) int32 or int64) gives the int
    slot's logits, lengths and pools bit for bit, and the int slot's logits
    are the reference's (the slot traced as a jnp.int32) within its bar."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(3)
    warm = rng.integers(0, rcfg.vocab, size=(3, 5)).astype(np.int64)
    toks = torch.from_numpy(rng.integers(0, rcfg.vocab, size=(1, 4)).astype(np.int64))
    forms = [slot, torch.tensor(slot), torch.tensor([slot], dtype=torch.int32),
             torch.tensor([slot], dtype=torch.int64)]
    results = []
    with torch.no_grad():
        for form in forms:
            state, _ = _lived_state(tcfg, kv_precision)
            state.lengths.zero_()
            for s in range(3):          # live history in every slot first
                _, state = TM.prefill_chunk(tparams, tcfg, state,
                                            torch.from_numpy(warm[s:s + 1]), s)
            logits, state = TM.prefill_chunk(tparams, tcfg, state, toks, form)
            results.append((logits, state))
    want_logits, want_state = results[0]
    assert want_state.lengths.tolist() == [5 + 4 * (slot == 0), 5, 5 + 4 * (slot == 2)]
    for logits, state in results[1:]:
        assert torch.equal(logits, want_logits)
        for got, want in zip(_state_tensors(state), _state_tensors(want_state)):
            assert torch.equal(got, want)

    if kv_precision == "float":
        rstate = RM.init_paged_decode_state(rcfg, 3, num_blocks=13, block_size=4,
                                            max_blocks_per_slot=4)
        _, tables = _lived_state(tcfg, kv_precision)
        rstate = rstate._replace(block_tables=jnp.asarray(tables.table))
        for s in range(3):
            _, rstate = RM.prefill_chunk(rparams, rcfg, rstate,
                                         jnp.asarray(warm[s:s + 1], jnp.int32),
                                         jnp.int32(s))
        rl, rstate = RM.prefill_chunk(rparams, rcfg, rstate,
                                      jnp.asarray(toks.numpy(), jnp.int32), jnp.int32(slot))
        np.testing.assert_allclose(want_logits.numpy(), np.asarray(rl), **TOL)
        np.testing.assert_array_equal(want_state.lengths.numpy(), np.asarray(rstate.lengths))


def _serve(tcfg, tparams, prompts, gens, warm=True, **kw):
    eng = TEngine(tcfg, tparams, device="cpu", **kw)
    if warm:
        eng.warmup()
    for p, g in zip(prompts, gens):
        eng.submit(TSpec(prompt=p, max_new=g))
    return eng, eng.run()


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
def test_engine_state_stays_in_place(models, kv_precision):
    """Every tensor of the decode state and every static step input keeps
    its address through warmup and a run with slot refills and resets:
    what a captured graph reads stays where it was captured."""
    rcfg, _, tcfg, tparams = models
    rng = np.random.default_rng(5)
    lens, gens = [5, 3, 7, 4, 6], [3, 4, 2, 5, 2]
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32) for n in lens]
    eng = TEngine(tcfg, tparams, device="cpu", slots=2, max_seq=32, block_size=4,
                  max_chunk=4, kv_precision=kv_precision)
    state = eng.state
    inputs = [eng._tokens, eng._active, eng._slot, eng._reset_mask]
    ptrs = [t.data_ptr() for t in _state_tensors(state) + inputs]
    eng.warmup()
    for p, g in zip(prompts, gens):
        eng.submit(TSpec(prompt=p, max_new=g))
    got = eng.run()
    assert sorted(got) == list(range(len(prompts)))
    assert eng.state is state
    chunk_ptrs = {c: t.data_ptr() for c, t in eng._chunk_tokens.items()}
    assert sorted(chunk_ptrs) == [1, 2, 4]
    assert [t.data_ptr() for t in _state_tensors(eng.state) + inputs] == ptrs
    # refills ran the reset step; the tables were copied in, not replaced
    assert eng.metrics.cold_compiles == 0 and eng.metrics.aot_steps == 5
    assert {c: t.data_ptr() for c, t in eng._chunk_tokens.items()} == chunk_ptrs


@pytest.mark.parametrize("kv_precision", ["float", "int8"])
def test_warmed_state_equals_fresh_state(models, kv_precision):
    """Warmup runs every step shape on the engine's own state and then
    clears it in place: the result is `init_paged_decode_state`'s, bit for
    bit, pools, int8 scales, tables and lengths."""
    _, _, tcfg, tparams = models
    kw = dict(slots=3, max_seq=40, block_size=4, max_chunk=8)
    eng = TEngine(tcfg, tparams, device="cpu", kv_precision=kv_precision, **kw)
    eng.warmup()
    fresh = TM.init_paged_decode_state(
        tcfg, 3, num_blocks=eng.num_blocks, block_size=4,
        max_blocks_per_slot=eng.max_blocks_per_slot, device="cpu",
        kv_precision=kv_precision)
    for got, want in zip(_state_tensors(eng.state), _state_tensors(fresh)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    # and clearing a lived state in place does the same
    state, _ = _lived_state(tcfg, kv_precision)
    with torch.no_grad():
        _, state = TM.prefill_chunk(tparams, tcfg, state, torch.zeros((1, 3), dtype=torch.int64), 1)
    ptrs = [t.data_ptr() for t in _state_tensors(state)]
    TM.clear_paged_decode_state(state)
    blank = TM.init_paged_decode_state(tcfg, 3, num_blocks=13, block_size=4,
                                       max_blocks_per_slot=4, device="cpu",
                                       kv_precision=kv_precision)
    assert [t.data_ptr() for t in _state_tensors(state)] == ptrs
    for got, want in zip(_state_tensors(state), _state_tensors(blank)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-1.5-large-398b"])
def test_warmed_state_equals_fresh_state_families(arch):
    """The same for the recurrent stacks: after warmup (every step shape,
    speculative verify widths included, run on the engine's own state) the
    per-slot recurrent states are back at their init (m = -1e30, the rest
    zero), at their addresses, as are the pools, tables and lengths; and
    after serving requests that refilled slots, the same holds once the
    state is cleared."""
    tcfg = tconfigs.get_smoke(arch)
    kw = dict(slots=2, max_seq=40, block_size=4, max_chunk=8)
    eng = TEngine(tcfg, device="cpu", speculative=3, **kw)
    ptrs = [t.data_ptr() for t in _state_tensors(eng.state)]
    eng.warmup()
    fresh = TM.init_paged_decode_state(
        tcfg, 2, num_blocks=eng.num_blocks, block_size=4,
        max_blocks_per_slot=eng.max_blocks_per_slot, device="cpu")
    for got, want in zip(_state_tensors(eng.state), _state_tensors(fresh)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    rng = np.random.default_rng(0)
    for n in (5, 9, 3):
        eng.submit(TSpec(prompt=rng.integers(0, tcfg.vocab, size=n), max_new=4))
    eng.run()
    assert eng.metrics.cold_compiles == 0
    assert [t.data_ptr() for t in _state_tensors(eng.state)] == ptrs
    assert any(not torch.equal(got, want) for got, want in
               zip(_state_tensors(eng.state), _state_tensors(fresh)))
    TM.clear_paged_decode_state(eng.state)
    for got, want in zip(_state_tensors(eng.state), _state_tensors(fresh)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_ids_first_index_on_ties(dtype):
    """The device argmax picks the first maximal index, as np.argmax over
    the f32 logits does, also where several positions tie at the top."""
    rng = np.random.default_rng(7)
    logits = rng.integers(-3, 4, size=(6, 2, 50)).astype(np.float32)   # many ties
    logits[0, -1, :] = 1.0                                           # all tie
    logits[1, -1, [4, 9, 49]] = 10.0                                 # three tie
    t = torch.from_numpy(logits).to(dtype)
    got = greedy_ids(t)
    want = np.argmax(t[:, -1].to(torch.float32).numpy(), axis=-1)
    assert got.dtype == torch.int64 and got.shape == (6,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got[1] == 4


def test_graphs_switch(models):
    """graphs=True needs a card and raises on the CPU; the default there is
    eager, and an eager engine holds no graphs and replays nothing."""
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        TEngine(tcfg, tparams, device="cpu", graphs=True, slots=1, max_seq=16)
    for graphs in (None, False):
        eng = TEngine(tcfg, tparams, device="cpu", graphs=graphs, slots=1, max_seq=16,
                      block_size=4, max_chunk=4)
        assert eng.graphs is False
        eng.warmup()
        assert eng.step_graphs == {} and eng.metrics.capture_time_s == 0.0
        assert set(eng.replayed_launches().values()) == {0}


def test_cold_shapes_run_at_first_use(models):
    """An engine that was never warmed runs each shape at its first use,
    counts it in cold_compiles once, and gives the warmed engine's tokens."""
    rcfg, _, tcfg, tparams = models
    rng = np.random.default_rng(8)
    lens, gens = [5, 3, 6], [3, 4, 2]
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32) for n in lens]
    kw = dict(slots=2, max_seq=32, block_size=4, max_chunk=4)
    warm, want = _serve(tcfg, tparams, prompts, gens, **kw)
    cold, got = _serve(tcfg, tparams, prompts, gens, warm=False, **kw)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    # decode, chunks 4, 2 and 1 (5 = 4 + 1, 3 = 2 + 1, 6 = 4 + 2), and the
    # reset of the refilled slot
    assert cold.metrics.cold_compiles == 5 and warm.metrics.cold_compiles == 0
    assert cold.metrics.aot_steps == 0
