"""The port's serving host stack and main path against the reference:
allocator/table decisions, null-block routing, greedy token identity of
the Engine, and the serve CLI (gemma3-1b smoke, float32, CPU)."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import model as RM
from repro.serving import kv_cache as rkvc
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.serving import kv_cache as tkvc
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.prefill import chunk_buckets, plan_chunks
from repro_torch.serving.request import RequestSpec as TSpec

ARCH = "gemma3-1b"


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


def test_allocator_and_tables_match_reference():
    """The same ensure/release sequence draws the same block ids and leaves
    the same tables and reservations in both packages."""
    ra, ta = rkvc.BlockAllocator(12, 4), tkvc.BlockAllocator(12, 4)
    rt, tt = rkvc.BlockTables(3, 4), tkvc.BlockTables(3, 4)
    for a in (ra, ta):
        assert a.reserve(7)
    script = [("ensure", 0, 5), ("ensure", 1, 3), ("ensure", 0, 9),
              ("release", 0, 1), ("ensure", 2, 13), ("ensure", 0, 2),
              ("release", 1, 0), ("ensure", 1, 16)]
    for op, slot, n in script:
        if op == "ensure":
            assert rt.ensure(slot, n, ra) == tt.ensure(slot, n, ta)
        else:
            assert rt.release(slot, ra, unreserve=n) == tt.release(slot, ta, unreserve=n)
        np.testing.assert_array_equal(tt.table, np.asarray(rt.table))
        assert tt.blocks == rt.blocks
        assert (ta.in_use, ta.available, ta.reserved) == \
            (ra.in_use, ra.available, ra.reserved)
    ta.check()
    with pytest.raises(ValueError):
        ta.free([tkvc.NULL_BLOCK])
    with pytest.raises(RuntimeError):
        tt.ensure(2, 17, ta)      # past max_blocks
    assert tkvc.default_pool_blocks(8, 1200, 16) == rkvc.default_pool_blocks(8, 1200, 16)


def test_write_kv_routes_past_capacity_to_null_block():
    """Positions beyond a slot's table capacity land in the null block and
    never clamp onto the table's last (live) block."""
    cache = tkvc.init_paged_kv(5, 2, 1, 3, torch.float32, "cpu")
    tables = torch.tensor([[2, 4]], dtype=torch.int32)      # capacity 4 tokens
    k = torch.arange(1, 7, dtype=torch.float32)[None, :, None, None].expand(1, 6, 1, 3)
    tkvc.write_kv(cache, tables, k, k, 1)                   # positions 1..6
    flat = cache.k.reshape(10, 3)[:, 0].tolist()
    assert flat[2 * 2 + 1] == 1.0                    # pos 1 -> block 2, offset 1
    assert flat[4 * 2 + 0] == 2.0 and flat[4 * 2 + 1] == 3.0   # pos 2, 3 -> block 4
    assert flat[0] in (4.0, 6.0) and flat[1] == 5.0  # pos 4..6 -> null block
    assert sum(flat[2:4]) == 0.0 and sum(flat[6:8]) == 0.0     # blocks 1, 3 untouched


def test_prefill_plan_matches_reference():
    from repro.serving.prefill import plan_chunks as rplan
    assert chunk_buckets(64) == [64, 32, 16, 8, 4, 2, 1]
    for L in range(0, 70):
        assert plan_chunks(L, 8) == rplan(L, 8)


@pytest.mark.parametrize("slots,max_chunk,block_size", [(2, 4, 4), (3, 8, 2)])
def test_engine_greedy_token_identical_to_reference(models, slots, max_chunk,
                                                    block_size):
    """Main-path acceptance: more requests than slots with unequal max_new
    (slots refill, reset_slots runs) give the reference Engine's tokens."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    lens, gens = [5, 3, 7, 4, 9, 6], [2, 5, 1, 3, 4, 6]
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32) for n in lens]
    kw = dict(slots=slots, max_seq=32, block_size=block_size, max_chunk=max_chunk)
    reng = REngine(rcfg, params=rparams, **kw)
    reng.warmup()
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    teng.warmup()
    for p, g in zip(prompts, gens):
        reng.submit(RSpec(prompt=p, max_new=g))
        teng.submit(TSpec(prompt=p, max_new=g))
    want, got = reng.run(), teng.run()
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        assert len(got[rid]) == gens[rid]
    m = teng.metrics
    assert m.prefill_tokens == sum(lens)
    assert m.decode_tokens == sum(gens) - len(gens)
    assert m.cold_compiles == 0
    assert (m.prefill_chunks, m.decode_steps) == \
        (reng.metrics.prefill_chunks, reng.metrics.decode_steps)
    assert teng.alloc.in_use == 0 and teng.alloc.available == teng.num_blocks - 1
    assert m.kv_pool_bytes == reng.metrics.kv_pool_bytes


def test_engine_eos_token_identical_to_reference(models):
    """A request stops on its eos_token, the token included, as in the
    reference Engine: the eos is a token the model emits mid-generation
    (picked from a run without one), so some requests stop early and free
    their slots for the queue, and every request's tokens equal the
    reference's."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(4)
    lens, gens = [6, 4, 8, 5], [6, 7, 5, 6]
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32) for n in lens]
    kw = dict(slots=2, max_seq=32, block_size=4, max_chunk=4)
    probe = TEngine(tcfg, tparams, device="cpu", **kw)
    for p, g in zip(prompts, gens):
        probe.submit(TSpec(prompt=p, max_new=g))
    free = probe.run()
    mid = [int(t) for rid in sorted(free) for t in free[rid][1:-1]]
    assert mid, "the probe run emitted no mid-generation token"
    eos = max(set(mid), key=mid.count)
    reng = REngine(rcfg, params=rparams, **kw)
    reng.warmup()
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    teng.warmup()
    for p, g in zip(prompts, gens):
        reng.submit(RSpec(prompt=p, max_new=g, eos_token=eos))
        teng.submit(TSpec(prompt=p, max_new=g, eos_token=eos))
    want, got = reng.run(), teng.run()
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    stopped = 0
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
        toks = list(got[rid])
        if eos in toks:
            assert toks.index(eos) == len(toks) - 1      # nothing after the eos
            stopped += len(toks) < gens[rid]
        else:
            assert len(toks) == gens[rid]
    assert stopped >= 1                                   # the eos cut a request short
    assert teng.alloc.in_use == 0


def test_engine_rejects_bad_requests(models):
    _, _, tcfg, tparams = models
    eng = TEngine(tcfg, tparams, slots=1, max_seq=16, block_size=4, max_chunk=4,
                  max_queue=2, device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    assert eng.submit(TSpec(prompt=prompt, max_new=1)) is not None
    assert eng.submit(TSpec(prompt=prompt, max_new=1)) is not None
    assert eng.submit(TSpec(prompt=prompt, max_new=1)) is None
    assert eng.scheduler.rejected == 1
    with pytest.raises(ValueError):
        TSpec(prompt=np.zeros((0,), np.int32), max_new=1)
    with pytest.raises(ValueError):
        eng.submit(TSpec(prompt=np.zeros((20,), np.int32), max_new=1))


def test_serve_cli_tokens_match_reference(models, capsys):
    """`repro_torch.launch.serve.main` on the CPU prints (and returns) the
    reference CLI's tokens for the same argv and weights."""
    _, _, tcfg, tparams = models
    argv = ["--arch", ARCH, "--requests", "3", "--prompt-len", "6",
            "--gen-len", "3", "--chunk", "4", "--block-size", "4"]
    want = rserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(got, want)
    assert "sample continuations" in capsys.readouterr().out
