"""The port's int8 slice against the reference on the CPU: row quantization,
the int8 GeMMs, int8-resident parameters, int8 KV pools and paged decode,
and greedy w8a8 / int8-KV serving (gemma3-1b smoke, float32).  The
reference's Pallas kernels run in interpret mode; inputs are made with
numpy from a seed.  (The CUDA kernels are held against the plain versions
on the card: tests/test_torch_gpu.py and chip_smoke.py.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import quant as rquant
from repro.kernels import flash_decode as rfd
from repro.kernels import ops as rops
from repro.kernels import quant as rkquant
from repro.kernels import ref as rref
from repro.models import model as RM
from repro.models.attention import decode_attention as r_decode_attention
from repro.serving import kv_cache as rkvc
from repro.serving.prefill import plan_chunks
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import gemm_int8 as tgemm8
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant as tkquant
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as tkvc

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


def _int8(rng, shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


# ---------------------------------------------------------------------------
# K4: per-row quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 7, 300])
def test_quantize_rows_plain_matches_reference_kernel(M, dtype):
    """Codes and scales equal the Pallas kernel's (interpret mode) for
    ragged M, a zero row (the 1e-8 floor) and exact .5 ties."""
    rng = np.random.default_rng(M)
    x = rng.normal(size=(M, 48)).astype(np.float32)
    x[0, :4] = (127.0, 0.5, 1.5, -2.5)           # ties at scale 1: half to even
    if M > 1:
        x[1] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want_q, want_s = rkquant.quantize_rows(jx, interpret=True)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got_q, got_s = tkquant.quantize_rows(tx)
    assert got_q.dtype == torch.int8 and got_s.shape == (M, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(tops.quantize(tx)[0].numpy(), np.asarray(want_q))


# ---------------------------------------------------------------------------
# K3 and K1's int mode
# ---------------------------------------------------------------------------

INT8_CASES = [  # (M, K, N, transposed B view)
    (8, 64, 96, False),
    (13, 70, 45, False),      # ragged everywhere
    (1, 33, 129, True),       # the tied-head shape class: B = table.T
    (64, 160, 17, True),
]


@pytest.mark.parametrize("M,K,N,transposed", INT8_CASES)
def test_int8_gemms_plain_match_reference_kernels(M, K, N, transposed):
    """The dequant GeMM and int8 `ops.gemm` equal the Pallas kernels in
    interpret mode and the reference oracles exactly."""
    rng = np.random.default_rng(K)
    a = _int8(rng, (M, K))
    b = _int8(rng, (N, K) if transposed else (K, N))
    sa = rng.uniform(1e-3, 1e-1, size=(M, 1)).astype(np.float32)
    sb = rng.uniform(1e-3, 1e-1, size=(1, N)).astype(np.float32)
    jb = jnp.asarray(b).T if transposed else jnp.asarray(b)
    tb = torch.from_numpy(b).t() if transposed else torch.from_numpy(b)
    ta = torch.from_numpy(a)
    want = np.asarray(rops.gemm_int8_dequant(jnp.asarray(a), jb, jnp.asarray(sa),
                                             jnp.asarray(sb), backend="interpret"))
    got = tops.gemm_int8_dequant(ta, tb, torch.from_numpy(sa), torch.from_numpy(sb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rref.gemm_dequant_ref(
        jnp.asarray(a), jb, jnp.asarray(sa), jnp.asarray(sb))))
    want_int = np.asarray(rops.gemm(jnp.asarray(a), jb, backend="interpret"))
    got_int = tops.gemm(ta, tb)
    assert got_int.dtype == torch.int32
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    np.testing.assert_array_equal(got_int.numpy(), np.asarray(rref.gemm_ref(jnp.asarray(a), jb)))


@pytest.mark.parametrize("backend", ["interpret", "xla"])
@pytest.mark.parametrize("static", [False, True])
def test_w8a8_gemm_and_quant_linear_match_reference(backend, static):
    """`gemm_w8a8` (dynamic rows, or a static activation scale) and `linear`
    on an int8-resident weight against the reference at both backends."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 40)).astype(np.float32)
    w = (rng.normal(size=(40, 24)) * 0.2).astype(np.float32)
    act = np.float32(np.abs(x).max() / 127.0) if static else None
    rt = rquant.quantize_leaf(jnp.asarray(w), act_scale=act)
    tt = quant.quantize_leaf(torch.from_numpy(w), act_scale=act)
    np.testing.assert_array_equal(tt.q.numpy(), np.asarray(rt.q))
    want = np.asarray(rops.gemm_w8a8(jnp.asarray(x[0]), rt.q, rt.scale,
                                     act_scale=rt.act_scale, backend=backend))
    got = tops.gemm_w8a8(torch.from_numpy(x[0]), tt.q, tt.scale, act_scale=tt.act_scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    mode = "w8a8-calibrated" if static else "w8a8"
    with rquant.precision(mode):
        want = np.asarray(rops.linear(jnp.asarray(x), rt, backend=backend))
    with quant.precision(mode):
        got = tops.linear(torch.from_numpy(x), tt)
    assert got.shape == (2, 5, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_precision_mode_drives_linear_and_none_opts_out():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    with rquant.precision("w8a8"):
        want_q = np.asarray(rops.linear(jnp.asarray(x), jnp.asarray(w)))
        want_f = np.asarray(rops.linear(jnp.asarray(x), jnp.asarray(w), quant="none"))
    with quant.precision("w8a8"):
        got_q = tops.linear(tx, tw)
        got_f = tops.linear(tx, tw, quant="none")
    np.testing.assert_allclose(got_q.numpy(), want_q, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-5, atol=1e-5)
    assert not np.allclose(got_q.numpy(), got_f.numpy(), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown quant"):
        tops.linear(tx, tw, quant="int4")


# ---------------------------------------------------------------------------
# int8-resident parameters
# ---------------------------------------------------------------------------

def test_quantize_params_matches_reference(models):
    rcfg, rparams, tcfg, tparams = models
    rq = rquant.quantize_params(rparams, cfg=rcfg)
    tq = quant.quantize_params(tparams, cfg=tcfg)
    for g in range(tcfg.n_groups):
        for i in range(tcfg.group_size):
            tl = tq["layers"][g * tcfg.group_size + i]
            rl = rq["blocks"][f"sub{i}"]
            for part, key in (("mixer", "wq"), ("mixer", "wk"), ("mixer", "wv"),
                              ("mixer", "wo"), ("ffn", "w_gate"), ("ffn", "w_up"),
                              ("ffn", "w_down")):
                t, r = tl[part][key], rl[part][key]
                assert isinstance(t, quant.QuantTensor)
                np.testing.assert_array_equal(t.q.numpy(), np.asarray(r.q)[g])
                np.testing.assert_array_equal(t.scale.numpy(), np.asarray(r.scale)[g])
                assert t.q.stride() == (1, t.q.shape[0])   # K-contiguous store
    np.testing.assert_array_equal(tq["head_q"].q.numpy(), np.asarray(rq["head_q"].q))
    np.testing.assert_array_equal(tq["head_q"].scale.numpy(),
                                  np.asarray(rq["head_q"].scale))
    assert torch.equal(tq["embed"], tparams["embed"])        # the table stays float
    assert quant.weight_bytes(tq) == rquant.weight_bytes(rq)
    assert quant.weight_bytes(tparams) == rquant.weight_bytes(rparams)
    assert quant.quantized_leaf_count(tq) == \
        (rquant.quantized_leaf_count(rq) - 1) * tcfg.n_groups + 1
    assert quant.quantize_params(tq, cfg=tcfg)["layers"][0]["mixer"]["wq"] is \
        tq["layers"][0]["mixer"]["wq"]                         # idempotent
    deq = quant.dequantize_params(tq)
    assert "head_q" not in deq
    np.testing.assert_allclose(deq["layers"][0]["ffn"]["w_up"].numpy(),
                               np.asarray(rquant.dequantize_params(rq)["blocks"]["sub0"]
                                          ["ffn"]["w_up"])[0], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# int8 KV pools and the int8 branch of paged decode
# ---------------------------------------------------------------------------

B, BS, MAX_BLOCKS, HKV, GROUPS, D = 3, 4, 6, 2, 2, 16
LENGTHS = np.array([5, 12, MAX_BLOCKS * BS], np.int32)


def test_write_kv_int8_matches_reference():
    """Codes and scales land where the reference puts them, a zero token
    takes scale 1, and past-capacity positions route to the null block."""
    rng = np.random.default_rng(5)
    bt = np.array([[3, 1], [2, 4]], np.int32)
    k = rng.normal(size=(2, 5, 2, 8)).astype(np.float32)
    k[1, 0] = 0.0
    start = np.array([1, 0], np.int32)
    # jitted, as the reference's serving steps run it (see kernels/quant.py)
    r = jax.jit(rkvc.write_kv)(
        rkvc.init_paged_kv(5, 2, 2, 8, jnp.float32, kv_precision="int8"),
        jnp.asarray(bt), jnp.asarray(k), jnp.asarray(-k), jnp.asarray(start))
    t = tkvc.write_kv(tkvc.init_paged_kv(5, 2, 2, 8, torch.float32, "cpu",
                                         kv_precision="int8"),
                      torch.from_numpy(bt), torch.from_numpy(k), torch.from_numpy(-k),
                      torch.from_numpy(start))
    assert t.quantized and t.k.dtype == torch.int8
    for got, want in ((t.k, r.k), (t.v, r.v), (t.k_scale, r.k_scale),
                      (t.v_scale, r.v_scale)):
        np.testing.assert_array_equal(got.numpy()[1:], np.asarray(want)[1:])
    assert t.k_scale[2, 0].tolist() == [1.0, 1.0]          # the zero token
    # slot 0 writes positions 1..5 into capacity 4: 4 and 5 hit the null block
    assert not torch.equal(t.k[0], torch.zeros_like(t.k[0]))
    assert tkvc.pool_bytes(t) == 2 * (5 * 2 * 2 * 8) + 2 * 4 * (5 * 2 * 2)
    qk, sk = tkvc.quantize_kv_tokens(torch.from_numpy(k))
    rqk, rsk = jax.jit(rkvc.quantize_kv_tokens)(jnp.asarray(k))
    np.testing.assert_array_equal(qk.numpy(), np.asarray(rqk))
    np.testing.assert_array_equal(sk.numpy(), np.asarray(rsk))


def _int8_pools(seed=0):
    """The same lived-in int8 pool in both packages, written through each
    package's write_kv from the same numpy K/V."""
    rng = np.random.default_rng(seed)
    nb = 1 + B * MAX_BLOCKS
    L = int(LENGTHS.max())
    k_new = rng.normal(size=(B, L, HKV, D)).astype(np.float32)
    v_new = rng.normal(size=(B, L, HKV, D)).astype(np.float32)
    rcache = rkvc.init_paged_kv(nb, BS, HKV, D, jnp.float32, kv_precision="int8")
    tcache = tkvc.init_paged_kv(nb, BS, HKV, D, torch.float32, "cpu", kv_precision="int8")
    alloc, tables = tkvc.BlockAllocator(nb, BS), tkvc.BlockTables(B, MAX_BLOCKS)
    for s in range(B):
        tables.ensure(s, int(LENGTHS[s]), alloc)
    rbt, tbt = jnp.asarray(tables.table), tables.array("cpu")
    rcache = jax.jit(rkvc.write_kv)(rcache, rbt, jnp.asarray(k_new),
                                    jnp.asarray(v_new), 0)
    tkvc.write_kv(tcache, tbt, torch.from_numpy(k_new), torch.from_numpy(v_new), 0)
    return (rcache, rbt), (tcache, tbt)


@pytest.mark.parametrize("sq", [1, 3])
@pytest.mark.parametrize("window", [None, 6])
def test_paged_decode_int8_plain_matches_reference(sq, window):
    """The plain walk and the gather oracle on an int8 pool reproduce the
    Pallas kernel's quantized branch (interpret mode) and the reference's
    walk, within the bar of tests/test_flash_decode.py."""
    (rcache, rbt), (tcache, tbt) = _int8_pools()
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, sq, HKV * GROUPS, D)).astype(np.float32)
    idx = (LENGTHS - sq).astype(np.int32)
    jq, jidx = jnp.asarray(q), jnp.asarray(idx)
    wants = (
        np.asarray(rfd.flash_decode_attention(jq, rcache, rbt, jidx, window=window,
                                              spec=rfd.FlashDecodeSpec(num_splits=2),
                                              interpret=True)),
        np.asarray(rfd.ref_paged_decode(jq, rcache, rbt, jidx, window=window)),
        np.asarray(r_decode_attention(jq, *rkvc.gather_kv(rcache, rbt), index=jidx,
                                      window=window)),
    )
    tq, tidx = torch.from_numpy(q), torch.from_numpy(idx)
    got = tfd.paged_decode_attention(tq, tcache, tbt, tidx, window=window)
    got_oracle = tfd.gather_decode(tq, tcache, tbt, tidx, window=window)
    for want in wants:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_oracle.numpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: model steps (Engine and CLI: test_torch_quant_serving.py)
# ---------------------------------------------------------------------------

def test_w8a8_int8kv_model_logits_match_reference(models):
    """Chunked prefill then paged decode with int8-resident weights under
    the w8a8 mode and int8 pools: logits within 1e-3 x max|logit|."""
    rcfg, rparams, tcfg, tparams = models
    rq = rquant.quantize_params(rparams, cfg=rcfg)
    tq = quant.quantize_params(tparams, cfg=tcfg)
    slots, prompt_len, gen, bs, mb = 2, 5, 2, 4, 8
    nb = 1 + slots * mb
    rstate = RM.init_paged_decode_state(rcfg, slots, num_blocks=nb, block_size=bs,
                                        max_blocks_per_slot=mb, kv_precision="int8")
    tstate = TM.init_paged_decode_state(tcfg, slots, num_blocks=nb, block_size=bs,
                                        max_blocks_per_slot=mb, device="cpu",
                                        kv_precision="int8")
    tables = tkvc.BlockTables(slots, mb)
    alloc = tkvc.BlockAllocator(nb, bs)
    for s in range(slots):
        tables.ensure(s, prompt_len + gen + 1, alloc)
    rstate = rstate._replace(block_tables=jnp.asarray(tables.table))
    tstate.block_tables = tables.array("cpu")
    prompts = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(slots, prompt_len)).astype(np.int32)

    def close(t, r):
        r = np.asarray(r)
        assert np.abs(t.numpy() - r).max() <= 1e-3 * np.abs(r).max()

    with rquant.precision("w8a8"), quant.precision("w8a8"):
        for s in range(slots):
            pos = 0
            for c in plan_chunks(prompt_len, max_chunk=4):
                chunk = prompts[s:s + 1, pos:pos + c]
                rl, rstate = RM.prefill_chunk(rq, rcfg, rstate, jnp.asarray(chunk),
                                              jnp.int32(s))
                tl, tstate = TM.prefill_chunk(tq, tcfg, tstate,
                                              torch.from_numpy(chunk).long(), s)
                close(tl, rl)
                pos += c
        tok = np.full((slots, 1), np.argmax(np.asarray(rl)[0, -1]), np.int32)
        for _ in range(gen):
            rl, rstate = RM.paged_decode_step(rq, rcfg, rstate, jnp.asarray(tok))
            tl, tstate = TM.paged_decode_step(tq, tcfg, tstate,
                                              torch.from_numpy(tok).long())
            close(tl, rl)
            tok = np.argmax(np.asarray(rl)[:, -1], -1)[:, None].astype(np.int32)
    assert quant.get_mode() == "float"
