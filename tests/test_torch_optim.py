"""The port's optimizer, gradient compression and data stream against the
reference's on the CPU: AdamW steps (f32, bf16 and int8 moments) on the
gemma3-1b smoke parameters with the same gradients, BlockQ codes, the
warmup-cosine schedule, the global norm and clipping, int8 compression
with error feedback, and the synthetic LM batches.

Same inputs, the same arithmetic in the same order: BlockQ codes,
compression codes and batches agree bit for bit, the schedule within 1e-6
(cos rounds its own way in each), the global norm within 1e-6.  AdamW: XLA and
PyTorch round sqrt, pow and their fused products each in their own way,
so f32 results agree within 1e-6 relative and 1e-7 absolute (the
parameters are ~0.05, lr x update ~1e-2); bf16 and int8 moments within
one storage step (a bf16 ulp, an int8 block step) of the reference's,
since an f32 difference can round them to neighbouring codes.  A moment
one step apart then moves later updates by up to that step's share of
the update, so in bf16 / int8 the parameters are held tight after the
first step (same inputs, same f32 arithmetic) and within lr x 2^-6 of the
reference's per later step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.data import SyntheticLMData as RData
from repro.models import model as RM
from repro.optim import AdamWConfig as RCfg
from repro.optim import adamw_init as radamw_init
from repro.optim import adamw_update as radamw_update
from repro.optim import global_norm as rglobal_norm
from repro.optim import warmup_cosine as rwarmup_cosine
from repro.optim import compression as rcomp
from repro.optim.adamw import _bq_encode as r_bq_encode
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.data import Prefetcher, SyntheticLMData, to_device
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, global_norm, warmup_cosine
from repro_torch.optim import compression as tcomp
from repro_torch.optim.adamw import BlockQ, _bq_decode, _bq_encode, decayed

STEP_TOL = dict(rtol=1e-6, atol=1e-7)


def _smoke():
    rcfg, tcfg = rconfigs.get_smoke("gemma3-1b"), tconfigs.get_smoke("gemma3-1b")
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, tcfg


def _to_port(tree_np, tcfg):
    return bridge.params_from_reference(tree_np, tcfg, "cpu")


def _grads(rparams, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 10.0 ** rng.uniform(-4, -1)).astype(np.float32),
        rparams)


def _decoded(tree, like, int8):
    if not int8:
        return [t.to(torch.float32) for t in tree_lib.leaves(tree)]
    from repro_torch.optim.adamw import _moments
    return [_bq_decode(b, p.shape) for b, p in zip(_moments(tree, True), tree_lib.leaves(like))]


def _ref_moments(tree_r, rparams, int8, tcfg):
    """The reference's moments as port-layout f32 trees (int8 decoded)."""
    if int8:
        from repro.optim.adamw import _bq_decode as r_bq_decode
        is_bq = lambda x: hasattr(x, "scale") and hasattr(x, "q")
        tree_r = jax.tree_util.tree_map(lambda b, p: r_bq_decode(b, p.shape), tree_r, rparams,
                                        is_leaf=is_bq)
    return _to_port(jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree_r), tcfg)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_steps_match_reference(state_dtype):
    """Three steps with clipping (the gradients' norm is far above 1) and
    weight decay on every leaf the reference decays: its stacked layer
    leaves, norm vectors included, and the embedding, not the final norm."""
    rcfg, rparams, tcfg = _smoke()
    cfg_r, cfg_t = RCfg(state_dtype=state_dtype), AdamWConfig(state_dtype=state_dtype)
    tparams = _to_port(jax.tree_util.tree_map(np.asarray, rparams), tcfg)
    rstate, tstate = radamw_init(rparams, cfg_r), adamw_init(tparams, cfg_t)
    upd = jax.jit(lambda g, s, p, lr: radamw_update(g, s, p, lr, cfg_r))
    int8, f32 = state_dtype == "int8", state_dtype == "float32"
    drift = 0.0
    for i in range(3):
        g = _grads(rparams, i)
        lr = 1e-2 * (i + 1)
        rparams, rstate = upd(g, rstate, rparams, jnp.asarray(lr, jnp.float32))
        tparams, tstate = adamw_update(tree_lib.leaves(_to_port(g, tcfg)), tstate, tparams,
                                       torch.tensor(lr, dtype=torch.float32), cfg_t)
        assert int(tstate["count"]) == int(rstate["count"]) == i + 1
        want = _to_port(jax.tree_util.tree_map(np.asarray, rparams), tcfg)
        for (path, got), w in zip(tree_lib.leaves_with_paths(tparams), tree_lib.leaves(want)):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=STEP_TOL["rtol"],
                                       atol=STEP_TOL["atol"] + drift, err_msg=str(path))
        for name in ("m", "v"):
            got = _decoded(tstate[name], tparams, int8)
            want = tree_lib.leaves(_ref_moments(rstate[name], rparams, int8, tcfg))
            for gm, w in zip(got, want):
                w = w.numpy()
                if f32:
                    np.testing.assert_allclose(gm.numpy(), w, **STEP_TOL)
                else:
                    step = (np.abs(w).max() / 127 if int8 else np.abs(w) * 2.0 ** -7) + 1e-30
                    assert np.all(np.abs(gm.numpy() - w) <= step * 1.0001), name
        if not f32:
            drift += lr * 2.0 ** -6


def test_decay_follows_the_reference_stacking():
    _, rparams, tcfg = _smoke()
    tparams = _to_port(jax.tree_util.tree_map(np.asarray, rparams), tcfg)
    flags = dict(zip([p for p, _ in tree_lib.leaves_with_paths(tparams)], decayed(tparams)))
    assert flags[("embed",)] and not flags[("final_norm",)]
    layer_leaves = [p for p in flags if p[0] == "layers"]
    assert layer_leaves and all(flags[p] for p in layer_leaves)
    assert any(tree_lib.leaves(tparams)[i].dim() == 1 for i, p in enumerate(flags)
               if p[0] == "layers")


def test_blockq_codes_match_reference():
    x = (np.random.default_rng(0).normal(size=(3, 100)) * 10).astype(np.float32)
    rq = r_bq_encode(jnp.asarray(x))
    tq = _bq_encode(torch.from_numpy(x))
    assert tq.q.dtype == torch.int8
    np.testing.assert_array_equal(tq.q.numpy(), np.asarray(rq.q))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(rq.scale))
    y = _bq_decode(tq, x.shape)
    assert float((y - torch.from_numpy(x)).abs().max()) <= np.abs(x).max() / 127 + 1e-6


def test_warmup_cosine_matches_reference():
    r, t = rwarmup_cosine(1e-3, warmup=100, total=1000), warmup_cosine(1e-3, 100, 1000)
    steps = np.array([0, 1, 50, 99, 100, 101, 500, 999, 1000, 1500], np.int32)
    want = np.asarray(jax.vmap(r)(jnp.asarray(steps)))
    got = np.array([float(t(torch.tensor(s, dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(t(torch.tensor(0))) == 0.0
    assert float(t(torch.tensor(1000))) == pytest.approx(1e-4, rel=1e-5)


def test_global_norm_and_clipping():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)
    g = {k: np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32) for k in "xy"}
    np.testing.assert_allclose(
        float(global_norm({k: torch.from_numpy(v) for k, v in g.items()})),
        float(rglobal_norm({k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params, cfg)
    adamw_update({"w": torch.full((4,), 1e6)}, state, params, 0.1, cfg)
    assert float(params["w"].abs().max()) < 1.0          # the clipped update stays ~lr


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_converges_quadratic(state_dtype):
    cfg = AdamWConfig(weight_decay=0.0, state_dtype=state_dtype)
    target = torch.tensor([[1.5, -2.0], [0.5, 3.0]])
    params = {"w": torch.zeros((2, 2))}
    state = adamw_init(params, cfg)
    for _ in range(300):
        adamw_update({"w": 2 * (params["w"] - target)}, state, params, 0.05, cfg)
    tol = {"float32": 1e-2, "bfloat16": 5e-2, "int8": 1e-1}[state_dtype]
    assert float((params["w"] - target).abs().max()) < tol


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_in_slices_equals_one_pass_bit_for_bit(monkeypatch, state_dtype):
    """The float path updates a leaf in slices of CHUNK_ELEMENTS along its
    first axis (the f32 temporaries of a stacked expert leaf stay a slice's
    size); elementwise, so the parameters and moments are those of one
    pass, bit for bit, also for a row-padded leaf and a 0-d one."""
    from repro_torch.optim import adamw

    g = torch.Generator().manual_seed(3)
    padded = torch.empty((6, 8))[:, :5]
    padded.copy_(torch.randn((6, 5), generator=g))
    shapes = {"layers": [{"w": torch.randn((5, 3, 4), generator=g)}],
              "head": padded, "b": torch.randn((7,), generator=g), "s": torch.randn((), generator=g)}
    cfg = AdamWConfig(state_dtype=state_dtype)
    runs = []
    for chunk in (1 << 26, 5):
        monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", chunk)
        params = tree_lib.map_tree(torch.clone, shapes)
        params["head"] = torch.empty((6, 8))[:, :5]
        params["head"].copy_(padded)
        state = adamw_init(params, cfg)
        for i in range(3):
            grads = tree_lib.map_tree(
                lambda t: torch.randn(t.shape, generator=torch.Generator().manual_seed(i)), params)
            adamw_update(grads, state, params, 0.01, cfg)
        runs.append((params, state))
    (p1, s1), (p2, s2) = runs
    for a, b in zip(tree_lib.leaves([p1, s1["m"], s1["v"]]), tree_lib.leaves([p2, s2["m"], s2["v"]])):
        assert torch.equal(a, b)
    assert p2["head"].stride(0) == 8


def test_optimizer_state_memory_sizes():
    params = {"w": torch.zeros((1024, 128), dtype=torch.bfloat16)}

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_lib.leaves(tree))

    f32 = nbytes(adamw_init(params, AdamWConfig(state_dtype="float32"))["m"])
    b16 = nbytes(adamw_init(params, AdamWConfig(state_dtype="bfloat16"))["m"])
    i8 = nbytes(adamw_init(params, AdamWConfig(state_dtype="int8"))["m"])
    assert b16 == f32 // 2 and i8 < f32 // 3


def test_compression_with_error_feedback_matches_reference():
    rng = np.random.default_rng(3)
    grads = [{"a": rng.normal(size=(7, 50)).astype(np.float32),
              "b": rng.normal(size=(300,)).astype(np.float32)} for _ in range(4)]
    ref_ef = rcomp.init_error_feedback({k: jnp.asarray(v) for k, v in grads[0].items()})
    ef = tcomp.init_error_feedback({k: torch.from_numpy(v) for k, v in grads[0].items()})
    total_in, total_out = 0, 0
    for g in grads:
        rq, ref_ef = rcomp.compress_with_feedback({k: jnp.asarray(v) for k, v in g.items()},
                                                  ref_ef)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        tq, ef = tcomp.compress_with_feedback(tg, ef)
        for k in g:
            assert isinstance(tq[k], BlockQ)
            np.testing.assert_array_equal(tq[k].q.numpy(), np.asarray(rq[k].q))
            np.testing.assert_array_equal(tq[k].scale.numpy(), np.asarray(rq[k].scale))
            np.testing.assert_array_equal(ef[k].numpy(), np.asarray(ref_ef[k]))
        assert tcomp.compressed_bytes(tq) == rcomp.compressed_bytes(rq)
        out = tcomp.decompress(tq, tg)
        total_in = total_in + tg["b"]
        total_out = total_out + out["b"]
    # error feedback: the running sums differ by the last residual only
    np.testing.assert_allclose((total_in - total_out).numpy(), ef["b"].numpy(), atol=1e-5)


def test_synthetic_batches_equal_the_reference():
    extras = {"frames": (6, 4)}
    r, t = RData(1000, 3, 17, seed=5, extras=extras), SyntheticLMData(1000, 3, 17, seed=5,
                                                                       extras=extras)
    for cursor in (0, 1, 12345, 2**33 + 7):
        a, b = r.batch_at(cursor), t.batch_at(cursor)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    dev = to_device(t.batch_at(0), "cpu")
    assert dev["tokens"].dtype == torch.int64 and dev["frames"].dtype == torch.float32


def test_prefetcher_yields_the_stream_in_order():
    data = SyntheticLMData(100, 2, 8)
    pf = Prefetcher(data.iterate(3), depth=2, device="cpu")
    for cursor in (3, 4, 5):
        got = next(pf)
        np.testing.assert_array_equal(got["tokens"].numpy(), data.batch_at(cursor)["tokens"])
    pf.close()
    finite = Prefetcher(iter([1, 2]), depth=1)
    assert list(finite) == [1, 2]
