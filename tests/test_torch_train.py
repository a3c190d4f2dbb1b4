"""The port's training path against the reference on the CPU, float32: the
chunked `loss_fn` and every gradient leaf against `jax.value_and_grad` of
the reference's `loss_fn`, K5's plain backward against `jax.grad` of the
reference's attention, one `make_train_step` step (params, AdamW moments,
count) against the reference's jitted step, and ten steps' losses against
the reference's trajectory.

Parameters come from the reference's `init_model(PRNGKey(0))` and reach
the port through `bridge.params_from_reference`, which carries the
reference's gradient and moment trees the same way (they have the
parameters' structure).  The reference is called directly, without the
launcher's mesh (its launcher fails under the mesh on this host: ROADMAP
C.5).

Tolerances: the port sums in other orders than XLA (its attention is the
flash kernel's plain version, scale applied in f32, where the reference's
CPU path is the XLA blockwise scan), so values agree to f32 rounding
amplified by the depth: the loss within 1e-5, each gradient leaf within
2e-4 relative to its largest element; the AdamW moments as the gradients.
An AdamW update is the ratio m / (sqrt(v) + eps), about sign(g) and
insensitive to the gradient's rounding, except where m and sqrt(v) shrink
toward eps (1e-8): there the ratio follows the rounding of a gradient that
is itself rounding-sized.  So the parameters after two steps agree within
1e-6 + 1e-3 x lr wherever the first moment lies outside the moments'
tolerance of zero (|m| > 2e-4 max |m|); the few elements inside it (m ~
1e-9, a handful in each config) are bounded by the update's own size,
2 lr."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import steps as rsteps
from repro.models import attention as rattn
from repro.models import model as RM
from repro.optim import adamw_init as radamw_init
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_lib
from repro_torch.data import SyntheticLMData, to_device
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as TM
from repro_torch.optim import adamw_init

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 2e-4          # of each leaf's largest |element|


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _cfgs(arch):
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if arch == "qwen3-14b":
        # A vocab whose f32 rows are not 16-byte multiples: the untied head
        # is stored row-padded (`aligned_rows`), as init_model stores it.
        rcfg, tcfg = (dataclasses.replace(c, vocab=250) for c in (rcfg, tcfg))
    return rcfg, tcfg


def _models(arch):
    rcfg, tcfg = _cfgs(arch)
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams),
                                           tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.fixture(scope="module", params=["gemma3-1b", "qwen3-14b"])
def models(request):
    return _models(request.param)


def _batch(vocab, B=2, S=32, seed=0):
    return SyntheticLMData(vocab, B, S, seed=seed).batch_at(3)


def _port_grads(tparams, tcfg, batch, **kw):
    leaves = tree_lib.leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = TM.loss_fn(tparams, tcfg, to_device(batch, "cpu"), **kw)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), tree_lib.unflatten(tparams, grads)


def _assert_trees_close(got, want, rtol_of_max, label):
    for (path, g), w in zip(tree_lib.leaves_with_paths(got), tree_lib.leaves(want)):
        g, w = g.detach().numpy(), w.detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol_of_max * scale,
                                   err_msg=f"{label} {path}")


def test_loss_matches_reference(models):
    rcfg, rparams, tcfg, tparams = models
    batch = _batch(rcfg.vocab)
    want = float(RM.loss_fn(rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(TM.loss_fn(tparams, tcfg, to_device(batch, "cpu")))
    np.testing.assert_allclose(got, want, **LOSS_TOL)


def test_every_gradient_leaf_matches_reference(models):
    rcfg, rparams, tcfg, tparams = models
    batch = _batch(rcfg.vocab)
    rloss, rgrads = jax.value_and_grad(RM.loss_fn)(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rgrads),
                                        tcfg, "cpu")
    tfa.reset_launches()
    loss, grads = _port_grads(tparams, tcfg, batch)
    assert tfa.launches == tfa.bwd_launches == 0          # CPU: the plain versions
    np.testing.assert_allclose(float(loss), float(rloss), **LOSS_TOL)
    _assert_trees_close(grads, want, GRAD_RTOL, "grad")


def test_remat_on_equals_remat_off(models):
    """Activation checkpointing recomputes the groups in the backward: the
    same loss and gradients, bit for bit."""
    rcfg, _, tcfg, tparams = models
    batch = _batch(rcfg.vocab, seed=1)
    on = _port_grads(tparams, tcfg, batch)
    off = _port_grads(tparams, dataclasses.replace(tcfg, remat=False), batch)
    assert tcfg.remat and float(on[0]) == float(off[0])
    for a, b in zip(tree_lib.leaves(on[1]), tree_lib.leaves(off[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [12, 64])
def test_chunk_and_mask_match_reference(models, chunk):
    """A chunk that does not divide S (12 halves to 6 at S = 30 ... and to 3
    at S = 24 is not reached: the chunk halves until it divides S) and a
    chunk above S, under a loss mask with zeros."""
    rcfg, rparams, tcfg, tparams = models
    batch = _batch(rcfg.vocab, S=30, seed=2)
    batch["mask"] = (np.random.default_rng(5).random(batch["labels"].shape) < 0.7
                     ).astype(np.float32)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rloss, rgrads = jax.value_and_grad(
        lambda p: RM.loss_fn(p, rcfg, rbatch, chunk=chunk))(rparams)
    want = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rgrads),
                                        tcfg, "cpu")
    loss, grads = _port_grads(tparams, tcfg, batch, chunk=chunk)
    np.testing.assert_allclose(float(loss), float(rloss), **LOSS_TOL)
    _assert_trees_close(grads, want, GRAD_RTOL, "grad")


# -- K5's backward alone --------------------------------------------------------

ATTN_CASES = [  # (B, S, Hq, Hkv, D, causal, window): ragged S, GQA 4 -> 1
    (2, 37, 4, 1, 16, True, None),
    (2, 37, 4, 1, 16, True, 8),
    (1, 50, 4, 2, 32, True, 16),
    (2, 23, 2, 2, 16, False, None),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_backward_plain_matches_reference_grad(case):
    """`flash_attention_bwd_plain` from the plain forward's out and lse
    against `jax.grad` of the reference's attention (its XLA blockwise
    path, ragged kv blocks of 8), and against autograd through the plain
    forward; f32 within 2e-5 of each gradient's largest element."""
    B, S, Hq, Hkv, D, causal, window = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v, do = (rng.normal(size=shape).astype(np.float32) for shape in
                   ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)))

    def rloss(q, k, v):
        out = rattn.blockwise_attention(q, k, v, causal=causal, window=window, block_kv=8)
        return jnp.sum(out * do)

    want = jax.grad(rloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tfa.flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                         return_lse=True)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo, causal=causal,
                                        window=window)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        tfa.flash_attention_plain(*leaves, causal=causal, window=window, block_kv=8),
        leaves, tdo)
    fn = torch.autograd.grad(tfa.flash_attention(*leaves, causal=causal, window=window),
                             leaves, tdo)
    for g, w, a, f in zip(got, want, auto, fn):
        w = np.asarray(w)
        atol = 2e-5 * float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol)
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=atol)
        assert torch.equal(f, g)          # the Function runs the plain backward


def test_flash_forward_lse_is_the_log_sum_exp():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 40, 4, 16)).astype(np.float32))
               for _ in range(3))
    k, v = k[:, :, :1], v[:, :, :1]
    out, lse = tfa.flash_attention_plain(q, k, v, causal=True, window=9, return_lse=True)
    assert torch.equal(out, tfa.flash_attention_plain(q, k, v, causal=True, window=9))
    s = torch.einsum("bqhd,bkd->bhqk", q * 16 ** -0.5, k[:, :, 0])
    pos = torch.arange(40)
    live = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 9)
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


# -- the train step ----------------------------------------------------------------

def _ref_step(rcfg, base_lr, total):
    opt_cfg = rsteps.optimizer_config(rcfg)
    return jax.jit(rsteps.make_train_step(rcfg, opt_cfg, base_lr=base_lr,
                                          total_steps=total)), opt_cfg


def test_one_train_step_matches_reference(models):
    rcfg, rparams, tcfg, tparams = models
    lr, total = 3e-3, 10
    rstep, ropt = _ref_step(rcfg, lr, total)
    rstate = radamw_init(rparams, ropt)
    batch = _batch(rcfg.vocab, seed=4)
    # step 1 (count 0 -> lr 0 under the one-step warmup), then step 2
    tstep = tsteps.make_train_step(tcfg, tsteps.optimizer_config(tcfg), base_lr=lr,
                                   total_steps=total)
    # a fresh port copy (the step updates in place), stored as init_model stores it
    tp = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    ts = adamw_init(tp, tsteps.optimizer_config(tcfg))
    head = tp.get("head")
    rp, rs = rparams, rstate
    for i in range(2):
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, ts, tm = tstep(tp, ts, to_device(batch, "cpu"))
        np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]), **LOSS_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-7)
    assert int(ts["count"]) == int(rs["count"]) == 2
    np.testing.assert_allclose(float(tm["lr"]), lr, rtol=1e-6)
    to_port = lambda t: bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, t), tcfg, "cpu")
    rm_port = to_port(rs["m"])
    for (path, g), w, m in zip(tree_lib.leaves_with_paths(tp), tree_lib.leaves(to_port(rp)),
                               tree_lib.leaves(rm_port)):
        diff = (g.detach() - w).abs()
        live = m.abs() > GRAD_RTOL * float(m.abs().max())
        assert float(diff[live].max()) <= 1e-6 + 1e-3 * lr, f"param {path}"
        assert float(diff.max()) <= 2 * lr, f"param {path}"
    for name in ("m", "v"):
        _assert_trees_close(ts[name], to_port(rs[name]), GRAD_RTOL, name)
    if head is not None:     # updated in place: still the row-padded storage
        assert tp["head"] is head and tgemm.aligned_rows(head) is head
        assert head.stride(0) > head.shape[1]


def test_ten_steps_follow_the_reference_trajectory():
    rcfg, rparams, tcfg, tparams = _models("gemma3-1b")
    lr, total = 3e-3, 10
    rstep, ropt = _ref_step(rcfg, lr, total)
    rs = radamw_init(rparams, ropt)
    tstep = tsteps.make_train_step(tcfg, tsteps.optimizer_config(tcfg), base_lr=lr,
                                   total_steps=total)
    ts = adamw_init(tparams, tsteps.optimizer_config(tcfg))
    data = SyntheticLMData(rcfg.vocab, 4, 32)
    rp, tp, rl, tl = rparams, tparams, [], []
    for i in range(total):
        b = data.batch_at(i)
        rp, rs, m = rstep(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, mt = tstep(tp, ts, to_device(b, "cpu"))
        rl.append(float(m["loss"]))
        tl.append(float(mt["loss"]))
    assert rl[-1] < rl[0]
    np.testing.assert_allclose(tl, rl, rtol=0, atol=2e-4)
