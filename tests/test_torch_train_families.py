"""The port's training path against the reference on the CPU, float32, for
every family beyond gemma3-1b and qwen3-14b (tests/test_torch_train.py):
the dense archs qwen2.5-14b, mistral-nemo-12b, bert-base and vit-b-16, the
recurrent xlstm-1.3b, the hybrid jamba-1.5-large-398b and the MoE dbrx-132b
and arctic-480b (this file), whisper-medium and paligemma-3b
(tests/test_torch_train_encdec_vlm.py).  For each smoke config at B 2 x S
32: the loss, and every gradient leaf against `jax.value_and_grad` of the
reference's `loss_fn` (computed once per arch, module-scoped); for one arch
per family, one `make_train_step` step against the reference's jitted step
(`test_torch_train.check_train_step`).

Bars: the loss within 1e-5; each gradient leaf within 2e-4 of max(its
largest |element|, 1e-4 x the whole tree's largest).  The floor is for
leaves whose exact gradient cancels: xlstm's mLSTM input-gate bias
`layers/0/mixer/b_i` has elements ~7e-9 against a tree maximum of 1.76,
so both packages hold f32 rounding there and differ by 5.2e-9, 0.78 of the
leaf's own maximum.  A floor of 1e-6 x the tree's maximum would still
leave that at 2.9e-3 of the floor, over the 2e-4 bar; with 1e-4 x the bar
there is 2e-4 x 1.76e-4 = 3.5e-8, seven times the rounding and a sixth of
one f32 ulp at the tree's maximum.  Every other leaf of the ten archs sits
within 4.7e-6 of its own maximum, so for them the floor changes nothing.
The AdamW moments and the updated parameters of the step take the same
floor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro_torch import bridge
from repro_torch.data import SyntheticLMData, to_device
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.models import model as TM

from test_torch_train import (GRAD_RTOL, LOSS_TOL, _assert_trees_close, _models,
                              _port_grads, check_train_step)

FLOOR_OF_TREE = 1e-4      # of the tree's largest |gradient element| (docstring)
ARCHS = ("qwen2.5-14b", "mistral-nemo-12b", "bert-base", "vit-b-16", "xlstm-1.3b",
         "jamba-1.5-large-398b", "dbrx-132b", "arctic-480b")
STEP_ARCHS = ("xlstm-1.3b", "jamba-1.5-large-398b", "dbrx-132b")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def family_batch(cfg, B=2, S=32, seed=0, cursor=3):
    """`SyntheticLMData` with the family's extras: whisper's encoder frames
    (B, encoder_seq, d) and paligemma's patches (B, prefix_len, VISION_DIM)."""
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["patches"] = (cfg.prefix_len, TM.VISION_DIM)
    return SyntheticLMData(cfg.vocab, B, S, seed=seed, extras=extras).batch_at(cursor)


def reference_case(arch):
    """(rcfg, rparams, tcfg, tparams, batch, reference loss, reference
    gradients carried into the port's tree)."""
    rcfg, rparams, tcfg, tparams = _models(arch)
    batch = family_batch(tcfg)
    rloss, rgrads = jax.value_and_grad(RM.loss_fn)(
        rparams, rcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rgrads), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams, batch, float(rloss), want


def check_loss(case):
    _, _, tcfg, tparams, batch, rloss, _ = case
    with torch.no_grad():
        got = float(TM.loss_fn(tparams, tcfg, to_device(batch, "cpu")))
    np.testing.assert_allclose(got, rloss, **LOSS_TOL)


def check_gradients(case):
    _, _, tcfg, tparams, batch, rloss, want = case
    tfa.reset_launches()
    before = tgemm.launches
    loss, grads = _port_grads(tparams, tcfg, batch)
    assert tfa.launches == tfa.bwd_launches == 0 and tgemm.launches == before   # CPU: plain
    np.testing.assert_allclose(float(loss), rloss, **LOSS_TOL)
    _assert_trees_close(grads, want, GRAD_RTOL, "grad", FLOOR_OF_TREE)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return reference_case(request.param)


def test_loss_matches_reference(case):
    check_loss(case)


def test_every_gradient_leaf_matches_reference(case):
    check_gradients(case)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_train_step_matches_reference(arch):
    rcfg, rparams, tcfg, _ = _models(arch)
    check_train_step(rcfg, rparams, tcfg, family_batch(tcfg, seed=4), FLOOR_OF_TREE)


@pytest.mark.parametrize("start", ["init", "carried"])
def test_slstm_scan_backward_matches_autograd(start):
    """`ssm._SLSTMScan`'s hand-written backward through time against
    autograd through `ssm._slstm_steps`, float64, from the init state (m
    = -1e30, zeros) and from a carried one, with exact ties in the input
    gate's maximum (amax splits its gradient among them, maximum halves
    it): every input's gradient within 1e-12 of its largest element; the
    forward's states bit for bit."""
    from repro_torch.models import ssm

    g = torch.Generator().manual_seed(11)
    S, H, B, hd = 40, 3, 2, 8
    f64 = dict(dtype=torch.float64)
    pre = torch.randn((S, H, B, 4 * hd), generator=g, **f64)
    pre[:, :, :, 0] = pre[:, :, :, 1] = pre[:, :, :, :hd].amax(-1) + 0.5     # ties
    rec = torch.randn((H, hd, 4 * hd), generator=g, **f64) * hd ** -0.5
    b_f = torch.full((H, 1, hd), 3.0, **f64)
    if start == "init":
        st = [torch.zeros((H, B, hd), **f64) for _ in range(3)] + [
            torch.full((H, B), ssm.M_INIT, **f64)]
    else:
        st = [torch.rand((H, B, hd), generator=g, **f64) for _ in range(3)] + [
            torch.randn((H, B), generator=g, **f64)]
    ins = [t.requires_grad_(True) for t in (pre, rec, b_f, *st)]
    weights = None
    grads = []
    for fn in (lambda *a: ssm._slstm_steps(*a, save=False), ssm._SLSTMScan.apply):
        outs = fn(*ins)
        if weights is None:
            weights = [torch.randn(o.shape, generator=g, **f64) for o in outs]
            first = [o.detach() for o in outs]
        else:
            assert all(torch.equal(a, b.detach()) for a, b in zip(first, outs))
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        grads.append(torch.autograd.grad(loss, ins))
    for want, got in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-12 * max(float(want.abs().max()), 1.0))
