"""The port's recurrent blocks (models/ssm.py) against the reference's on
the CPU: Mamba (from scratch, chunked with a carried state, the S = 1
decode update, per-position states), mLSTM (the chunkwise form against the
reference and against the port's own sequential form, a non-zero initial
state, per-position states) and sLSTM.  Parameters are the reference's
(jamba and xlstm smoke configs, float32) with their bias / A_log / D /
conv leaves perturbed by seeded noise, bridged; inputs and carried states
are seeded numpy draws.

Tolerances: float32 throughout.  Mamba's in-chunk scan combines in another
order than `jax.lax.associative_scan`, and the recurrences run over up to
128 tokens, so outputs are held within 2e-5 (absolute and relative) of the
reference's, states within 2e-5 as well."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as RM
from repro.models import ssm as RS
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import ssm as TS

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _perturbed(tree, seed):
    """The reference tree with every 1-D leaf and the conv weights moved
    by seeded noise (their inits are zeros / ones / constants)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for a in leaves:
        a = np.asarray(a)
        if a.ndim <= 2 and a.shape[-1] != 0 and a.size < 4096:
            a = (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        out.append(a)
    return jax.tree_util.tree_unflatten(treedef, out)


def _mixers(arch, seed=0):
    """(reference cfg, port cfg, [(kind, reference mixer, port mixer)])
    for the layers of the smoke config's first group."""
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rp = _perturbed(RM.init_model(jax.random.PRNGKey(seed), rcfg), seed + 1)
    tp = bridge.params_from_reference(rp, tcfg, "cpu")
    out = []
    for i, kind in enumerate(rcfg.layer_kinds()):
        rmix = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), rp["blocks"][f"sub{i}"]["mixer"])
        out.append((kind, rmix, tp["layers"][i]["mixer"]))
    return rcfg, tcfg, out


@pytest.fixture(scope="module")
def jamba():
    rcfg, tcfg, mixers = _mixers("jamba-1.5-large-398b")
    _, rmix, tmix = next(m for m in mixers if m[0] == "mamba")
    return rcfg, tcfg, rmix, tmix


@pytest.fixture(scope="module")
def xlstm():
    rcfg, tcfg, mixers = _mixers("xlstm-1.3b")
    got = {kind: (rmix, tmix) for kind, rmix, tmix in mixers}
    return rcfg, tcfg, got


def _x(B, S, d, seed):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_state(got, want, **tol):
    assert type(got).__name__ == type(want).__name__
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **(tol or TOL))


def _random_state(kind, cfg_t, B, seed):
    """A non-trivial carried state of `kind` (port NamedTuple, numpy-drawn)."""
    rng = np.random.default_rng(seed)
    init = TS.init_state_for_kind(cfg_t, kind, B, "cpu")
    leaves = []
    for name, leaf in zip(init._fields, init):
        a = rng.normal(size=tuple(leaf.shape)).astype(np.float32)
        if name == "m":
            a = rng.uniform(-2, 2, size=a.shape).astype(np.float32)
        if name == "n" and kind == "slstm":
            a = np.abs(a) + 0.5
        leaves.append(torch.from_numpy(a).to(leaf.dtype))
    return type(init)(*leaves)


def _ref_state(kind, state):
    cls = {"mamba": RS.MambaState, "mlstm": RS.MLSTMState, "slstm": RS.SLSTMState}[kind]
    return cls(*(jnp.asarray(t.numpy()) for t in state))


# -- Mamba ---------------------------------------------------------------------


def test_mamba_from_scratch_matches_reference(jamba):
    """S = 40: two full 16-token chunks and a ragged tail (the chunk halves
    to 8); no state in, none out."""
    rcfg, tcfg, rmix, tmix = jamba
    x = _x(2, 40, rcfg.d_model, 1)
    want, wst = RS.mamba_block(jnp.asarray(x), rmix, rcfg)
    with torch.no_grad():
        got, gst = TS.mamba_block(_t(x), tmix, tcfg)
    assert wst is None and gst is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 5, 16, 24])
def test_mamba_with_carried_state_matches_reference(jamba, S):
    """A random carried state (h and the conv tail): S = 1 is the O(1)
    decode update, S > 1 the chunked scan resuming from it."""
    rcfg, tcfg, rmix, tmix = jamba
    x = _x(3, S, rcfg.d_model, S)
    st = _random_state("mamba", tcfg, 3, S + 100)
    want, wst = RS.mamba_block(jnp.asarray(x), rmix, rcfg, state=_ref_state("mamba", st))
    with torch.no_grad():
        got, gst = TS.mamba_block(_t(x), tmix, tcfg, state=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state(gst, wst)


@pytest.mark.parametrize("S", [2, 5])
def test_mamba_collect_states_matches_reference(jamba, S):
    """Per-position states (B, S, ...) for verify's restore; the last
    position's equals the chunked step's final state."""
    rcfg, tcfg, rmix, tmix = jamba
    x = _x(2, S, rcfg.d_model, 7)
    st = _random_state("mamba", tcfg, 2, 8)
    want, wst = RS.mamba_block(jnp.asarray(x), rmix, rcfg, state=_ref_state("mamba", st),
                               collect_states=True)
    with torch.no_grad():
        got, gst = TS.mamba_block(_t(x), tmix, tcfg, state=st, collect_states=True)
        _, final = TS.mamba_block(_t(x), tmix, tcfg, state=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state(gst, wst)
    assert gst.h.shape == (2, S) + tuple(st.h.shape[1:])
    for per, last in zip(gst, final):
        torch.testing.assert_close(per[:, -1], last, rtol=0, atol=0)


def test_prefix_scan_is_the_sequential_recurrence():
    """The doubling scan gives h_t = a_t h_{t-1} + b_t from h = 0 within
    f32 rounding, for chunk lengths that are and are not powers of two."""
    rng = np.random.default_rng(0)
    for n in (1, 3, 8, 13, 16):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, size=(2, n, 3, 4)).astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(2, n, 3, 4)).astype(np.float32))
        pa, pb = TS._prefix_scan(a, b)
        h, prod = torch.zeros((2, 3, 4)), torch.ones((2, 3, 4))
        for t in range(n):
            h, prod = a[:, t] * h + b[:, t], a[:, t] * prod
            torch.testing.assert_close(pb[:, t], h, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(pa[:, t], prod, rtol=1e-6, atol=1e-6)


# -- mLSTM ---------------------------------------------------------------------


@pytest.mark.parametrize("S", [24, 128])
def test_mlstm_chunkwise_matches_reference(xlstm, S):
    """No state and S > 1: the chunkwise-parallel form (128 tokens = two
    64-token chunks carrying the stabilized state between them)."""
    rcfg, tcfg, mix = xlstm
    rmix, tmix = mix["mlstm"]
    x = _x(2, S, rcfg.d_model, S)
    want, _ = RS.mlstm_block(jnp.asarray(x), rmix, rcfg)
    with torch.no_grad():
        got, st = TS.mlstm_block(_t(x), tmix, tcfg)
    assert st is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mlstm_chunkwise_equals_sequential_form(xlstm):
    """The port's chunkwise form (state None) against its own sequential
    step from the init state (the form a carried state takes), 128 tokens:
    the same recurrence, within 2e-5."""
    _, tcfg, mix = xlstm
    _, tmix = mix["mlstm"]
    x = _t(_x(2, 128, tcfg.d_model, 5))
    with torch.no_grad():
        chunkwise, _ = TS.mlstm_block(x, tmix, tcfg)
        sequential, final = TS.mlstm_block(x, tmix, tcfg,
                                           state=TS.init_mlstm_state(tcfg, 2, "cpu"))
        # and the chunkwise state after 128 tokens is the sequential one
        B, S = 2, 128
        di, H = 2 * tcfg.d_model, tcfg.n_heads
        up = x @ tmix["w_up"]
        xm = up[..., :di]
        heads = [(xm @ tmix[w]).reshape(B, S, H, di // H) for w in ("w_q", "w_k", "w_v")]
        heads[1] = heads[1] * (di // H) ** -0.5
        i_pre = xm @ tmix["w_i"] + tmix["b_i"]
        f_pre = xm @ tmix["w_f"] + tmix["b_f"]
        _, st = TS._mlstm_chunkwise(*heads, i_pre, f_pre, TS.init_mlstm_state(tcfg, B, "cpu"))
    torch.testing.assert_close(chunkwise, sequential, **TOL)
    for name, a, b in zip(final._fields, st, final):
        if name == "m":
            # both stabilizers are valid; compare the state they represent
            continue
        scale = torch.exp(st.m - final.m)
        want = b * scale.reshape(scale.shape + (1,) * (b.dim() - 2))
        torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("S", [1, 6])
def test_mlstm_with_carried_state_matches_reference(xlstm, S):
    """A non-zero carried state (C, n and the stabilizer m): the sequential
    step, one token (decode) or six (a prefill chunk)."""
    rcfg, tcfg, mix = xlstm
    rmix, tmix = mix["mlstm"]
    x = _x(3, S, rcfg.d_model, 20 + S)
    st = _random_state("mlstm", tcfg, 3, 30 + S)
    want, wst = RS.mlstm_block(jnp.asarray(x), rmix, rcfg, state=_ref_state("mlstm", st))
    with torch.no_grad():
        got, gst = TS.mlstm_block(_t(x), tmix, tcfg, state=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state(gst, wst)


def test_mlstm_collect_states_matches_reference(xlstm):
    rcfg, tcfg, mix = xlstm
    rmix, tmix = mix["mlstm"]
    x = _x(2, 5, rcfg.d_model, 40)
    st = _random_state("mlstm", tcfg, 2, 41)
    want, wst = RS.mlstm_block(jnp.asarray(x), rmix, rcfg, state=_ref_state("mlstm", st),
                               collect_states=True)
    with torch.no_grad():
        got, gst = TS.mlstm_block(_t(x), tmix, tcfg, state=st, collect_states=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state(gst, wst)
    assert gst.C.shape[:2] == (2, 5)


# -- sLSTM ---------------------------------------------------------------------


@pytest.mark.parametrize("carried,S", [(False, 9), (True, 1), (True, 4)])
def test_slstm_matches_reference(xlstm, carried, S):
    rcfg, tcfg, mix = xlstm
    rmix, tmix = mix["slstm"]
    x = _x(2, S, rcfg.d_model, 50 + S)
    st = _random_state("slstm", tcfg, 2, 51) if carried else None
    want, wst = RS.slstm_block(jnp.asarray(x), rmix, rcfg,
                               state=None if st is None else _ref_state("slstm", st))
    with torch.no_grad():
        got, gst = TS.slstm_block(_t(x), tmix, tcfg, state=st)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if carried:
        _assert_state(gst, wst)
    else:
        assert gst is None and wst is None


def test_slstm_collect_states_matches_reference(xlstm):
    rcfg, tcfg, mix = xlstm
    rmix, tmix = mix["slstm"]
    x = _x(2, 3, rcfg.d_model, 60)
    st = _random_state("slstm", tcfg, 2, 61)
    want, wst = RS.slstm_block(jnp.asarray(x), rmix, rcfg, state=_ref_state("slstm", st),
                               collect_states=True)
    with torch.no_grad():
        got, gst = TS.slstm_block(_t(x), tmix, tcfg, state=st, collect_states=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_state(gst, wst)


# -- the states ----------------------------------------------------------------


@pytest.mark.parametrize("arch,kind", [("jamba-1.5-large-398b", "mamba"),
                                       ("xlstm-1.3b", "mlstm"), ("xlstm-1.3b", "slstm")])
def test_init_states_match_reference(arch, kind):
    """Shapes, dtypes and values of every kind's init state (m = -1e30,
    the rest zero), at the smoke widths and in bf16."""
    for dtype in ("float32", "bfloat16"):
        rcfg = dataclasses.replace(rconfigs.get_smoke(arch), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
        want = {"mamba": RS.init_mamba_state, "mlstm": RS.init_mlstm_state,
                "slstm": RS.init_slstm_state}[kind](rcfg, 3)
        got = TS.init_state_for_kind(tcfg, kind, 3, "cpu")
        for name, g, w in zip(want._fields, got, want):
            assert tuple(g.shape) == w.shape, name
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_reset_and_select_in_place():
    """`reset_state_` returns masked slots to the init and `select_into_`
    takes new values for masked slots only, both writing the state's own
    tensors."""
    cfg = tconfigs.get_smoke("xlstm-1.3b")
    st = _random_state("mlstm", cfg, 3, 0)
    ptrs = [t.data_ptr() for t in st]
    keep = [t.clone() for t in st]
    mask = torch.tensor([True, False, True])
    TS.reset_state_(st, mask)
    assert [t.data_ptr() for t in st] == ptrs
    assert torch.all(st.m[[0, 2]] == -1e30) and torch.all(st.C[[0, 2]] == 0)
    for t, k in zip(st, keep):
        torch.testing.assert_close(t[1], k[1], rtol=0, atol=0)
    new = _random_state("mlstm", cfg, 3, 1)
    TS.select_into_(st, new, torch.tensor([False, True, False]))
    assert [t.data_ptr() for t in st] == ptrs
    for t, n in zip(st, new):
        torch.testing.assert_close(t[1], n[1], rtol=0, atol=0)
    assert torch.all(st.m[[0, 2]] == -1e30)
    assert TS.state_bytes(st) == sum(t.numel() * 4 for t in st)
