"""The port's MoE block (models/moe.py) against the reference's on the CPU:
dbrx's and arctic's smoke configs (arctic with its dense residual), a
configuration that forces capacity drops, top-k ties, the capacity rule,
the load-balance loss, and the w8a8 router rule of `quantize_params`.
Parameters are the reference's (float32), bridged; inputs are seeded
numpy draws.

Tolerance: float32 outputs within 1e-5 (absolute and relative); the
routing itself (experts chosen, slots kept) must be identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.models.config import MoEConfig as RMoEConfig
from repro.quant import params as rqparams
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.models import moe as TMoE
from repro_torch.models.config import MoEConfig as TMoEConfig

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ffn(arch, capacity_factor=None, seed=0):
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    if capacity_factor is not None:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    rp = RM.init_model(jax.random.PRNGKey(seed), rcfg)
    tp = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rp), tcfg, "cpu")
    i = next(i for i in range(rcfg.group_size) if "router" in rp["blocks"][f"sub{i}"]["ffn"])
    rffn = jax.tree_util.tree_map(lambda a: a[0], rp["blocks"][f"sub{i}"]["ffn"])
    return rcfg, tcfg, rffn, tp["layers"][i]["ffn"]


def _x(B, S, d, seed):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(np.float32)


def _drops(cfg, tffn, x):
    """(pairs routed, pairs dropped) of one call, recomputed from the
    port's routing."""
    T = x.shape[0] * x.shape[1]
    logits = torch.from_numpy(x.reshape(T, -1)) @ tffn["router"]
    _, idx = TMoE.route(logits, cfg.moe.top_k)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
    C = TMoE._capacity(T, cfg)
    return int(counts.sum()), int(torch.clamp(counts - C, min=0).sum())


@pytest.mark.parametrize("arch,B,S", [("dbrx-132b", 2, 8), ("dbrx-132b", 3, 1),
                                      ("arctic-480b", 2, 8), ("arctic-480b", 1, 5),
                                      ("jamba-1.5-large-398b", 2, 6)])
def test_moe_block_matches_reference(arch, B, S):
    """Top-k routing, the capacity buffer, the experts' SwiGLU and the
    weighted combine (plus arctic's dense residual)."""
    rcfg, tcfg, rffn, tffn = _ffn(arch)
    x = _x(B, S, rcfg.d_model, B * 10 + S)
    want = RMoE.moe_block(jnp.asarray(x), rffn, rcfg)
    with torch.no_grad():
        got = TMoE.moe_block(torch.from_numpy(x), tffn, tcfg)
    assert got.shape == (B, S, rcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ("dense" in tffn) == (arch == "arctic-480b")


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b"])
def test_moe_block_capacity_drops_match_reference(arch):
    """capacity_factor 0.25 over 64 tokens: the capacity stays at its floor
    of 8 while every expert is chosen ~16-32 times, so many pairs drop;
    the later tokens' pairs are the ones dropped, as in the reference."""
    rcfg, tcfg, rffn, tffn = _ffn(arch, capacity_factor=0.25)
    x = _x(4, 16, rcfg.d_model, 3)
    routed, dropped = _drops(tcfg, tffn, x)
    assert TMoE._capacity(64, tcfg) == 8 and dropped >= routed // 4
    want = RMoE.moe_block(jnp.asarray(x), rffn, rcfg)
    with torch.no_grad():
        got = TMoE.moe_block(torch.from_numpy(x), tffn, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if arch == "dbrx-132b":
        # no dense residual: the last token lost every pair to earlier ones
        assert np.abs(np.asarray(want)[-1, -1]).max() == 0.0
        assert got[-1, -1].abs().max() == 0.0


def test_route_breaks_ties_as_top_k():
    """Equal logits go to the lower expert index first, as
    `jax.lax.top_k` returns them; values come largest first."""
    logits = np.array([[1.0, 3.0, 3.0, 0.5, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, -1.0, 5.0, 5.0, -1.0],
                       [0.1, 0.2, 0.3, 0.4, 0.5]], np.float32)
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(logits), k)
        gv, gi = TMoE.route(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_capacity_and_aux_loss_match_reference():
    for tokens in (1, 8, 24, 64, 1000):
        for E, k, cf in ((4, 2, 1.25), (16, 4, 1.25), (8, 2, 0.25)):
            rc = dataclasses.replace(rconfigs.get_smoke("dbrx-132b"),
                                     moe=RMoEConfig(num_experts=E, top_k=k, d_ff_expert=8,
                                                    capacity_factor=cf))
            tc = dataclasses.replace(tconfigs.get_smoke("dbrx-132b"),
                                     moe=TMoEConfig(num_experts=E, top_k=k, d_ff_expert=8,
                                                    capacity_factor=cf))
            assert TMoE._capacity(tokens, tc) == RMoE._capacity(tokens, rc)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(32, 8)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1)[:, :2]
    want = RMoE.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    got = TMoE.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_moe_block_is_deterministic():
    """Two calls on the same input give the same bits (the combine sums a
    token's k pairs in choice order)."""
    _, tcfg, _, tffn = _ffn("dbrx-132b")
    x = torch.from_numpy(_x(2, 8, tcfg.d_model, 9))
    with torch.no_grad():
        a, b = TMoE.moe_block(x, tffn, tcfg), TMoE.moe_block(x, tffn, tcfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["dbrx-132b", "arctic-480b", "jamba-1.5-large-398b"])
def test_quantize_params_leaves_experts_float(arch):
    """Under w8a8 a dict with a router stays float whole (experts, router
    and arctic's dense residual), as the reference's walk leaves it; the
    quantized leaves are the reference's, counted per layer
    ((reference count - 1) x n_groups + 1)."""
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rp = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tp = bridge.params_from_reference(jax.tree_util.tree_map(np.asarray, rp), tcfg, "cpu")
    rq = rqparams.quantize_params(rp, cfg=rcfg)
    tq = quant.quantize_params(tp, cfg=tcfg)
    for layer, qlayer in zip(tp["layers"], tq["layers"]):
        ffn = qlayer.get("ffn", {})
        if "router" in ffn:
            for leaf in jax.tree_util.tree_leaves(ffn):
                assert isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            assert ffn["w_gate"] is layer["ffn"]["w_gate"]
    n_ref = rqparams.quantized_leaf_count(rq)
    assert quant.quantized_leaf_count(tq) == (n_ref - 1) * tcfg.n_groups + 1
