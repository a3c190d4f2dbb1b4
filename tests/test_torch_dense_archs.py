"""The port's dense family against the reference on the five smoke configs
it adds (qwen3-14b: qk-norm; qwen2.5-14b: QKV bias; mistral-nemo-12b: a
q width other than d_model; bert-base and vit-b-16: LayerNorm and the GELU
MLP with biases; all five untied), float32 on the CPU.

Each arch's reference parameters come from `init_model(PRNGKey(0))` with
every bias and norm vector then drawn from a seeded numpy generator (the
reference initializes biases to 0 and norms to 1, which would leave those
code paths unchecked), carried over by the bridge."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro import quant as rquant
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import model as RM
from repro.serving.prefill import plan_chunks
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.kernels import gemm as tgemm
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.serving import kv_cache as tkvc

ARCHS = ["qwen3-14b", "qwen2.5-14b", "mistral-nemo-12b", "bert-base", "vit-b-16"]
TOL = dict(rtol=3e-4, atol=3e-4)      # tests/test_torch_forward.py's bar
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
# Leaves the reference initializes to 0 (biases) or 1 (norm scales).
BIASES = {"bq", "bk", "bv", "b_up", "b_down", "bias"}
NORMS = {"scale", "q_norm", "k_norm", "norm1", "norm2", "final_norm"}


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def vary_vectors(rparams, seed: int = 0):
    """`rparams` with every bias drawn from 0.1 x N(0, 1) and every norm
    scale from 1 + 0.1 x N(0, 1) (seeded numpy draws, leaf by leaf)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        names = {getattr(k, "key", None) for k in path}
        if names & BIASES:
            return jnp.asarray(0.1 * rng.normal(size=x.shape), x.dtype)
        if names & NORMS:
            return jnp.asarray(1 + 0.1 * rng.normal(size=x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, rparams)


def build(arch: str):
    """(rcfg, rparams, tcfg, tparams) of `arch`'s smoke config, the port's
    parameters bridged from the reference's through numpy."""
    rcfg, tcfg = rconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    rparams = vary_vectors(RM.init_model(jax.random.PRNGKey(0), rcfg))
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return build(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_mirrors_reference(arch):
    for get in ("get", "get_smoke"):
        r, t = getattr(rconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert t.layer_kinds() == r.layer_kinds()
        assert t.param_count() == r.param_count()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(r, f.name), f.name
        assert t.resolved_head_dim == r.resolved_head_dim
    assert arch in tconfigs.list_archs()


def test_vectors_varied(models):
    """The fixture's biases and norms are not the reference's 0 / 1 init."""
    _, _, tcfg, tparams = models
    layer = tparams["layers"][0]
    if tcfg.norm == "ln":
        assert float(layer["norm1"]["bias"].abs().max()) > 0
    else:
        assert float((layer["norm1"] - 1).abs().max()) > 0
    mixer = layer["mixer"]
    assert all((n in mixer) == tcfg.qkv_bias for n in ("bq", "bk", "bv"))
    assert all((n in mixer) == tcfg.qk_norm for n in ("q_norm", "k_norm"))


def test_bridged_parameter_count(models):
    rcfg, rparams, tcfg, tparams = models
    assert bridge.param_count(tparams, min_dim=2) == tcfg.param_count()
    assert bridge.param_count(tparams) == sum(
        x.size for x in jax.tree_util.tree_leaves(rparams))
    assert tuple(tparams["head"].shape) == (tcfg.d_model, tcfg.vocab)
    assert len(tparams["layers"]) == tcfg.n_layers


def test_layer_norm_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=(24,)).astype(np.float32),
         "bias": rng.normal(size=(24,)).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.layer_norm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                           1e-6).numpy(),
        np.asarray(rlayers.layer_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                      1e-6)),
        **LAYER_TOL)
    h = rng.normal(size=(3, 16)).astype(np.float32)
    w = {k: rng.normal(size=s).astype(np.float32) * 0.5 for k, s in
         (("w_up", (16, 24)), ("b_up", (24,)), ("w_down", (24, 16)), ("b_down", (16,)))}
    got = tlayers.mlp(torch.from_numpy(h), {k: torch.from_numpy(v) for k, v in w.items()}, "gelu")
    want = rlayers.mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in w.items()}, "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    # torch's default GELU is the exact erf form; the reference's the tanh form.
    hu = torch.from_numpy(h @ w["w_up"] + w["b_up"])
    exact = torch.nn.functional.gelu(hu) @ torch.from_numpy(w["w_down"])
    assert float((exact + torch.from_numpy(w["b_down"]) - got).abs().max()) > 1e-5


def test_attention_sublayer_matches_reference(models):
    """Layer 0's attention sublayer over the sequence itself: the QKV bias
    and qk-norm (where the arch has them) inside the projection."""
    rcfg, rparams, tcfg, tparams = models
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["blocks"]["sub0"]["mixer"])
    x = np.random.default_rng(1).normal(size=(2, 12, rcfg.d_model)).astype(np.float32)
    pos = np.arange(12)
    want, _ = rattn.attention(jnp.asarray(x), rp, rcfg, positions=jnp.asarray(pos))
    got = tattn.attention(torch.from_numpy(x), tparams["layers"][0]["mixer"], tcfg,
                          positions=torch.from_numpy(pos), window=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_forward_matches_reference(models):
    rcfg, rparams, tcfg, tparams = models
    tokens = np.random.default_rng(3).integers(0, rcfg.vocab, size=(2, 20)).astype(np.int32)
    want = np.asarray(RM.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)}))
    with torch.no_grad():
        got = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens).long()})
    assert got.shape == (2, 20, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_paged_steps_match_reference(models):
    """Chunked prefill of two slots, then three paged decode steps: logits
    step for step within the forward bar, and equal lengths."""
    rcfg, rparams, tcfg, tparams = models
    slots, prompt_len, bs, max_blocks = 2, 7, 4, 4
    num_blocks = 1 + slots * max_blocks
    rstate = RM.init_paged_decode_state(rcfg, slots, num_blocks=num_blocks, block_size=bs,
                                        max_blocks_per_slot=max_blocks)
    tstate = TM.init_paged_decode_state(tcfg, slots, num_blocks=num_blocks, block_size=bs,
                                        max_blocks_per_slot=max_blocks, device="cpu")
    alloc, tables = tkvc.BlockAllocator(num_blocks, bs), tkvc.BlockTables(slots, max_blocks)
    for s in range(slots):
        tables.ensure(s, prompt_len + 4, alloc)
    rstate = rstate._replace(block_tables=jnp.asarray(tables.table))
    tstate.block_tables = tables.array("cpu")
    prompts = np.random.default_rng(0).integers(
        0, rcfg.vocab, size=(slots, prompt_len)).astype(np.int32)
    with torch.no_grad():
        for s in range(slots):
            pos = 0
            for c in plan_chunks(prompt_len, max_chunk=4):
                chunk = prompts[s:s + 1, pos:pos + c]
                rl, rstate = RM.prefill_chunk(rparams, rcfg, rstate, jnp.asarray(chunk),
                                              jnp.int32(s))
                tl, tstate = TM.prefill_chunk(tparams, tcfg, tstate,
                                              torch.from_numpy(chunk).long(), s)
                np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
                pos += c
        tok = np.full((slots, 1), np.argmax(np.asarray(rl)[0, -1]), np.int32)
        for _ in range(3):
            rl, rstate = RM.paged_decode_step(rparams, rcfg, rstate, jnp.asarray(tok))
            tl, tstate = TM.paged_decode_step(tparams, tcfg, tstate,
                                              torch.from_numpy(tok).long())
            np.testing.assert_allclose(tl.numpy(), np.asarray(rl), **TOL)
            tok = np.argmax(np.asarray(rl)[:, -1], -1)[:, None].astype(np.int32)
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(rstate.lengths))


def test_calibrated_scale_table_matches_reference():
    """qwen3-14b's calibration: the same sites, the untied "head" among
    them, and the same per-tensor scales."""
    rcfg, rparams, tcfg, tparams = build("qwen3-14b")
    batches = rquant.synthetic_batches(rcfg)
    want = rquant.collect_scales(rparams, rcfg, batches)
    got = quant.collect_scales(tparams, tcfg, batches)
    assert sorted(got.scales) == sorted(want.scales)
    assert "head" in got.scales and len(got) == 7 * tcfg.n_layers + 1
    for k, v in want.scales.items():
        np.testing.assert_allclose(got.scales[k], v, rtol=1e-5, err_msg=k)
    q = quant.quantize_params(tparams, cfg=tcfg, scales=got)
    assert "head_q" not in q and isinstance(q["head"], quant.QuantTensor)
    assert float(q["head"].act_scale) == pytest.approx(got.scales["head"])
    assert quant.quantized_leaf_count(q) == 7 * tcfg.n_layers + 1
    assert q["layers"][0]["mixer"]["q_norm"] is tparams["layers"][0]["mixer"]["q_norm"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_untied_head_rows_aligned(dtype):
    """bert-base's 30522-wide head: each row starts 16 bytes aligned,
    whether `init_model` made it or the bridge carried it, so the GeMM
    takes it in place (no re-laid copy); the logits keep the vocab width."""
    cfg = dataclasses.replace(tconfigs.get("bert-base"), n_layers=1, group_size=1,
                              dtype=dtype)
    assert cfg.vocab % 8
    params = TM.init_model(cfg, seed=0, device="cpu")
    head = params["head"]
    assert tuple(head.shape) == (cfg.d_model, cfg.vocab) and head.stride(1) == 1
    assert (head.stride(0) * head.element_size()) % 16 == 0 and head.data_ptr() % 16 == 0
    tgemm.reset_launches()
    assert tgemm.rows_for_copies(head) is head
    x = torch.randn((3, cfg.d_model)).to(head.dtype)
    a, b, kmajor = tgemm.operands_for_copies(x, head)
    assert b is head and a is x and not kmajor and tgemm.relaid == 0
    unpadded = head.contiguous()                     # 30522-element rows: re-laid
    assert tgemm.rows_for_copies(unpadded) is not unpadded and tgemm.relaid == 1
    bridged = bridge.params_from_reference(
        {"embed": params["embed"].float().numpy(),
         "final_norm": {k: v.float().numpy() for k, v in params["final_norm"].items()},
         "head": head.float().numpy(),
         "blocks": {"sub0": jax.tree_util.tree_map(
             lambda t: t.float().numpy()[None], params["layers"][0])}}, cfg, "cpu")
    assert tgemm.rows_for_copies(bridged["head"]) is bridged["head"]
    torch.testing.assert_close(bridged["head"], head, rtol=0, atol=0)
    with torch.no_grad():
        logits = TM.forward(params, cfg, {"tokens": torch.tensor([[1, 2, 3]])})
    assert logits.shape == (1, 3, cfg.vocab)
