"""The port's analysis layer against the reference's, on the CPU: the shape
grid, `model_flops` and the dry run's structs (params, optimizer state,
decode state) for every arch x shape at published widths; `step_cost`
(repro_torch.launch.step_cost, the counterpart of hlo_cost.py) on the
reference's own cases and on a smoke forward against a count reckoned from
the config; every kernel wrapper's meta route against its plain version;
`run_cell` on one smoke config per family; `diagnose.attribute` on a CPU
profile of a smoke train step; and the cost functions against the bounds
chip_smoke.py's phase 5 printed on the H100 (PERF.md section 6)."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import roofline as RR
from repro.launch import steps as RS
from repro_torch import configs as TC
from repro_torch import tree as tree_lib
from repro_torch.kernels import cost as kcost
from repro_torch.launch import diagnose, dryrun, roofline as TR, step_cost, steps as TS

ARCHS = RC.list_archs()
META = torch.device("meta")


def _ref_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _dt(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _jax_bytes(tree) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


def _torch_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def test_shape_grid_equal():
    assert TC.SHAPES == RC.SHAPES
    assert TC.LONG_CONTEXT_ARCHS == RC.LONG_CONTEXT_ARCHS
    assert TC.list_archs() == ARCHS or set(TC.list_archs()) == set(ARCHS)
    assert all(TC.shapes_for(a) == RC.shapes_for(a) for a in ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal(arch):
    for name in RC.shapes_for(arch):
        assert TR.model_flops(TC.get(arch), TC.SHAPES[name]) == \
            RR.model_flops(RC.get(arch), RC.SHAPES[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_params_struct_equal_leaf_for_leaf(arch):
    """Shape and dtype of every leaf, paired as bridge.py pairs them: the
    reference's stacked blocks/sub{i} leaf (n_groups, ...) is layer g *
    group_size + i of the port's list, its encoder_blocks leaf
    (encoder_layers, ...) encoder block e."""
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    ref, port = RS.params_struct(rcfg), TS.params_struct(tcfg)
    assert all(t.device.type == "meta" for t in tree_lib.leaves(port))
    paired = 0
    for path, leaf in _ref_leaves(ref):
        if path[0] == "blocks":
            i = int(path[1][3:])
            got = [_get(port["layers"][g * tcfg.group_size + i], path[2:])
                   for g in range(tcfg.n_groups)]
            want = tuple(leaf.shape[1:])
        elif path[0] == "encoder_blocks":
            got = [_get(b, path[1:]) for b in port["encoder_blocks"]]
            assert len(got) == leaf.shape[0]
            want = tuple(leaf.shape[1:])
        else:
            got, want = [_get(port, path)], tuple(leaf.shape)
        for t in got:
            assert tuple(t.shape) == want and _dt(t) == str(leaf.dtype), (path, t.shape, want)
        paired += len(got)
    assert paired == len(tree_lib.leaves(port))


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_and_decode_state_bytes_equal(arch):
    rcfg, tcfg = RC.get(arch), TC.get(arch)
    rp, tp = RS.params_struct(rcfg), TS.params_struct(tcfg)
    ro = RS.opt_state_struct(rcfg, rp, RS.optimizer_config(rcfg))
    to = TS.opt_state_struct(tcfg, tp, TS.optimizer_config(tcfg))
    assert _torch_bytes(tree_lib.leaves(to)) == _jax_bytes(ro)
    rd = RS.decode_state_struct(rcfg, rp, 2, 128)
    td = TS.decode_state_struct(tcfg, tp, 2, 128)
    got = _torch_bytes(tree_lib.leaves([td.caches, td.cross_caches or [], td.index]))
    assert got == _jax_bytes(rd)


def test_input_specs_match_reference():
    for arch in ("gemma3-1b", "whisper-medium", "paligemma-3b"):
        for name, shape in RC.SHAPES.items():
            r, t = RS.input_specs(RC.get(arch), shape), TS.input_specs(TC.get(arch), shape)
            flat_r = {"/".join(map(str, p)): x for p, x in _ref_leaves(r) if hasattr(x, "shape")}
            flat_t = {"/".join(map(str, p)): x for p, x in _ref_leaves(t)
                      if isinstance(x, torch.Tensor)}
            assert flat_r.keys() == flat_t.keys()
            for k, x in flat_r.items():
                assert tuple(flat_t[k].shape) == tuple(x.shape) and _dt(flat_t[k]) == str(x.dtype)
            assert r.get("max_seq") == t.get("max_seq")


# -- step_cost: the reference's hlo_cost cases (tests/test_system.py) -------------


def test_step_cost_counts_a_product_and_its_tanh():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    c = step_cost.analyze(lambda: torch.tanh(a @ b).sum())
    assert c.flops == 2 * 64 * 128 * 32
    am, bm = a.to(META), b.to(META)
    assert step_cost.analyze(lambda: torch.tanh(am @ bm).sum()).flops == 2 * 64 * 128 * 32


def test_step_cost_counts_every_loop_iteration():
    def g(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x

    c = step_cost.analyze(g, torch.randn(32, 32), torch.randn(32, 32))
    assert c.flops == 7 * 2 * 32 ** 3


def test_step_cost_single_process_has_no_collectives():
    c = step_cost.analyze(lambda a: a * 2, torch.randn(8))
    assert c.collective_bytes == 0 and not c.collective_count
    assert c.bytes_accessed == 2 * 8 * 4


def test_step_cost_peak_counts_storages_not_views():
    def f(x):
        y = x * 2                       # 4 KB made
        v = y.view(32, 8)               # a view: nothing
        z = v + 1                       # 4 KB more, y still alive
        del y, v
        return z.sum()

    c = step_cost.analyze(f, torch.randn(256))
    assert c.peak_live_bytes == 2 * 256 * 4


def test_smoke_forward_flops_equal_a_count_from_the_config():
    cfg = TC.get_smoke("qwen3-14b")
    assert set(cfg.layer_kinds()) == {"attn"} and cfg.moe is None
    B, S = 2, 24
    params = TS.params_struct(cfg)
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    with torch.no_grad():
        c = step_cost.analyze(lambda: __import__(
            "repro_torch.models.model", fromlist=["forward"]).forward(params, cfg, batch))
    d, ff, V, hd = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    per_layer = 2 * B * S * (d * hq * hd + 2 * d * hkv * hd + hq * hd * d + 3 * d * ff) \
        + 4 * B * hq * hd * (S * (S + 1) // 2)
    want = cfg.n_groups * cfg.group_size * per_layer + 2 * B * S * d * V
    assert c.flops == want
    assert c.launches == {"gemm": 7 * cfg.n_groups * cfg.group_size + 1,
                          "flash_attention": cfg.n_groups * cfg.group_size}


# -- the kernels' meta routes against their plain versions -------------------------


def _paged(dtype, int8=False):
    from repro_torch.serving import kv_cache as kvc

    g = torch.Generator().manual_seed(0)
    nb, bs, Hkv, D = 9, 16, 2, 64
    if int8:
        k = torch.randint(-127, 128, (nb, bs, Hkv, D), generator=g, dtype=torch.int8)
        sc = torch.rand((nb, bs, Hkv), generator=g)
        cache = kvc.PagedKVCache(k, k.clone(), sc, sc.clone())
    else:
        k = torch.randn((nb, bs, Hkv, D), generator=g).to(dtype)
        cache = kvc.PagedKVCache(k, k.clone(), None, None)
    tables = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    q = torch.randn((2, 3, 4, D), generator=g).to(dtype)
    return q, cache, tables, torch.tensor([20, 40], dtype=torch.int32)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to(META)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_meta(v) for v in x))
    return x


def _route_cases():
    from repro_torch.kernels import flash_attention as fa, flash_decode as fd
    from repro_torch.kernels import gemm, gemm_int8, gemm_pipelined, quant

    g = torch.Generator().manual_seed(1)
    bf, f32 = torch.bfloat16, torch.float32
    a, b = torch.randn((8, 64), generator=g).to(bf), torch.randn((64, 48), generator=g).to(bf)
    ai = torch.randint(-127, 128, (40, 64), generator=g, dtype=torch.int8)
    bi = torch.randint(-127, 128, (64, 48), generator=g, dtype=torch.int8)
    sa, sb = torch.rand((40, 1), generator=g), torch.rand((1, 48), generator=g)
    x8, x40 = torch.randn((8, 64), generator=g).to(bf), torch.randn((40, 64), generator=g)
    q = torch.randn((2, 24, 4, 64), generator=g).to(bf)
    k = torch.randn((2, 24, 2, 64), generator=g).to(bf)
    out, lse = fa.flash_attention_plain(q, k, k, window=8, return_lse=True)
    return {
        "gemm": (gemm.gemm, (a, b), dict(out_dtype=bf)),
        "gemm f32 out": (gemm.gemm, (a, b), {}),
        "gemm_pipelined": (gemm_pipelined.gemm, (a, b), dict(out_dtype=bf)),
        "gemm_int": (gemm_int8.gemm_int, (ai, bi), {}),
        "dequant_gemm": (gemm_int8.dequant_gemm, (ai, bi, sa, sb), dict(out_dtype=bf)),
        "gemm_w8a8 one launch": (gemm_int8.gemm_w8a8, (x8, bi, sb.reshape(-1)),
                                 dict(out_dtype=bf)),
        "gemm_w8a8 two launches": (gemm_int8.gemm_w8a8, (x40, bi, sb), {}),
        "quantize_rows": (quant.quantize_rows, (x40,), {}),
        "flash_attention": (fa.flash_attention, (q, k, k), dict(window=8)),
        "flash_attention lse": (fa._forward, (q, k, k, True, None, True), {}),
        "flash_attention_bwd": (fa.flash_attention_bwd, (q, k, k, out, lse, out), {}),
        "flash_decode": (fd.paged_decode_attention, _paged(bf), dict(window=16)),
        "flash_decode_int8": (fd.paged_decode_attention, _paged(f32, True), {}),
    }


ROUTES = list(_route_cases())


@pytest.mark.parametrize("case", ROUTES)
def test_meta_route_matches_plain_shape_and_dtype(case):
    fn, args, kw = _route_cases()[case]
    want = fn(*args, **kw)
    seen = []
    with kcost.recording(lambda name, c: seen.append((name, c))):
        got = fn(*[_meta(x) for x in args], **kw)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got if t is not None] == \
        [(tuple(t.shape), t.dtype) for t in want if t is not None]
    assert all(t.device.type == "meta" for t in got if t is not None)
    assert seen and all(c.ops > 0 and c.nbytes > 0 for _, c in seen)


# -- the dry run and diagnose ------------------------------------------------------

FAMILIES = {"dense": "gemma3-1b", "moe": "dbrx-132b", "hybrid": "jamba-1.5-large-398b",
            "ssm": "xlstm-1.3b", "encdec": "whisper-medium", "vlm": "paligemma-3b"}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_cell_on_each_familys_smoke_config(family, monkeypatch):
    arch = FAMILIES[family]
    cfg = TC.get_smoke(arch)
    assert cfg.family == family or family == "dense"
    small = {"t": dict(kind="train", seq_len=32, global_batch=2),
             "p": dict(kind="prefill", seq_len=32, global_batch=2),
             "d": dict(kind="decode", seq_len=64, global_batch=2)}
    monkeypatch.setattr(TC, "SHAPES", {**TC.SHAPES, **small})
    for name, shape in small.items():
        row = dryrun.run_cell(arch, name, cfg=cfg, verbose=False)
        assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
        assert row["collective_s"] == 0.0 and row["step_time_s"] > 0
        assert row["fits"] and row["activation_peak_bytes"] > 0
        assert row["launches"].get("gemm", 0) > 0
        assert (row["opt_state_bytes"] > 0) == (shape["kind"] == "train")
        assert (row["decode_state_bytes"] > 0) == (shape["kind"] == "decode")
        assert row["useful_flops_ratio"] == pytest.approx(
            TR.model_flops(cfg, shape) / row["flops_per_device"])
    with pytest.raises(NotImplementedError, match="parallel"):
        dryrun.run_cell(arch, "t", "multi", cfg=cfg, verbose=False)


def test_dryrun_train_cell_counts_the_card_run_launches():
    """gemma3-1b at published widths, phase 14's step (B 4 x S 1024): the
    meta trace launches the plan chip_smoke.py's phase 14 checks on the
    card, and the resident bytes are weights + f32 moments."""
    cfg = TC.get("gemma3-1b")
    cost, held = dryrun.trace_cell(cfg, dict(kind="train", seq_len=1024, global_batch=4))
    assert cost.launches == {"gemm": 736, "flash_attention": 52, "flash_attention_bwd": 26}
    n = sum(t.numel() for t in tree_lib.leaves(TS.params_struct(cfg)))
    assert held["opt_state"] == 2 * 4 * n + 4
    assert 8e9 < cost.peak_live_bytes < 14e9


def test_attribute_names_the_train_steps_sources_on_a_cpu_profile():
    cfg = TC.get_smoke("gemma3-1b")
    step, params, opt, data = diagnose._train_inputs(cfg, "cpu", 2, 32)
    att = diagnose.attribute(diagnose.profile_step(step, params, opt, data))
    assert att.metric == "cpu_ms" and att.total > 0
    assert att.unattributed < 0.05
    names = " ".join(att.by_source)
    for frag in ("layers.py:rms_norm", "layers.py:apply_rope", "layers.py:mlp",
                 "model.py:loss_fn", "adamw.py:adamw_update", "backward of ",
                 "kernel:gemm", "kernel:flash_attention"):
        assert frag in names, frag


def test_attribute_of_a_card_profile_names_kernels_by_their_launch():
    """The device path on events shaped as a CUDA profile's: a kernel
    belongs to the label above the runtime call with its correlation id, a
    hand kernel to its name, and the annotation's own device range is no
    kernel."""
    from types import SimpleNamespace as E

    from torch.autograd import DeviceType

    def ev(name, dev, id_=0, parent=None, us=0.0):
        return E(name=name, device_type=dev, id=id_, cpu_parent=parent, is_async=False,
                 time_range=E(elapsed_us=lambda us=us: us))

    cpu = DeviceType.CPU
    label = ev(step_cost.LABEL + "models/layers.py:rms_norm", cpu)
    op = ev("aten::mul", cpu, parent=label)
    events = [label, op, ev("cudaLaunchKernel", cpu, 7, op),
              ev("cudaLaunchKernel", cpu, 8, None),
              ev("vectorized_elementwise_kernel", DeviceType.CUDA, 7, us=300.0),
              ev("gemm_kernel<64>", DeviceType.CUDA, 9, us=600.0),
              ev("reduce_kernel", DeviceType.CUDA, 8, us=100.0),
              ev(label.name, DeviceType.CUDA, 10, us=5000.0)]
    att = diagnose.attribute(events)
    assert att.metric == "device_ms" and att.kernels == 3
    assert att.by_source == {"models/layers.py:rms_norm": 0.3, "kernel:gemm": 0.6,
                             step_cost.UNATTRIBUTED: 0.1}
    assert att.unattributed == pytest.approx(0.1)


def test_attribute_of_a_step_cost_sums_to_its_bytes():
    cfg = TC.get_smoke("gemma3-1b")
    cost, _ = dryrun.trace_cell(cfg, dict(kind="train", seq_len=32, global_batch=2))
    att = diagnose.attribute(cost, 10)
    assert att.total == pytest.approx(cost.bytes_accessed)
    assert att.unattributed < 0.05 and len(att.rows) == 10
    assert any(k.startswith("backward of models/") for k in cost.flops_by_source)
    assert "kernel:flash_attention_bwd" in cost.flops_by_source


def test_roofline_terms_and_refusals():
    cfg = TC.get_smoke("qwen3-14b")
    cost = step_cost.StepCost(flops=989e12, bytes_accessed=3.35e12 / 2)
    r = TR.analyze(arch="x", shape_name="s", shape=dict(kind="prefill", seq_len=4,
                                                        global_batch=1), cfg=cfg, cost=cost,
                   measured_s=2.0)
    assert r.peak_flops == 67e12           # the smoke config is float32
    assert r.bound == "compute" and r.step_time_s == r.compute_s == 989 / 67
    assert r.memory_s == pytest.approx(0.5) and r.collective_s == 0.0
    assert r.measured_mfu == pytest.approx(TR.model_flops(cfg, dict(
        kind="prefill", seq_len=4, global_batch=1)) / (2.0 * 67e12))
    assert set(r.row()) >= {"compute_s", "memory_s", "collective_s", "bound",
                            "useful_flops_ratio", "mfu"}
    with pytest.raises(NotImplementedError):
        TR.analyze(arch="x", shape_name="s", shape=dict(kind="decode", seq_len=4,
                                                        global_batch=1), cfg=cfg, cost=cost,
                   chips=4)


# -- the cost functions against the bounds printed on the H100 ----------------------

# gemma3-1b's (name, K, N) of one layer and the tied head (chip_smoke.GEMM_SHAPES)
GEMMA_GEMMS = [("q", 1152, 1024), ("k", 1152, 256), ("v", 1152, 256), ("o", 1024, 1152),
               ("gate", 1152, 6912), ("up", 1152, 6912), ("down", 6912, 1152)]


def test_cost_functions_give_perf_mds_bounds():
    """PERF.md section 6 (chip_smoke.py phase 5, NVIDIA H100 80GB HBM3):
    K1 a decode step 0.602 ms, K5b a train step 0.445 ms, K5 with the lse
    a train step 0.356 ms; qwen3-14b's K1 a decode step 8.372 ms."""
    k1 = 26 * sum(kcost.gemm(8, K, N).bound_s for _, K, N in GEMMA_GEMMS) \
        + kcost.gemm(8, 1152, 262144).bound_s
    assert round(k1 * 1e3, 3) == 0.602
    B, S, Hq, Hkv, D = 4, 1024, 4, 1, 256
    bwd = fwd = 0.0
    for layers, window in ((4, None), (22, 512)):
        pairs = kcost.attention_pairs(S, S, True, window)
        bwd += layers * kcost.flash_attention_bwd(B, S, S, Hq, Hkv, D, pairs=pairs).bound_s
        fwd += 2 * layers * kcost.flash_attention(B, S, S, Hq, Hkv, D, pairs=pairs,
                                                  lse=True).bound_s
    assert round(bwd * 1e3, 3) == 0.445 and round(fwd * 1e3, 3) == 0.356
    qwen = [(5120, 5120), (5120, 1024), (5120, 1024), (5120, 5120), (5120, 17408),
            (5120, 17408), (17408, 5120)]
    k1q = 40 * sum(kcost.gemm(8, K, N).bound_s for K, N in qwen) \
        + kcost.gemm(8, 5120, 151936).bound_s
    assert round(k1q * 1e3, 3) == 8.372
    assert kcost.gemm(8, 1152, 262144).bound_by == "bytes"
    assert kcost.attention_pairs(4, 4) == 10 and kcost.attention_pairs(4, 4, True, 2) == 7
    assert kcost.attention_pairs(1, 1500, False) == 1500
    assert kcost.decode_work([10], 1, None) == (11, 11)
