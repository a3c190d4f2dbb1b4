"""The port's `core/` (repro_torch.core) against the reference's `repro.core`:
the same numbers on the same inputs, exactly.  The inputs are those of
test_dataflow.py, test_dataflow_properties.py, test_simulator.py,
test_simulator_properties.py and test_workloads.py, the paper's four DNNs'
workloads, the Fig. 5 medians, the Gemmini model, and GemmShapes drawn by
hypothesis as the reference's property tests draw them.  Also the H100's
peaks, held once in core/hw.py, and `OpenGeMMConfig.launch_spec`."""

import ast
import dataclasses
import pathlib

import pytest
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro_torch.core as T
from repro.core import dataflow as Rdf, gemmini_model as Rgm, simulator as Rsim
from repro.core import workloads as Rwl
from repro_torch.core import dataflow as Tdf, gemmini_model as Tgm, hw
from repro_torch.core import simulator as Tsim, workloads as Twl

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPES = [(1, 1, 1), (8, 8, 8), (7, 9, 5), (64, 8, 200), (197, 768, 512), (512, 512, 512)]
ARRAYS = [(8, 8, 8), (1, 4, 16), (16, 2, 8)]
GRID = [(8, 8, 8), (8, 256, 16), (64, 64, 64), (120, 48, 200), (256, 8, 256)]
ORDERS = [Rdf.OUTPUT_STATIONARY, Rdf.WEIGHT_STATIONARY, ("n1", "m1", "k1")]


def _t(x):
    """A dataclass (of either package) as plain tuples, for comparison."""
    return dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x


def _spatial(pkg, mkn, arr):
    df = pkg.Dataflow(spatial=pkg.SpatialUnrolling(*arr))
    g = pkg.GemmShape(*mkn)
    compute = df.compute_cycles(g)
    return (df.spatial_utilization(g), _t(df.spatial.padded_shape(g)),
            df.spatial.tile_counts(g), compute, df.output_tiles(g),
            df.temporal_utilization(compute, compute + 137),
            df.overall_utilization(g, compute + 137), g.macs, g.flops, g.operand_bytes(),
            g.operand_bytes(16, 16, 32), df.spatial.peak_ops_per_cycle)


def test_all_is_the_references_but_the_tpu_spec():
    assert set(T.__all__) == set(R.__all__) - {"TpuGemmSpec"}
    assert not hasattr(T, "TpuGemmSpec")
    assert not hasattr(T.generator, "MXU_LANES") and not hasattr(T.generator, "tpu_kernel_spec")


@pytest.mark.parametrize("mkn", SHAPES)
@pytest.mark.parametrize("arr", ARRAYS)
def test_spatial_tiling_equal(mkn, arr):
    assert _spatial(Tdf, mkn, arr) == _spatial(Rdf, mkn, arr)


@pytest.mark.parametrize("counts", [(1, 1, 1), (2, 3, 2), (4, 1, 5), (3, 3, 3)])
@pytest.mark.parametrize("order", ORDERS)
def test_temporal_iterate_equal(counts, order):
    t, r = Tdf.TemporalUnrolling(tuple(order)), Rdf.TemporalUnrolling(tuple(order))
    assert list(t.iterate(counts)) == list(r.iterate(counts))
    assert (t.is_output_stationary, t.is_weight_stationary) == (
        r.is_output_stationary, r.is_weight_stationary)


@pytest.mark.parametrize("mkn", SHAPES)
def test_loop_order_and_roofline_terms_equal(mkn):
    def terms(pkg):
        g = pkg.GemmShape(*mkn)
        return (pkg.choose_loop_order(g, pkg.SpatialUnrolling()).order,
                pkg.roofline_time_s(g, peak_flops=1e12, mem_bw=1e11),
                pkg.roofline_time_s(g, peak_flops=2e12, mem_bw=2e11, p_a=16, p_b=16),
                pkg.arithmetic_intensity(g))
    assert terms(Tdf) == terms(Rdf)


@pytest.mark.parametrize("mkn", GRID + [(7, 9, 13), (100, 100, 100)])
@pytest.mark.parametrize("reps", [1, 3])
def test_simulated_calls_equal(mkn, reps):
    got = Tsim.OpenGeMMSimulator().simulate_sequence([T.GemmShape(*mkn)] * reps)
    want = Rsim.OpenGeMMSimulator().simulate_sequence([R.GemmShape(*mkn)] * reps)
    assert [_t(t) for t in got] == [_t(t) for t in want]
    assert [(t.temporal_utilization, t.spatial_utilization, t.overall_utilization)
            for t in got] == [(t.temporal_utilization, t.spatial_utilization,
                               t.overall_utilization) for t in want]


@pytest.mark.parametrize("mkn", GRID)
def test_ablation_utilizations_equal(mkn):
    got = {k: Tsim.OpenGeMMSimulator(c).utilization(T.GemmShape(*mkn), repeats=10)
           for k, c in Tsim.ablation_architectures().items()}
    want = {k: Rsim.OpenGeMMSimulator(c).utilization(R.GemmShape(*mkn), repeats=10)
            for k, c in Rsim.ablation_architectures().items()}
    assert got == want
    assert {k: _t(c) for k, c in Tsim.ablation_architectures().items()} == {
        k: _t(c) for k, c in Rsim.ablation_architectures().items()}


def test_reports_equal():
    shapes = [(64, 128, 64)] * 7 + [(128, 64, 256)] * 3 + [(7, 9, 13), (120, 48, 200)]
    t, r = Tsim.OpenGeMMSimulator(), Rsim.OpenGeMMSimulator()
    assert _t(t.report([T.GemmShape(*s) for s in shapes])) == _t(
        r.report([R.GemmShape(*s) for s in shapes]))
    groups = [((64, 128, 64), 7), ((128, 64, 256), 3)]
    got = t.report_grouped([(T.GemmShape(*s), n) for s, n in groups])
    want = r.report_grouped([(R.GemmShape(*s), n) for s, n in groups])
    assert _t(got) == _t(want) and got.gops() == want.gops()
    pairs = [(T.GemmShape(*s), 1000 + 7 * i) for i, s in enumerate(shapes)]
    rpairs = [(R.GemmShape(*s), 1000 + 7 * i) for i, s in enumerate(shapes)]
    assert T.aggregate_utilization(T.Dataflow(), pairs) == R.aggregate_utilization(
        R.Dataflow(), rpairs)


def test_config_and_fig5_medians_equal():
    assert T.OpenGeMMConfig().peak_gops() == R.OpenGeMMConfig().peak_gops() == pytest.approx(204.8)
    c, r = T.CASE_STUDY, R.CASE_STUDY
    assert _t(c) == _t(r)
    for attr in ("peak_macs_per_cycle", "a_tile_bits", "b_tile_bits", "c_tile_bits",
                 "read_bw_bits", "write_bw_bits", "input_fetch_cycles",
                 "output_write_cycles", "spm_bytes"):
        assert getattr(c, attr) == getattr(r, attr), attr
    assert [_t(s) for s in T.random_fig5_shapes(200, seed=1)] == [
        _t(s) for s in R.random_fig5_shapes(200, seed=1)]
    assert T.fig5_median_utilizations(T.random_fig5_shapes(200, seed=1)) == \
        R.fig5_median_utilizations(R.random_fig5_shapes(200, seed=1))


@pytest.mark.parametrize("name", list(Rwl.TABLE2_MODELS))
def test_table2_workloads_and_reports_equal(name):
    got, want = Twl.TABLE2_MODELS[name](), Rwl.TABLE2_MODELS[name]()
    assert [(_t(g), n) for g, n in got] == [(_t(g), n) for g, n in want]
    assert Twl.total_macs(got) == Rwl.total_macs(want)
    assert _t(Tsim.OpenGeMMSimulator().report_grouped(got)) == _t(
        Rsim.OpenGeMMSimulator().report_grouped(want))
    assert Twl.TABLE2_PAPER[name] == Rwl.TABLE2_PAPER[name]


def test_workload_builders_equal():
    for fn in ("resnet18", "mobilenet_v2", "vit_b_16", "bert_base"):
        assert Twl.total_macs(getattr(Twl, fn)(batch=1)) == Rwl.total_macs(
            getattr(Rwl, fn)(batch=1)), fn
    for args in ((4, 56, 96, 3, 1, 8), (2, 112, 32, 3, 2, 8)):
        g, n = Twl.depthwise_gemm(*args)
        rg, rn = Rwl.depthwise_gemm(*args)
        assert (_t(g), n) == (_t(rg), rn)
    assert [(_t(g), n) for g, n in Twl.attention_gemms(2, 12, 197, 64)] == [
        (_t(g), n) for g, n in Rwl.attention_gemms(2, 12, 197, 64)]
    assert _t(Twl.conv_gemm(3, 224, 3, 64, 7, s=2, p=3)[0]) == _t(
        Rwl.conv_gemm(3, 224, 3, 64, 7, s=2, p=3)[0])


@pytest.mark.parametrize("weight_stationary", [True, False])
def test_gemmini_model_equal(weight_stationary):
    t = Tgm.GemminiModel(Tgm.GemminiConfig(weight_stationary=weight_stationary))
    r = Rgm.GemminiModel(Rgm.GemminiConfig(weight_stationary=weight_stationary))
    for s in (8, 16, 32, 64, 128):
        g, rg = T.GemmShape(s, s, s), R.GemmShape(s, s, s)
        assert (t.cycles(g), t.hardware_cycles(g), t.temporal_utilization(g), t.gops(g),
                t.gops_per_mm2(g)) == (r.cycles(rg), r.hardware_cycles(rg),
                                       r.temporal_utilization(rg), r.gops(rg),
                                       r.gops_per_mm2(rg))
    assert t.cfg.peak_gops == r.cfg.peak_gops


dims = st.integers(min_value=1, max_value=512)
arr = st.sampled_from([1, 2, 4, 8, 16])
dim8 = st.integers(1, 32).map(lambda i: 8 * i)


@given(M=dims, K=dims, N=dims, Mu=arr, Ku=arr, Nu=arr)
@settings(max_examples=100, deadline=None)
def test_random_shapes_tile_equal(M, K, N, Mu, Ku, Nu):
    assert _spatial(Tdf, (M, K, N), (Mu, Ku, Nu)) == _spatial(Rdf, (M, K, N), (Mu, Ku, Nu))


@given(M=dim8, K=dim8, N=dim8, reps=st.integers(1, 12))
@settings(max_examples=30, deadline=None)
def test_random_shapes_simulate_equal(M, K, N, reps):
    got = Tsim.OpenGeMMSimulator().simulate_sequence([T.GemmShape(M, K, N)] * reps)
    want = Rsim.OpenGeMMSimulator().simulate_sequence([R.GemmShape(M, K, N)] * reps)
    assert [_t(t) for t in got] == [_t(t) for t in want]


@pytest.mark.parametrize("d_stream", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("mkn", [None, (8, 1152, 6912), (64, 64, 128), (1, 100, 256),
                                 (8, 6912, 1152)])
def test_launch_spec_depth_is_k6s_clamp(d_stream, mkn):
    from repro_torch.kernels import gemm, gemm_pipelined

    cfg = T.OpenGeMMConfig(D_stream=d_stream, P_A=16, P_B=16)
    if mkn is None:
        spec = cfg.launch_spec()
        k_steps = gemm_pipelined.MAX_DEPTH
        assert spec.splits == 1
    else:
        M, K, N = mkn
        spec = cfg.launch_spec(T.GemmShape(M, K, N))
        plan = gemm.gemm_plan(M, N, K, False, hw.H100_SMS, 2)
        k_steps = -(-K // plan.bk)
        assert (spec.splits, spec.swap) == (plan.splits, plan.swap)
    want = gemm_pipelined.clamp_depth(min(d_stream, gemm_pipelined.MAX_DEPTH), k_steps)
    assert spec.depth == want and 2 <= spec.depth <= gemm_pipelined.MAX_DEPTH


PEAKS = {3.35e12, 989e12, 1979e12, 67e12, 1.98e9}


def _peak_literals(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, float) and n.value in PEAKS]


def test_h100_peaks_held_once():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    where = {str(f.relative_to(ROOT)): _peak_literals(f) for f in files}
    hw_file = "src/repro_torch/core/hw.py"
    assert sorted(where.pop(hw_file)) == sorted(PEAKS)
    assert not {f: v for f, v in where.items() if v}
    from repro_torch.obs import mfu
    from repro_torch.tuning import candidates, model as tmodel
    assert (tmodel.HBM_BW, tmodel.PEAK_OPS, tmodel.CLOCK_HZ) == (hw.HBM_BW, hw.PEAK_OPS,
                                                                  hw.CLOCK_HZ)
    assert (mfu.PEAK_FLOPS_BF16, mfu.HBM_BW, candidates.H100_SMS) == (
        hw.PEAK_OPS[16], hw.HBM_BW, 132)
    assert hw.peak_ops("bfloat16") == hw.peak_ops("torch.bfloat16") == 989e12
