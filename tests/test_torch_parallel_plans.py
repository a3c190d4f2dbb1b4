"""The port's parallel plans against the reference's, spec for spec:
`resolve_spec` on the reference's cases and more; `make_plan`,
`param_sharding`, `batch_sharding` and `cache_sharding` for all twelve
archs' published configs over the meshes (4, 2), (16, 16) and (2, 16, 16),
in dp and tp mode, with and without serving, and the plan variants the
dry run and the train CLI ask for.

The reference runs in a subprocess with 512 fake CPU devices
(`XLA_FLAGS=--xla_force_host_platform_device_count=512`, as
`tests/test_sharding.py` runs its mini dry run); its plans go over the
reference's `params_struct` / `decode_state_struct` / `input_specs`
(`jax.eval_shape`, nothing allocated), the port's over its meta-device
structs.  A leaf of the port's flat "layers" list (layer g * group_size +
i) is held against the reference's stacked `blocks/sub{i}` leaf without
its leading None, an "encoder_blocks" leaf likewise, a decode-state leaf
of layer j against the reference's stacked leaf of group position j %
group_size without its leading group axis."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
from jax.sharding import PartitionSpec as P

from repro.parallel import logical as RL
from repro_torch import configs as TC
from repro_torch import tree as tree_lib
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import MeshShape, production_mesh_shape
from repro_torch.parallel import logical as TL
from repro_torch.parallel import sharding as TSH

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = [(("data", "model"), (4, 2)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
# Plan variants: make_plan's keywords (n_kv_heads always passed, as the
# reference's dry run passes it).
VARIANTS = {
    "train": {}, "prefill": {"serving": True},
    "decode": {"serving": True, "force_attn_seq": False},
    "dp": {"force_mode": "dp"}, "dp_cli": {"force_fsdp": False},
    "dp_serving": {"force_mode": "dp", "serving": True},
    "tp": {"force_mode": "tp"}, "tp_fsdp": {"force_mode": "tp", "force_fsdp": True},
    "tp_attn_seq": {"force_mode": "tp", "force_attn_seq": True},
    "tp_serving": {"force_mode": "tp", "serving": True},
}
BATCHES = [256, 32, 8, 6, 1]          # global batch sizes of the batch specs
DECODE = [(128, 64), (1, 64)]         # (batch, max_seq) of the decode states

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, math, sys
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro import configs
    from repro.launch import steps
    from repro.parallel import sharding as S

    meshes, variants, batches, decode = (json.loads(a) for a in sys.argv[1:5])
    devs = np.array(jax.devices())

    def spec(ns):
        return [list(e) if isinstance(e, tuple) else e for e in ns.spec]

    def path(p):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                        for k in p)

    def flat(tree):
        return [[path(p), spec(x)] for p, x in
                jax.tree_util.tree_flatten_with_path(tree)[0]]

    out = {}
    for arch in configs.list_archs():
        cfg = configs.get(arch)
        params = steps.params_struct(cfg)
        states = [steps.decode_state_struct(cfg, params, b, s) for b, s in decode]
        inputs = {b: steps.input_specs(cfg, dict(kind="train", seq_len=16, global_batch=b))
                  for b in batches}
        for names, sizes in meshes:
            mesh = Mesh(devs[:math.prod(sizes)].reshape(sizes), tuple(names))
            for label, kw in variants.items():
                plan = S.make_plan(mesh, cfg.param_count(), n_kv_heads=cfg.n_kv_heads, **kw)
                out[f"{arch}|{sizes}|{label}"] = {
                    "plan": [list(plan.batch_axes), plan.model_axis, plan.fsdp,
                             list(plan.fsdp_axes), plan.attn_seq, plan.expert_2d],
                    "rules": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in plan.activation_rules().items()},
                    "params": flat(S.param_sharding(params, mesh, plan)),
                    "batch": {str(b): flat(S.batch_sharding(inputs[b]["batch"], mesh, plan))
                              for b in batches},
                    "cache": [[flat(S.cache_sharding(st.caches, mesh, plan)),
                               flat(S.cache_sharding(st.cross_caches, mesh, plan))
                               if st.cross_caches is not None else None,
                               flat(S.cache_sharding(st.index, mesh, plan))]
                              for st in states],
                }
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", REFERENCE] + [json.dumps(x) for x in
                                             (MESHES, VARIANTS, BATCHES, DECODE)],
        env=env, capture_output=True, text=True, timeout=280)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _js(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _port_param_specs(cfg, shardings):
    """{reference path: [port specs]}: each port leaf under the reference
    leaf it is a slice of, with a leading None for the stacked axis."""
    out = {}
    for path, ns in tree_lib.leaves_with_paths(shardings):
        spec = _js(ns.spec)
        if path[0] == "layers":
            path, spec = ("blocks", f"sub{path[1] % cfg.group_size}") + path[2:], [None] + spec
        elif path[0] == "encoder_blocks":
            path, spec = ("encoder_blocks",) + path[2:], [None] + spec
        out.setdefault("/".join(map(str, path)), []).append(spec)
    return out


def _flat(shardings):
    return [_js(ns.spec) for ns in tree_lib.leaves(shardings)]


@pytest.mark.parametrize("arch", TC.list_archs())
def test_plans_and_specs_match_reference(reference, arch):
    cfg = TC.get(arch)
    params = TS.params_struct(cfg)
    states = [TS.decode_state_struct(cfg, params, b, s) for b, s in DECODE]
    inputs = {b: TS.input_specs(cfg, dict(kind="train", seq_len=16, global_batch=b))
              for b in BATCHES}
    checked = 0
    for names, sizes in MESHES:
        mesh = MeshShape(names, sizes)
        for label, kw in VARIANTS.items():
            want = reference[f"{arch}|{list(sizes)}|{label}"]
            plan = TSH.make_plan(mesh, cfg.param_count(), n_kv_heads=cfg.n_kv_heads, **kw)
            key = (arch, sizes, label)
            assert [list(plan.batch_axes), plan.model_axis, plan.fsdp, list(plan.fsdp_axes),
                    plan.attn_seq, plan.expert_2d] == want["plan"], key
            assert {k: list(v) if isinstance(v, tuple) else v
                    for k, v in plan.activation_rules().items()} == want["rules"], key
            got = _port_param_specs(cfg, TSH.param_sharding(params, mesh, plan))
            ref = dict(want["params"])
            assert got.keys() == ref.keys(), key
            for p, specs in got.items():
                assert all(s == ref[p] for s in specs), (key, p, specs[0], ref[p])
                checked += len(specs)
            for b in BATCHES:
                assert _flat(TSH.batch_sharding(inputs[b]["batch"], mesh, plan)) == \
                    [s for _, s in want["batch"][str(b)]], (key, b)
            for st, (caches, cross, index) in zip(states, want["cache"]):
                _check_caches(cfg, TSH.cache_sharding(st, mesh, plan), caches, cross, index,
                              key)
    assert checked == 3 * len(VARIANTS) * len(tree_lib.leaves(params))


def _check_caches(cfg, got, caches, cross, index, key):
    """The port's per-layer decode-state specs against the reference's
    stacked ones (leading group axis None), layer j against group
    position j % group_size; the index replicated in both."""
    ref_self = _group_leaves(caches, cfg.group_size)
    for j, layer in enumerate(got.caches):
        want = ref_self[j % cfg.group_size]
        assert [[None] + s for s in _flat(layer)] == want, (key, j)
    if cross is not None:
        ref_cross = _group_leaves(cross, cfg.group_size)
        for j, layer in enumerate(got.cross_caches):
            assert [[None] + s for s in _flat(layer)] == ref_cross[j % cfg.group_size], key
    else:
        assert got.cross_caches is None
    assert [s for _, s in index] == [_js(got.index.spec)] == [[]], key


def _group_leaves(flat, group_size):
    """The reference's stacked cache leaves by group position (the first
    path element)."""
    out = [[] for _ in range(group_size)]
    for p, s in flat:
        out[int(p.split("/")[0])].append(s)
    return out


# -- resolve_spec and shard -------------------------------------------------------

RESOLVE_CASES = [
    ({"batch": ("pod", "data"), "heads": "model", "embed": None}, ["batch", None, "heads"]),
    ({"batch": ("pod", "data"), "heads": "model", "embed": None}, ["embed"]),
    ({"batch": "data", "seq": "data"}, ["batch", "seq"]),
    ({"batch": ("data", "model"), "heads": "model"}, ["batch", "heads"]),
    ({"batch": ("data", "model"), "heads": "model"}, ["heads", "batch"]),
    ({"batch": ("data",), "mlp": "model"}, ["batch", "mlp", "mlp"]),
    ({"batch": ("pod", "data"), "seq": ("data", "model"), "vocab": "model"},
     ["batch", "seq", "vocab"]),
    ({"a": ("x", "y"), "b": ("y", "x")}, ["a", "b", "unknown", None]),
    ({}, []),
]


@pytest.mark.parametrize("rules,names", RESOLVE_CASES, ids=str)
def test_resolve_spec_matches_reference(rules, names):
    got = TL.resolve_spec(names, rules)
    want = RL.resolve_spec(names, rules)
    assert isinstance(got, tuple) and tuple(got) == tuple(want)
    assert got == TL.Spec(*want)


def test_resolve_spec_reference_cases():
    """tests/test_sharding.py's three cases, on the port."""
    rules = {"batch": ("pod", "data"), "heads": "model", "embed": None}
    assert TL.resolve_spec(["batch", None, "heads"], rules) == \
        TL.Spec(("pod", "data"), None, "model") == tuple(P(("pod", "data"), None, "model"))
    assert TL.resolve_spec(["embed"], rules) == TL.Spec(None)
    assert TL.resolve_spec(["batch", "seq"], {"batch": "data", "seq": "data"}) == \
        TL.Spec("data", None)
    assert TL.resolve_spec(["batch", "heads"], {"batch": ("data", "model"),
                                                "heads": "model"}) == \
        TL.Spec(("data", "model"), None)


def test_shard_is_the_identity_but_for_experts():
    """`shard` is the identity under dp and head-parallel rules (heads,
    kv_heads, mlp and vocab on the model axis) and under the sequence rules
    (attn_seq: seq and attn_seq on a model axis > 1); experts on an axis > 1
    raise, naming A.4c."""
    import torch

    x = torch.zeros(4, 8, 16)
    assert TL.shard(x, "batch", "seq", "embed") is x        # no rules
    mesh = MeshShape(("data", "model"), (4, 1))
    plan = TSH.make_plan(mesh, 10**12, force_mode="tp")      # a model axis of size 1
    with TL.use_rules(mesh, plan.activation_rules()):
        assert TL.shard(x, "batch", "seq", "heads") is x
        with pytest.raises(ValueError, match="names"):
            TL.shard(x, "batch", "seq")
    dp = TSH.make_plan(MeshShape(("data", "model"), (2, 2)), 10**9)
    assert dp.model_axis is None
    with TL.use_rules(MeshShape(("data", "model"), (2, 2)), dp.activation_rules()):
        assert TL.shard(x, "batch", "seq", "mlp") is x
    tp_mesh = MeshShape(("data", "model"), (2, 2))
    tp = TSH.make_plan(tp_mesh, 10**12)
    with TL.use_rules(tp_mesh, tp.activation_rules()):
        assert TL.shard(x, "batch", "seq", "embed") is x
        for names in (("batch", "seq", "heads"), ("batch", "seq", "kv_heads"),
                      ("batch", "seq", "mlp"), ("batch", "seq", "vocab")):
            assert TL.shard(x, *names) is x
        with pytest.raises(NotImplementedError, match="A.4c"):
            TL.shard(x, "expert", None, None)
    seq = TSH.make_plan(MeshShape(("data", "model"), (1, 4)), 10**12, n_kv_heads=2)
    assert seq.attn_seq
    with TL.use_rules(MeshShape(("data", "model"), (1, 4)), seq.activation_rules()):
        assert TL.shard(x, "batch", None, "heads") is x
        for names in (("batch", "seq", "embed"), ("batch", "attn_seq", "heads"),
                      ("batch", "seq", "mlp")):
            assert TL.shard(x, *names) is x
        with pytest.raises(NotImplementedError, match="A.4c"):
            TL.shard(x, "expert", None, None)
    assert TL.sharding_for(tp_mesh, tp.activation_rules(), "batch", "mlp").spec == \
        TL.Spec("data", "model")


def test_mesh_shapes():
    assert production_mesh_shape().shape == {"data": 16, "model": 16}
    assert production_mesh_shape(True).shape == {"pod": 2, "data": 16, "model": 16}
    m = MeshShape(("pod", "data", "model"), (2, 3, 4))
    assert m.size == 24
    assert [m.coordinate(r) for r in (0, 5, 23)] == [
        {"pod": 0, "data": 0, "model": 0}, {"pod": 0, "data": 1, "model": 1},
        {"pod": 1, "data": 2, "model": 3}]
    assert MeshShape.of(m) is m
    with pytest.raises(ValueError):
        MeshShape(("data",), (1, 2))
