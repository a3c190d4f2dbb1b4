"""The port's Engine and serve CLI on the dense family's smoke configs
against the reference (float32, CPU): greedy tokens identical to the
reference Engine for qwen3-14b, qwen2.5-14b, mistral-nemo-12b, bert-base
and vit-b-16 in float, for qwen3-14b and bert-base also in w8a8 with an
int8 KV pool, and the serve CLI's tokens for `--arch qwen3-14b`.  The
weights are tests/test_torch_dense_archs.py's: the reference's, with
seeded biases and norm vectors, bridged."""

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import serve as rserve
from repro.models import model as RM
from repro.serving.engine import Engine as REngine
from repro.serving.request import RequestSpec as RSpec
from repro_torch import bridge, quant
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.request import RequestSpec as TSpec
from test_torch_dense_archs import build

# (arch, slots, max_chunk, block_size): one serving setting per arch.
SETTINGS = [("qwen3-14b", 2, 4, 4), ("qwen2.5-14b", 3, 8, 2),
            ("mistral-nemo-12b", 2, 4, 2), ("bert-base", 3, 4, 4), ("vit-b-16", 2, 8, 4)]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = build(arch)
        return cache[arch]
    return get


def _serve_both(models, *, slots, max_chunk, block_size, precision="float",
                kv_precision="float"):
    """Serve the same requests (more than the slots, unequal budgets, so
    slots refill) on the reference and the port Engine; return both."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(2)
    lens, gens = [5, 3, 7, 4, 9], [2, 5, 1, 3, 4]
    prompts = [rng.integers(0, rcfg.vocab, size=n).astype(np.int32) for n in lens]
    kw = dict(slots=slots, max_seq=24, block_size=block_size, max_chunk=max_chunk,
              precision=precision, kv_precision=kv_precision)
    reng = REngine(rcfg, params=rparams, **kw)
    reng.warmup()
    teng = TEngine(tcfg, tparams, device="cpu", **kw)
    teng.warmup()
    for p, g in zip(prompts, gens):
        reng.submit(RSpec(prompt=p, max_new=g))
        teng.submit(TSpec(prompt=p, max_new=g))
    want, got = reng.run(), teng.run()
    assert sorted(got) == sorted(want) == list(range(len(prompts)))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")
        assert len(got[rid]) == gens[rid]
    return reng, teng


@pytest.mark.parametrize("arch,slots,max_chunk,block_size", SETTINGS)
def test_engine_greedy_token_identical_to_reference(built, arch, slots, max_chunk,
                                                    block_size):
    reng, teng = _serve_both(built(arch), slots=slots, max_chunk=max_chunk,
                             block_size=block_size)
    m, rm = teng.metrics, reng.metrics
    assert m.cold_compiles == 0
    assert (m.prefill_chunks, m.decode_steps) == (rm.prefill_chunks, rm.decode_steps)
    assert m.kv_pool_bytes == rm.kv_pool_bytes
    assert teng.alloc.in_use == 0


@pytest.mark.parametrize("arch", ["qwen3-14b", "bert-base"])
def test_engine_w8a8_int8_kv_token_identical_to_reference(built, arch):
    """w8a8 weights (the untied head an ordinary quantized leaf, the biases
    and norm vectors float) with an int8 KV pool."""
    reng, teng = _serve_both(built(arch), slots=2, max_chunk=4, block_size=4,
                             precision="w8a8", kv_precision="int8")
    m, rm = teng.metrics, reng.metrics
    assert (m.weight_bytes, m.weight_bytes_float) == (rm.weight_bytes, rm.weight_bytes_float)
    assert m.kv_pool_bytes == rm.kv_pool_bytes
    assert "head_q" not in teng.params and isinstance(teng.params["head"], quant.QuantTensor)
    per_layer = 4 + (3 if teng.cfg.mlp_variant == "swiglu" else 2)
    assert quant.quantized_leaf_count(teng.params) == per_layer * teng.cfg.n_layers + 1
    assert quant.get_mode() == "float"


def test_serve_cli_tokens_match_reference(capsys):
    """`--arch qwen3-14b`: the port's CLI on the CPU prints the reference
    CLI's tokens for the same argv and the reference CLI's own weights."""
    arch = "qwen3-14b"
    rparams = RM.init_model(jax.random.PRNGKey(0), rconfigs.get_smoke(arch))
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tconfigs.get_smoke(arch), "cpu")
    argv = ["--arch", arch, "--requests", "3", "--prompt-len", "6",
            "--gen-len", "3", "--chunk", "4", "--block-size", "4"]
    want = rserve.main(argv)
    got = tserve.main(argv + ["--device", "cpu"], params=tparams)
    np.testing.assert_array_equal(got, want)
    assert f"arch={arch}" in capsys.readouterr().out
