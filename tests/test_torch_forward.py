"""The port's unpaged forward of gemma3-1b against the reference on the
smoke config (float32, the reference's `init_model(PRNGKey(0))` weights
carried over by the bridge): `forward` logits, one group of blocks, and
`blockwise_attention` on both of its routes (the flash-attention kernel's
plain version, and the blockwise softmax for softcap / q offset / prefix)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import blocks as rblocks
from repro.models import model as RM
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import model as TM

ARCH = "gemma3-1b"
TOL = dict(rtol=3e-4, atol=3e-4)      # slice 1's prefill bar (tests/test_serving.py)


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    rcfg, tcfg = rconfigs.get_smoke(ARCH), tconfigs.get_smoke(ARCH)
    rparams = RM.init_model(jax.random.PRNGKey(0), rcfg)
    tparams = bridge.params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), tcfg, "cpu")
    return rcfg, rparams, tcfg, tparams


def _tokens(vocab, B=2, S=32, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("last_only", [False, True])
def test_forward_matches_reference(models, last_only):
    """S = 32 > the smoke window of 8, so the local layers' window masks
    bite; logits for every position, or the last only."""
    rcfg, rparams, tcfg, tparams = models
    tokens = _tokens(rcfg.vocab)
    want = np.asarray(RM.forward(rparams, rcfg, {"tokens": jnp.asarray(tokens)},
                                 last_only=last_only))
    tfa.reset_launches()
    with torch.no_grad():
        got = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(tokens).long()},
                         last_only=last_only)
    assert tfa.launches == 0                       # CPU tensors: the plain version
    assert got.shape == want.shape == (2, 1 if last_only else 32, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("g", [0])
def test_apply_group_matches_reference(models, g):
    """One group of blocks over the sequence itself: the port's flat layers
    g * group_size .. + group_size - 1 against the reference's group slice."""
    rcfg, rparams, tcfg, tparams = models
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, rcfg.d_model)).astype(np.float32)
    gp = jax.tree_util.tree_map(lambda a: a[g], rparams["blocks"])
    want, _ = rblocks.apply_group(jnp.asarray(x), gp, rcfg, positions=jnp.arange(24))
    with torch.no_grad():
        got = tblocks.apply_group(torch.from_numpy(x), TM.group_layers(tparams, tcfg, g),
                                  tcfg, positions=torch.arange(24))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


ATTN_CASES = [  # (Sq, Skv, q_offset, window, prefix_len, softcap)
    (24, 24, 0, None, 0, None),    # the flash route
    (24, 24, 0, 8, 0, None),       # the flash route, windowed
    (24, 24, 0, None, 0, 30.0),    # softcap: blockwise route
    (8, 24, 16, 8, 0, None),       # q offset (a cached prefix): blockwise route
    (24, 24, 0, None, 5, None),    # bidirectional prefix: blockwise route
]


@pytest.mark.parametrize("Sq,Skv,q_offset,window,prefix_len,softcap", ATTN_CASES)
def test_blockwise_attention_matches_reference(Sq, Skv, q_offset, window, prefix_len,
                                               softcap):
    """Both routes of `blockwise_attention` against the reference's XLA
    blockwise path, with kv blocks of 10 keys (several, one ragged)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, Skv, 1, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, q_offset=q_offset, window=window, prefix_len=prefix_len,
              block_kv=10, softcap=softcap)
    want = np.asarray(rattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw))
    got = tattn.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unpaged_attention_rejects_a_dense_cache(models):
    """The dense decode cache is a `KVCache` (the unpaged decode path): a
    bare (k, v) pair is refused, naming its type, and a `KVCache` is
    written at the index and attended over."""
    _, _, tcfg, tparams = models
    x = torch.zeros((1, 2, tcfg.d_model))
    with pytest.raises(TypeError, match="tuple"):
        tattn.attention(x, tparams["layers"][0]["mixer"], tcfg, positions=torch.arange(2),
                        window=None, cache=(x, x))
    shape = (1, 4, tcfg.n_kv_heads, tcfg.resolved_head_dim)
    cache = tattn.KVCache(torch.zeros(shape), torch.zeros(shape))
    x = torch.ones((1, 2, tcfg.d_model))
    out = tattn.attention(x, tparams["layers"][0]["mixer"], tcfg, positions=torch.arange(2),
                          window=None, cache=cache, cache_index=torch.tensor(1))
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert float(cache.k[:, 1:3].abs().sum()) > 0
    assert float(cache.k[:, 0].abs().sum()) == float(cache.k[:, 3].abs().sum()) == 0
