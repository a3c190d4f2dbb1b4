"""The port's training path against the reference on the CPU, float32, for
the encoder-decoder (whisper-medium: the encoder over stub frames, the
decoder's cross-attention) and VLM (paligemma-3b: projected patches as a
bidirectional prefix) families: the loss, every gradient leaf and one
`make_train_step` step against the reference, with the bars of
tests/test_torch_train_families.py (which holds the other families)."""

import pytest
import torch

from test_torch_train import _models, check_train_step
from test_torch_train_families import (FLOOR_OF_TREE, check_gradients, check_loss,
                                       family_batch, reference_case)

ARCHS = ("whisper-medium", "paligemma-3b")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return reference_case(request.param)


def test_loss_matches_reference(case):
    check_loss(case)


def test_every_gradient_leaf_matches_reference(case):
    check_gradients(case)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    rcfg, rparams, tcfg, _ = _models(arch)
    check_train_step(rcfg, rparams, tcfg, family_batch(tcfg, seed=4), FLOOR_OF_TREE)
