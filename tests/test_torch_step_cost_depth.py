"""`step_cost.analyze` over a step whose autograd graph is deep: xlstm's
sLSTM runs one autograd node chain per token, so a train step's graph is
thousands of nodes deep.  A node that Python has touched (the counting
mode reads the running node and walks the forward graph to name sources)
frees the graph below it recursively, one C frame or more per node, and
xlstm-1.3b's whole train step at B 1 x S 1024 died of a C stack overflow
that way.  `Sources` now holds every node it touched and drops them parents
first after the step (`Sources.release`).

The reproducer shrinks the depth the overflow needs instead of growing the
graph: the trace runs in a child process whose stack is 256 KB, where xlstm
at smoke widths over one published 8-layer group (7 mLSTM + 1 sLSTM) at S
128 overflowed before the repair (signal 11 within 15 s) and is counted in
full after it; a plain chain of 20000 `sin` nodes the same."""

import os
import resource
import subprocess
import sys
import textwrap

import pytest

STACK_BYTES = 256 * 1024
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

XLSTM_GROUP = """
    import dataclasses, json
    from repro_torch import configs
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(configs.get("xlstm-1.3b"), n_layers=8, d_model=64, vocab=256)
    cost, _ = dryrun.trace_cell(cfg, dict(kind="train", seq_len=128, global_batch=1))
    print(json.dumps(cost.launches))
"""
SIN_CHAIN = """
    import json, torch
    from repro_torch.launch import step_cost
    def step(x):
        y = x
        for _ in range(20000):
            y = torch.sin(y)
        (g,) = torch.autograd.grad(y.sum(), [x])
        return g
    x = torch.ones(3, requires_grad=True)
    cost = step_cost.analyze(step, x)
    print(json.dumps({"counted": cost.bytes_accessed > 0}))
"""


def _small_stack():
    resource.setrlimit(resource.RLIMIT_STACK, (STACK_BYTES, resource.getrlimit(
        resource.RLIMIT_STACK)[1]))


@pytest.mark.parametrize("script, want", [
    (XLSTM_GROUP, '{"gemm": 224}'),       # 8 x 55 projections + 1 head chunk, x 4
    (SIN_CHAIN, '{"counted": true}'),
], ids=["xlstm_group", "sin_chain"])
def test_deep_graph_is_counted_on_a_small_stack(script, want):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], env=env,
                         preexec_fn=_small_stack, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    assert out.stdout.strip().splitlines()[-1] == want
