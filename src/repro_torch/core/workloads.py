"""DNN workload extraction: models -> lists of GeMM calls (paper Sec. 4.3).

The paper benchmarks the energy/latency-dominant blocks of MobileNetV2,
ResNet18, ViT-B-16 and BERT-base: convolutions via im2col [21], attention,
MLP and FC layers.  This module reproduces those layer tables as
``(GemmShape, call_count)`` lists that the simulator consumes.

Batch sizes are chosen so the simulated total cycle counts land in the same
regime as the paper's Table 2 (the paper does not state its batch size; the
reported cycle counts imply batch ~512 for the CNNs/BERT-seq512 and ~1024 for
ViT — see EXPERIMENTS.md for the back-derivation).  Port of
repro/core/workloads.py.
"""

from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.dataflow import GemmShape

GemmCalls = List[Tuple[GemmShape, int]]  # (shape, number of identical calls)


def _out(hw: int, k: int, s: int, p: int) -> int:
    return (hw + 2 * p - k) // s + 1


def conv_gemm(
    batch: int, hw: int, cin: int, cout: int, k: int, s: int = 1, p: int | None = None
) -> Tuple[GemmShape, int]:
    """Standard conv as one im2col GeMM per image: M = OH*OW, K = k*k*Cin, N = Cout.

    Per-image calls (rather than one batched GeMM) match the paper's
    back-derived cycle counts and its reported spatial utilizations: M stays
    at the per-image spatial extent, so late CNN stages (e.g. ResNet18's
    7x7 = 49-row layer4) pad M to Mu multiples and pull SU below 1.
    """
    p = (k // 2) if p is None else p
    o = _out(hw, k, s, p)
    return GemmShape(o * o, k * k * cin, cout), batch


def depthwise_gemm(
    batch: int, hw: int, c: int, k: int = 3, s: int = 1, group: int = 8
) -> Tuple[GemmShape, int]:
    """Depthwise conv as grouped-channel im2col GeMMs.

    The paper attributes MobileNetV2's low SU/TU to depthwise layers ("tick
    channels", small K).  Its exact depthwise-to-GeMM mapping is not
    specified; a per-channel (OH*OW, 9, 1) mapping would give SU ~= 7% per
    layer (far below the reported model-level 87.36%), so we model the
    streamer batching `group`=Nu channels per call: timing-wise
    (M=OH*OW, K=k*k, N=group), which keeps the small-K TU penalty the paper
    describes while matching the overall SU regime.  See EXPERIMENTS.md.

    The channel loop is folded into a single accelerator call per (image,
    layer) through the strided-AGU hardware loops (Sec. 3.4): timing- and
    padding-wise this is a GeMM with M = OH*OW * ceil(C/group) channel-group
    rows, K = k*k, N = group -- small K is what drags TU down, exactly the
    effect the paper describes.
    """
    o = _out(hw, k, s, k // 2)
    return GemmShape(o * o * (-(-c // group)), k * k, group), batch


def linear_gemm(batch: int, tokens: int, din: int, dout: int) -> Tuple[GemmShape, int]:
    """One GeMM per sequence/image: M = tokens."""
    return GemmShape(tokens, din, dout), batch


def attention_gemms(batch: int, heads: int, seq: int, head_dim: int) -> GemmCalls:
    """Per-(image/sequence, head) score and AV GeMMs."""
    return [
        (GemmShape(seq, head_dim, seq), batch * heads),   # Q @ K^T
        (GemmShape(seq, seq, head_dim), batch * heads),   # P @ V
    ]


def transformer_encoder_gemms(
    batch: int, layers: int, seq: int, d_model: int, heads: int, d_ff: int
) -> GemmCalls:
    calls: GemmCalls = []
    for _ in range(layers):
        calls.append(linear_gemm(batch, seq, d_model, 3 * d_model))  # fused QKV
        calls.extend(attention_gemms(batch, heads, seq, d_model // heads))
        calls.append(linear_gemm(batch, seq, d_model, d_model))      # output proj
        calls.append(linear_gemm(batch, seq, d_model, d_ff))         # FFN up
        calls.append(linear_gemm(batch, seq, d_ff, d_model))         # FFN down
    return calls


# ---------------------------------------------------------------------------
# The paper's four benchmark models
# ---------------------------------------------------------------------------

def resnet18(batch: int = 256) -> GemmCalls:
    """ResNet18 @ 224x224 (conv layers via im2col + final FC)."""
    calls: GemmCalls = [conv_gemm(batch, 224, 3, 64, 7, s=2, p=3)]
    # (hw_in, cin, cout, stride, blocks)
    stages = [(56, 64, 64, 1, 2), (56, 64, 128, 2, 2), (28, 128, 256, 2, 2), (14, 256, 512, 2, 2)]
    for hw, cin, cout, s, blocks in stages:
        for b in range(blocks):
            s_b = s if b == 0 else 1
            cin_b = cin if b == 0 else cout
            hw_b = hw if b == 0 else hw // s
            calls.append(conv_gemm(batch, hw_b, cin_b, cout, 3, s=s_b))
            calls.append(conv_gemm(batch, hw_b // s_b, cout, cout, 3))
            if b == 0 and (s != 1 or cin != cout):
                calls.append(conv_gemm(batch, hw_b, cin_b, cout, 1, s=s_b, p=0))
    calls.append(linear_gemm(batch, 1, 512, 1000))
    return calls


# MobileNetV2 inverted-residual stage table: (expansion t, c_out, repeats, stride)
_MBV2_STAGES = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
]


def mobilenet_v2(batch: int = 512) -> GemmCalls:
    calls: GemmCalls = [conv_gemm(batch, 224, 3, 32, 3, s=2)]
    hw, cin = 112, 32
    for t, cout, n, s in _MBV2_STAGES:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            if t != 1:
                calls.append(conv_gemm(batch, hw, cin, hidden, 1, p=0))  # expand
            calls.append(depthwise_gemm(batch, hw, hidden, 3, s=stride))
            hw_out = hw // stride
            calls.append(conv_gemm(batch, hw_out, hidden, cout, 1, p=0))  # project
            hw, cin = hw_out, cout
    calls.append(conv_gemm(batch, 7, 320, 1280, 1, p=0))
    calls.append(linear_gemm(batch, 1, 1280, 1000))
    return calls


def vit_b_16(batch: int = 512) -> GemmCalls:
    """ViT-B/16 @ 224x224: 196 patches + cls = 197 tokens (odd M -> SU < 1)."""
    seq, d, layers, heads, d_ff = 197, 768, 12, 12, 3072
    calls: GemmCalls = [linear_gemm(batch, 196, 16 * 16 * 3, d)]  # patch embed
    calls.extend(transformer_encoder_gemms(batch, layers, seq, d, heads, d_ff))
    calls.append(linear_gemm(batch, 1, d, 1000))  # classification head (cls token)
    return calls


def bert_base(batch: int = 512, seq: int = 512) -> GemmCalls:
    d, layers, heads, d_ff = 768, 12, 12, 3072
    calls = transformer_encoder_gemms(batch, layers, seq, d, heads, d_ff)
    calls.append(linear_gemm(batch, 1, d, d))  # pooler (cls token)
    return calls


TABLE2_MODELS = {
    "MobileNetV2": mobilenet_v2,
    "ResNet18": resnet18,
    "ViT-B-16": vit_b_16,
    "BERT-Base": bert_base,
}

# Paper Table 2 reference values: (SU %, TU %, OU %, cycles).
TABLE2_PAPER = {
    "MobileNetV2": (87.36, 93.74, 81.89, 3.33e8),
    "ResNet18": (96.01, 99.72, 95.74, 9.29e8),
    "ViT-B-16": (98.41, 99.75, 98.16, 1.79e10),
    "BERT-Base": (99.54, 99.80, 99.34, 4.93e10),
}


def total_macs(calls: GemmCalls) -> int:
    return sum(g.macs * c for g, c in calls)
