"""The least time an H100 could take for a piece of work, from its shapes.

A frozen copy of the port's kernel cost functions (``bound_terms``,
``attention_cost``, ``mixffn_cost``, ``fused_block_cost``) and of their
peaks: the H100 SXM data sheet's dense rates at its 700 W limit. The
benchmark keeps its own copy so that a change to the program cannot move
the yardstick; ``tests/test_h100bench_yardstick.py`` records that the two
agreed when the copy was made.

``mit_block_cost`` is the work of one whole MiT block (LN1, the spatial
reduction, attention, LN2, MixFFN and both skips) with its input read once,
its output written once and its weights read once, whatever implements it:
a kernel that fuses more of the block cannot beat this bound.
"""

from __future__ import annotations

PEAK_TC = 989e12  # bf16 tensor-core FLOP/s
PEAK_HBM = 3.35e12  # HBM bytes/s
PEAK_F32 = 67e12  # f32 CUDA-core FLOP/s


def bound_terms(tc_flops: float, hbm_bytes: float, f32_flops: float) -> dict[str, float]:
    """The two bounding times in ms: "bytes" and "operations"."""
    return {"bytes": hbm_bytes / PEAK_HBM * 1e3,
            "operations": max(tc_flops / PEAK_TC, f32_flops / PEAK_F32) * 1e3}


def attention_cost(b, n, m, c, heads, itemsize=2, residual=False):
    """(tensor-core FLOPs, bytes, CUDA-core FLOPs) of the SR-attention
    sub-block: q, kv and out projections, logits and P.V; softmax ~5 ops a
    logit."""
    tc = 2 * b * n * c * c * 2 + 2 * b * m * c * 2 * c + 2 * 2 * b * n * m * c
    tensors = b * n * c * (2 + residual) + b * m * c + 4 * c * c + 4 * c
    return tc, tensors * itemsize, 5 * b * heads * n * m


def mixffn_cost(b, h, w, c, itemsize=2):
    """fc1 + fc2 on the tensor cores; 3x3 taps and GELU (~10 ops) on the 4C
    hidden map on the CUDA cores; x and out once, the weights once."""
    t = b * h * w
    weights = 2 * 4 * c * c + 4 * c * (1 + 9 + 1) + c
    return 2 * 2 * t * c * 4 * c, (2 * t * c + weights) * itemsize, t * 4 * c * (2 * 9 + 10)


def fused_block_cost(b, hw, m, c, heads, itemsize=2):
    """The MiT block after LN1: the attention sub-block, LN2, the MixFFN and
    both skips; its inputs are ln1(x), kv_in and x, its output the block's."""
    tc_a, bytes_a, f32_a = attention_cost(b, hw * hw, m, c, heads, itemsize, residual=True)
    tc_f, bytes_f, f32_f = mixffn_cost(b, hw, hw, c, itemsize)
    io_f = 2 * b * hw * hw * c * itemsize  # the FFN's x and out stay on chip
    return tc_a + tc_f, bytes_a + bytes_f - io_f, f32_a + f32_f + 10 * b * hw * hw * c


def mit_block_cost(b, hw, c, heads, sr, itemsize=2):
    """One whole MiT block on a (b, hw, hw, c) map with spatial reduction
    ``sr``: the attention and MixFFN products and the sr x sr reduction conv
    on the tensor cores; softmax, the 3x3 taps, GELU, the three LayerNorms
    (~8 ops an element) and the skips on the CUDA cores. Bytes: the block's
    input and output once, every weight once."""
    n = hw * hw
    m = (hw // sr) ** 2
    tc_a, _, f32_a = attention_cost(b, n, m, c, heads, itemsize)
    tc_f, _, f32_f = mixffn_cost(b, hw, hw, c, itemsize)
    tc_sr = 2 * b * m * c * c * sr * sr if sr > 1 else 0
    weights = (4 * c * c + 4 * c) + (2 * 4 * c * c + 4 * c * 11 + c) + 4 * c
    if sr > 1:
        weights += c * c * sr * sr + 3 * c
    bytes_ = (2 * b * n * c + weights) * itemsize
    f32 = f32_a + f32_f + 8 * b * (2 * n + m) * c + 2 * b * n * c
    return tc_a + tc_f + tc_sr, bytes_, f32


def least_ms(cost) -> float:
    """The least time of one piece of work, ms: the larger bound."""
    return max(bound_terms(*cost).values())
