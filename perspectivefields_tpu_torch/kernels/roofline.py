"""The least time an H100 could take for each kernel's work, from its shapes.

A kernel's bound is the larger of two times: the bytes it must move (each
input read once, each output written once) over the HBM rate, and the
operations it does over their unit's peak (tensor-core products at the bf16
rate, the rest on the f32 CUDA cores). Peaks are the H100 SXM's published
dense rates at its 700 W limit. ``chip_smoke.py`` puts these bounds beside
its measured times; ``python -m perspectivefields_tpu_torch.kernels.roofline``
prints them for all six TPU kernels at the flagship shapes.
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


def convnext_block_cost(b, h, w, c, itemsize=2):
    """pwconv1 + pwconv2 on the tensor cores; 7x7 taps, LayerNorm (~8),
    GELU (~10 on 4C), layer scale and residual (3) on the CUDA cores."""
    t = b * h * w
    weights = 2 * 4 * c * c + c * 49 + 4 * c + 5 * c
    return (2 * 2 * t * c * 4 * c, (2 * t * c + weights) * itemsize,
            t * c * (2 * 49 + 8 + 4 * 10 + 3))


def decoder_tail_cost(b, h, w, ca=256, cl=64, c0=64, c1=32, co=2, itemsize=2):
    """concat -> 3x3 conv (ca+cl -> c0) at (h, w) -> 2x upsample -> 3x3 conv
    (c0 -> c1) and 1x1 prediction (c1 -> co) at (2h, 2w); ReLUs and the
    upsample (~8 ops an element) on the CUDA cores."""
    tc = 2 * b * h * w * 9 * (ca + cl) * c0 + 2 * b * 4 * h * w * (9 * c0 * c1 + c1 * co)
    tensors = b * h * w * (ca + cl) + b * 4 * h * w * co
    weights = 9 * (ca + cl) * c0 + 9 * c0 * c1 + c1 * co + c0 + c1 + co
    f32 = b * h * w * c0 + b * 4 * h * w * (c0 * 8 + c1)
    return tc, (tensors + weights) * itemsize, f32


def fused_block_cost(b, hw, m, c, heads, itemsize=2):
    """The MiT block after LN1: the attention sub-block, LN2, the MixFFN and
    both skips; its inputs are ln1(x), kv_in and x, its output the block's."""
    tc_a, bytes_a, f32_a = attention_cost(b, hw * hw, m, c, heads, itemsize, residual=True)
    tc_f, bytes_f, f32_f = mixffn_cost(b, hw, hw, c, itemsize)
    io_f = 2 * b * hw * hw * c * itemsize  # the FFN's x and out stay on chip
    return tc_a + tc_f, bytes_a + bytes_f - io_f, f32_a + f32_f + 10 * b * hw * hw * c


def flagship(b: int = 8) -> dict[str, tuple[str, list]]:
    """Each TPU kernel: (file:line of its pallas_call, [(cost, calls per
    forward), ...]) at the flagship shapes and batch b. The decoder tail
    has no model path in the JAX package: its two calls are one per head,
    as ``chip_smoke.py``'s tail path makes them; stage-1 attention and the
    whole-block kernel count the blocks they would take (stage 1; stages
    3-4)."""
    return {
        "fused_attention": ("perspectivefields_tpu/kernels/fused_attention.py:286", [
            (attention_cost(b, 1600, 100, 128, 2), 4),
            (attention_cost(b, 400, 100, 320, 5), 18),
            (attention_cost(b, 100, 100, 512, 8), 3),
        ]),
        "stage1_attention": ("perspectivefields_tpu/kernels/stage1_attention.py:237", [
            (attention_cost(b, 6400, 100, 64, 1), 3),
        ]),
        "mixffn": ("perspectivefields_tpu/kernels/mixffn.py:155", [
            (mixffn_cost(b, 80, 80, 64), 3), (mixffn_cost(b, 40, 40, 128), 4),
            (mixffn_cost(b, 20, 20, 320), 18), (mixffn_cost(b, 10, 10, 512), 3),
        ]),
        "convnext_block": ("perspectivefields_tpu/kernels/convnext_block.py:226", [
            (convnext_block_cost(b, 80, 80, 96), 3), (convnext_block_cost(b, 40, 40, 192), 3),
            (convnext_block_cost(b, 20, 20, 384), 9), (convnext_block_cost(b, 10, 10, 768), 3),
        ]),
        "decoder_tail": ("perspectivefields_tpu/kernels/decoder_tail.py:220", [
            (decoder_tail_cost(b, 160, 160, co=2), 1), (decoder_tail_cost(b, 160, 160, co=1), 1),
        ]),
        "fused_block": ("perspectivefields_tpu/kernels/fused_block.py:233", [
            (fused_block_cost(b, 20, 100, 320, 5), 18), (fused_block_cost(b, 10, 100, 512, 8), 3),
        ]),
    }


def per_forward(calls: list) -> tuple[float, str]:
    """Sum of the calls' bounds (ms) and the term that carries more of it."""
    total, by_term = 0.0, {"bytes": 0.0, "operations": 0.0}
    for cost, n in calls:
        terms = bound_terms(*cost)
        by = max(terms, key=terms.get)
        total += n * terms[by]
        by_term[by] += n * terms[by]
    return total, max(by_term, key=by_term.get)


def main() -> None:
    print("kernel, pallas_call, calls per forward, bound per forward at B=8 (ms), bound by")
    for name, (where, calls) in flagship(8).items():
        ms, by = per_forward(calls)
        print(f"{name}, {where}, {sum(n for _, n in calls)}, {ms:.4f}, {by}")


if __name__ == "__main__":
    main()
