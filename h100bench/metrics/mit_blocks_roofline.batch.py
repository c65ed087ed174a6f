"""The MiT blocks' share of their roofline: the least time of every block's
work at the call's batch (the frozen cost functions: the whole block, input
and output once, weights once, bf16) over the device time of the kernels
launched inside the blocks' ranges, per forward, %."""

from h100bench.yardstick import roofline


def read(ctx):
    tr = ctx.get("host_trace")
    n = ctx.get("profiled_forwards")
    if tr is None or not n:
        return None
    per_block = tr.kernel_s_by_range("h100bench.block:")
    bb = ctx["config"]["model"]["backbone"]
    hw = ctx["config"]["model"]["resize"][0] // 4
    least_ms = 0.0
    for s in range(4):
        for i in range(bb["depths"][s]):
            if f"h100bench.block:{s + 1}.{i}" not in per_block:
                return None
            least_ms += roofline.least_ms(roofline.mit_block_cost(
                ctx["batch"], hw >> s, bb["dims"][s], bb["num_heads"][s], bb["sr_ratios"][s]))
    device_ms = sum(per_block.values()) * 1e3 / n
    return 100.0 * least_ms / device_ms
