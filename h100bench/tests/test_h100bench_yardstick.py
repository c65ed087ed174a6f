"""The frozen yardstick: cost functions, FLOP count, traffic and trace
reading."""

from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from h100bench.yardstick import flops, roofline, trace, traffic


def test_frozen_cost_functions_equal_the_ports_at_the_flagship_shapes():
    """The copy agreed with kernels/roofline.py when it was made."""
    from perspectivefields_tpu_torch.kernels import roofline as port

    assert (roofline.PEAK_TC, roofline.PEAK_HBM, roofline.PEAK_F32) == (
        port.PEAK_TC, port.PEAK_HBM, port.PEAK_F32)
    for b in (8, 32):
        for n, m, c, h in ((6400, 100, 64, 1), (1600, 100, 128, 2), (400, 100, 320, 5),
                           (100, 100, 512, 8)):
            for res in (False, True):
                assert roofline.attention_cost(b, n, m, c, h, residual=res) == port.attention_cost(
                    b, n, m, c, h, residual=res)
        for hw, c in ((80, 64), (40, 128), (20, 320), (10, 512)):
            assert roofline.mixffn_cost(b, hw, hw, c) == port.mixffn_cost(b, hw, hw, c)
        for hw, c, h in ((20, 320, 5), (10, 512, 8)):
            assert roofline.fused_block_cost(b, hw, 100, c, h) == port.fused_block_cost(b, hw, 100, c, h)
        cost = roofline.attention_cost(b, 400, 100, 320, 5)
        assert roofline.bound_terms(*cost) == port.bound_terms(*cost)


def test_whole_block_bound_reads_no_more_bytes_than_the_fused_blocks():
    """The whole block's input and output once: fewer bytes than the
    fused-block kernel's inputs (ln1(x), kv_in, x), more operations."""
    for hw, c, h in ((20, 320, 5), (10, 512, 8)):
        whole = roofline.mit_block_cost(32, hw, c, h, 2 if hw == 20 else 1)
        fused = roofline.fused_block_cost(32, hw, 100, c, h)
        assert whole[1] <= fused[1] and whole[0] >= fused[0]


def test_a_convolutions_backward_counts_its_forward_once_a_gradient():
    for groups in (1, 64):
        x = torch.randn(2, 64, 16, 16, requires_grad=True)
        w = torch.randn(64, 64 // groups, 3, 3, requires_grad=True)
        with FlopCounterMode(display=False) as fwd:
            F.conv2d(x, w, padding=1, groups=groups)
        mapping = {torch.ops.aten.convolution_backward: flops._conv_backward}
        with FlopCounterMode(display=False, custom_mapping=mapping) as both:
            F.conv2d(x, w, padding=1, groups=groups).sum().backward()
        assert both.get_total_flops() == 3 * fwd.get_total_flops()


def test_every_seed_sends_the_same_sizes():
    for seed in (0, 2**31 + 5, 2**40):
        order = traffic.size_order(seed, 3, 10)
        assert all(sorted(order[3 * r:3 * r + 3]) == [0, 1, 2] for r in range(10))
    assert traffic.size_order(7, 3, 10) == traffic.size_order(7, 3, 20)[:30]


def test_traffic_is_a_function_of_the_seed():
    a = traffic.frame_pool(2**33 + 1, 3, 8, 8)
    assert (a == traffic.frame_pool(2**33 + 1, 3, 8, 8)).all()
    assert not (a == traffic.frame_pool(2**33 + 2, 3, 8, 8)).all()
    assert traffic.sample(5, 100, 4) == traffic.sample(5, 100, 4)
    pools = [traffic.train_pool(9, 2, 2, 16, (1.0, 2.0, 3.0), "cpu",
                                {"vfov": [30, 120], "elevation": [-60, 60], "roll": [-45, 45]})
             for _ in range(2)]
    for x, y in zip(*pools):
        assert all(torch.equal(x[k], y[k]) for k in x)
    up = pools[0][0]["gt_gravity"]
    assert torch.allclose(up.norm(dim=-1), torch.ones(()), atol=1e-5)


def test_the_training_pools_fields_are_the_ports():
    from perspectivefields_tpu_torch.ops.geometry import lat_field, up_field

    vfov, el, roll = torch.tensor([0.9, 1.7]), torch.tensor([0.3, -0.6]), torch.tensor([0.1, -0.5])
    focal = 1.0 / (2.0 * torch.tan(vfov / 2.0))
    assert torch.allclose(traffic._up_field(focal, 24, 16, el, roll), up_field(vfov, 24, 16, el, roll),
                          atol=1e-6)
    assert torch.allclose(traffic._lat_field(focal, 24, 16, el, roll), lat_field(vfov, 24, 16, el, roll),
                          atol=1e-4)


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "pid": 1,
            "args": args}


def test_trace_reading():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 100),
        _ev("user_annotation", "h100bench.block:1.0", 10, 20),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        _ev("cpu_op", "aten::slow_host_op", 50, 30),
        _ev("kernel", "k1", 20, 10, correlation=1),
        _ev("kernel", "k2", 25, 10, correlation=2),
        _ev("gpu_memcpy", "copy", 90, 20),
    ]
    tr = trace.Trace(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(25e-6)  # [20, 35] and [90, 100]
    assert tr.kernel_s_by_range("h100bench.block:") == {"h100bench.block:1.0": pytest.approx(10e-6)}
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::slow_host_op"] == pytest.approx(55e-6)  # [35, 90]
    assert gaps["h100bench.block:1.0"] == pytest.approx(20e-6)  # [0, 20]
    assert dict(tr.device_ops())["copy"] == pytest.approx(20e-6)


def test_device_only_trace_window_runs_between_the_synchronizes():
    events = [_ev("cuda_runtime", "cudaDeviceSynchronize", 0, 5),
              _ev("kernel", "k", 10, 20),
              _ev("cuda_runtime", "cudaDeviceSynchronize", 25, 10)]
    tr = trace.Trace(events)
    assert tr.window_s == pytest.approx(30e-6) and tr.busy_s == pytest.approx(20e-6)
