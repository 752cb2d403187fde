"""The yardstick's arithmetic on the CPU: operations counted from the
shapes against PyTorch's own count of a forward and backward, kernel bytes
against hand counts, the readers' shares, and the frozen union-of-intervals
trace reader on overlapping events."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_helpers import one_thread
from benchmark.counts import deeplab, kernels
from benchmark.harness import make, readers, trace
from benchmark.reference.model import Net, param_spec


@pytest.mark.parametrize("arch,hw", [("resnet18", (64, 64)),
                                     ("resnet50", (48, 80))])
def test_model_operations_match_torchs_count(arch, hw):
    one_thread()
    nc = 6
    w = make.weights(param_spec(arch, nc), 3, "cpu")
    w = {k: v.requires_grad_(v.is_floating_point()) for k, v in w.items()}
    net = Net(w, arch)
    x = torch.randn(2, 3, *hw)
    masks = {h: torch.ones(2, 512, -(-hw[0] // 16), -(-hw[1] // 16),
                           dtype=torch.bool) for h in ("layer5", "layer6")}
    with FlopCounterMode(display=False) as fwd:
        x1, x2, _ = net.train_forward(x, masks)
    assert fwd.get_total_flops() == 2 * deeplab.forward_flops(arch, nc, hw)
    with FlopCounterMode(display=False) as both:
        x1, x2, _ = net.train_forward(x, masks)
        (x1.sum() + x2.sum()).backward()
    assert both.get_total_flops() == 2 * deeplab.train_flops(arch, nc, hw)


def test_kernel_counts_against_hand_counts():
    # K1 on (2, 4, 3, 5) bf16: x and y 120 elements of 2 bytes, mean and
    # rstd 8 floats each
    assert kernels.k1(2, 4, 3, 5) == (480, 2 * 120 * 2 + 2 * 8 * 4)
    assert kernels.k1_bwd(2, 4, 3, 5) == (960, 3 * 120 * 2 + 2 * 8 * 4)
    # K9: 2 windows of 4x4x3 uint8 in, 2x3x4x4 f32 out
    assert kernels.k9(2, 4, 4) == (192, 96 + 384)
    # K5: data 2x10x3 f32, ids 2x10 int32, out 2x5x3 f32
    assert kernels.k5(2, 10, 3, 5) == (60, 240 + 80 + 120)
    assert kernels.k7(2, 10, 3, 5) == (0, 120 + 80 + 240)
    # K8: probs 1x3x2x2 f32 in; label, w, u 1x2x2 out
    assert kernels.k8(1, 3, 2, 2) == (120, 48 + 48)
    # K3: 1 image, 2 heads of 3 classes at 2x2 in, 3 classes at 4x4 out
    assert kernels.k3(1, 2, 3, 2, 2, 4, 4) == (768, 48 + 96)
    # K2: the 7x7/2 conv of 1x3x8x8 to 64 channels at 4x4, pooled to 2x2
    ops, nbytes = kernels.k2(1, 8, 8)
    assert ops == 2 * 64 * 3 * 49 * 16
    assert nbytes == 384 + 512 + 64 * 3 * 49 * 2 + 256


def test_union_of_intervals_on_overlapping_events(tmp_path):
    ivs = [(0, 10), (5, 15), (20, 30), (25, 26), (30, 31)]
    assert trace.union_busy(ivs) == 26
    assert trace.union_busy([]) == 0
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 1e9 + 0.001,
               "dur": 0.010, "pid": 0, "tid": 7},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 1e9 + 0.011,
               "dur": 0.004, "pid": 0, "tid": 7},
              {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
               "ts": 1e9 + 0.012, "dur": 0.010, "pid": 1, "tid": 1},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 1e9 + 0.020,
               "dur": 0.002, "pid": 0, "tid": 7}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = trace.load_events(str(path))
    assert [e["ts"] for e in got if e["cat"] == "kernel"] == \
        [1000000000001, 1000000000011, 1000000000020]
    s = trace.summarize(got, wall_ns=40)
    # back-to-back kernels a and b (1-11, 11-15) and a at 20-22: 16 ns
    assert s["busy_ns"] == 16
    assert s["by_name"] == {"a": 12, "b": 4} and s["calls"]["a"] == 2
    assert s["gaps"] == [("host: aten::mm", 5)]
    run = {"stretch": s, "stretch_launches": {"instance_norm": 2},
           "kernel_calls": {"k1": (1, 1, 1, 1)}}
    assert readers.idle_share(run) == pytest.approx(60.0)
    assert readers.roofline({**run, "stretch": {**s, "by_name": {}}},
                            "k1") is None


def test_roofline_needs_the_trace_to_hold_each_launch():
    """A roofline share counts the wrappers' launches only where the trace
    holds as many of the kernel's events (K5: its fill and its reduction
    a launch); otherwise it reports nothing."""
    def run(by_name, calls, launches):
        return {"stretch": {"busy_ns": 100, "wall_ns": 100,
                            "by_name": by_name, "calls": calls, "gaps": []},
                "stretch_launches": {"segment_max": launches},
                "kernel_calls": {"k5": (1, 10, 3, 5)}}

    by_name = {"void fill_kernel<true>": 40,
               "void segment_reduce_kernel<int, true, true>": 60}
    ops, nbytes = kernels.k5(1, 10, 3, 5)
    bound_ns = max(ops / 989e12, nbytes / 3.35e12) * 1e9
    two = run(by_name, {n: 2 for n in by_name}, 2)
    assert readers.roofline(two, "k5") == pytest.approx(
        100.0 * 2 * bound_ns / 100)
    assert readers.launch_check(two) == {"k5": (2, 4, 4)}
    assert readers.roofline(run(by_name, {n: 2 for n in by_name}, 3),
                            "k5") is None
    one_fill = {"void fill_kernel<true>": 1,
                "void segment_reduce_kernel<int, true, true>": 2}
    assert readers.roofline(run(by_name, one_fill, 2), "k5") is None


def test_mfu_of_the_stretch_is_over_its_busy_time():
    run = {"stretch": {"busy_ns": 2_000_000_000, "wall_ns": 4_000_000_000,
                       "by_name": {"k": 1}, "calls": {"k": 1}, "gaps": []},
           "stretch_work": 30, "layer": {"request_flops": 989e12 / 30}}
    assert readers.mfu_busy(run, "request_flops") == pytest.approx(50.0)
    assert readers.mfu_busy({"layer": run["layer"]}, "request_flops") is None
