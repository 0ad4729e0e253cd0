"""The byte and FLOP counts, and each per-layer reader, on hand-worked
inputs."""

import importlib.util
from pathlib import Path

import pytest
import torch

from pbench import peaks, roofline
from pbench import trace as tracing

BENCH = Path(__file__).resolve().parents[1]


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        f"m_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_estimate_bytes():
    m = _metric("fused_estimate_roofline")
    codes = torch.zeros((10, 4), dtype=torch.int32)           # W = 4 words
    ids = torch.tensor([[0, 1, -1], [1, 1, 2]], dtype=torch.int32)
    q_unit = torch.zeros((2, 128))
    # rows {0, 1, 2} × (16 + 4 + 4) + ids 6 × 4 + 2 query rows × (512 + 8)
    # + √d 4 + estimates 6 × 4
    assert m.bytes_needed(codes, ids, q_unit) == 72 + 24 + 1040 + 4 + 24
    # a CPU call launches nothing
    assert m.launch_bytes(codes, None, None, ids, q_unit, None, None,
                          None) == 0


def test_gather_l2_bytes():
    m = _metric("gather_l2_roofline")
    base = torch.zeros((10, 8))
    ids = torch.tensor([[3, -1], [-1, -1], [3, 4]], dtype=torch.int32)
    # rows {3, 4} × 32 + ids 24 + 2 query lines × 32 + distances 24
    assert m.bytes_needed(base, ids) == 64 + 24 + 64 + 24


def test_flop_counts():
    assert peaks.ann_serve_flops(10_000, 1, 512, 128) == 1_310_720_000


def test_roofline_share_and_its_silence():
    kernels = {"void fused_estimate_kernel(int const*)": (0.002, 4),
               "void other(float*)": (1.0, 9)}
    ctx = {"trace": {"kernels": kernels},
           "bytes": {"r": [3.35e9, 4]}}
    assert roofline.share(ctx, "r", "fused_estimate_kernel") == \
        pytest.approx(50.0)
    ctx["bytes"]["r"] = [3.35e9, 3]          # launches differ: no reading
    assert roofline.share(ctx, "r", "fused_estimate_kernel") is None
    assert ctx["notes"]
    assert roofline.share({"trace": None, "bytes": None}, "r", "x") is None


def test_summarize_busy_union_and_gaps():
    ms = 1_000_000
    ops = [("void a<1>(int)", 0, 2 * ms), ("void b(int)", 1 * ms, 3 * ms),
           ("void a<1>(int)", 5 * ms, 6 * ms), ("c", 8 * ms, 9 * ms)]
    s = tracing.summarize(ops, window_s=0.010)
    assert s["busy_s"] == pytest.approx(0.005)        # [0,3] [5,6] [8,9]
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["before a<1>"] == pytest.approx(0.002)
    assert gaps["before c"] == pytest.approx(0.002)
    assert gaps["host, outside the device's first and last op"] == \
        pytest.approx(0.001)
    top = dict(s["breakdown"]["device_ops"])
    assert top["a<1>"] == pytest.approx(0.003)
    assert tracing.short_name(
        "void l2rows::rows_kernel<true, 2>(float const*, int)") == \
        "l2rows::rows_kernel<true, 2>"
    assert tracing.short_name(
        "void at::native::(anonymous namespace)::sort_kernel<4>(int)") == \
        "at::native::sort_kernel<4>"


def test_readers():
    calls = [{"search_seconds": 2.0, "iterations": 400, "queries": 100,
              "hops_sum": 5_000, "flops": 6.7e12},
             {"search_seconds": 1.0, "iterations": 200, "queries": 100,
              "hops_sum": 7_000, "flops": 6.7e12}]
    ctx = {"calls": calls, "window_s": 2.0,
           "trace": {"busy_s": 0.25, "window_s": 2.0, "untraced_s": 1.0}}
    assert _metric("hop_ms").read(ctx) == pytest.approx(5.0)
    assert _metric("hops_per_query").read(ctx) == pytest.approx(60.0)
    assert _metric("serve_mfu").read(ctx) == pytest.approx(10.0)
    assert _metric("idle_share").read(ctx) == pytest.approx(75.0)
    for c in calls:
        c["iterations"] = 0
    assert _metric("hop_ms").read(ctx) is None
    assert _metric("idle_share").read({"trace": None}) is None
