"""The trace reduction on hand-made events: busy time is the union of the
device intervals, percentiles come from the raw samples."""

import re
import statistics

import pytest

from hqrbench import stats, trace, work
from hqrbench.trace import Event, TraceView

CLASSES = [("gemm", re.compile("gemm")),
           ("panel", re.compile("panel_qr_kernel"))]
CTX = {"m": 1024, "n": 256, "item": 4,
       "peak": {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}}


def test_union_counts_overlap_once():
    # two streams: [0, 10) beside [5, 15), then [20, 30)
    spans = [(0, 10), (5, 15), (20, 30)]
    assert trace.union_ns(spans) == 25
    assert sum(e - s for s, e in spans) == 30  # the sum of self-times
    assert trace.gaps(spans, 0, 40) == [(15, 20), (30, 40)]
    assert trace.union_ns([]) == 0
    assert trace.gaps([], 3, 7) == [(3, 7)]
    assert trace.union_ns([(0, 10), (2, 3), (4, 12)]) == 12


def _events():
    """Two calls: a factor span launching a panel kernel and a GEMM that
    overlap on two streams, and a solve span launching one GEMM; the
    device is idle while the host draws."""
    ev = []
    for call, t in enumerate((0, 1000)):
        ev += [Event("hqrbench.draw", "user_annotation", t, t + 100),
               # the device-side copy of a span is neither span nor work
               Event("hqrbench.factor", "gpu_user_annotation", t + 150,
                     t + 550),
               Event("hqrbench.factor", "user_annotation", t + 100, t + 300),
               Event("hqrbench.solve", "user_annotation", t + 300, t + 400),
               Event("hqrbench.wait", "user_annotation", t + 400, t + 900)]
        c = 10 * call
        ev += [Event("cudaLaunchKernel", "cuda_runtime", t + 110, t + 120,
                     corr=c + 1),
               Event("cudaLaunchKernel", "cuda_runtime", t + 130, t + 140,
                     corr=c + 2),
               Event("aten::mm", "cpu_op", t + 310, t + 390, corr=c + 3),
               Event("void panel_qr_kernel<float>", "kernel", t + 150,
                     t + 450, corr=c + 1),
               Event("sm90_xmma_gemm_f32", "kernel", t + 350, t + 550,
                     corr=c + 2),
               # linked to aten::mm, no runtime event of its own
               Event("gemv2T_kernel", "kernel", t + 560, t + 660,
                     corr=c + 9, linked=c + 3)]
    return ev


def test_attribution_busy_and_idle():
    view = TraceView(_events(), 2, CTX, CLASSES)
    assert view.window == (0, 1900)
    assert view.unattributed == 0
    assert view.count({"panel"}, ("hqrbench.factor",)) == 2
    assert view.count({"gemm"}, ("hqrbench.factor",)) == 2
    assert view.count(None, ("hqrbench.solve",)) == 2
    # per call: panel [150, 450) and gemm [350, 550) overlap: busy 400,
    # not 500; then 100 more
    assert view.busy_seconds() == pytest.approx(2 * 500e-9)
    assert view.device_seconds() == pytest.approx(2 * 600e-9)
    assert view.window_seconds() == pytest.approx(1900e-9)
    idle = dict(view.idle_gaps())
    # [0, 150) under draw/factor, [550, 560) and [660, 1150) ... by host op
    assert sum(idle.values()) == pytest.approx((1900 - 1000) * 1e-9)
    assert idle["hqrbench.wait"] > 0
    assert [n for n, _ in view.top_device_ops(1)] == \
        ["[panel] void panel_qr_kernel<float>"]
    assert view.span_seconds(("hqrbench.factor", "hqrbench.solve")) == \
        pytest.approx([200e-9, 100e-9, 200e-9, 100e-9])


def test_readers_on_the_view():
    from hqrbench.metrics import (device_idle_pct, enqueue_ms,
                                  panel_roofline_pct, solve_roofline_pct)

    view = TraceView(_events(), 2, CTX, CLASSES)
    assert device_idle_pct.read(view) == pytest.approx(
        100 * (1 - 1000 / 1900))
    assert enqueue_ms.read(view) == pytest.approx(1e3 * 300e-9)
    # one launch per call on 256 columns: one 1024 x 256 leaf
    least = work.panel_least_seconds(1024, 256, 1, 4, CTX["peak"])
    assert panel_roofline_pct.read(view) == pytest.approx(
        100 * least / 300e-9)
    assert solve_roofline_pct.read(view) == pytest.approx(
        100 * work.solve_least_seconds(1024, 256, 4, CTX["peak"]) / 100e-9)
    empty = TraceView([Event("hqrbench.draw", "user_annotation", 0, 5)], 1,
                      CTX, CLASSES)
    assert panel_roofline_pct.read(empty) is None
    assert device_idle_pct.read(empty) is None
    assert solve_roofline_pct.read(empty) is None


def test_classes_from_files():
    classes = trace.load_classes()
    assert {c for c, _ in classes} >= {"panel", "gemm", "trsm"}
    assert trace.classify("void panel_qr_kernel<float, 128>(float*)",
                          classes) == "panel"
    assert trace.classify("some_renamed_kernel", classes) == trace.OTHER


def test_percentile_from_raw_samples():
    values = list(range(1, 101))
    assert stats.percentile(values, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    # one slow call in ten moves p90, not the median
    lat = [10.0] * 89 + [50.0] * 11
    assert stats.percentile(lat, 90) == 50.0
    assert statistics.median(lat) == 10.0
    with pytest.raises(ValueError):
        stats.percentile([], 90)

