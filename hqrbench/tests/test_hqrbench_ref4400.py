"""The float64 cell ``ref4400.qr_solve``: its files found by name, its
draws in float64, its limits against a float32 control, and its two panel
readers on hand-made events, checked against hand counts of the
configuration's 32 panels."""

import re
import time

import pytest
import torch

import dhqr_tpu_torch
from hqrbench import spec
from hqrbench.control import readings
from hqrbench.loop import Inputs
from hqrbench.metrics import (panel_f64_roofline_pct,
                              panel_f64_step_roofline_pct)
from hqrbench.reference import householder as ref
from hqrbench.run import run_cell
from hqrbench.trace import Event, TraceView

CELL = "ref4400.qr_solve"
CLASSES = [("gemm", re.compile("gemm|gemv")),
           ("panel", re.compile("panel_qr_kernel")),
           ("trsm", re.compile("trsm"))]
PEAK = {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}
CTX = {"m": 4400, "n": 4000, "item": 8, "peak": PEAK}
PANELS = 32
KERNEL_NS, COPY_NS = 500, 100


def _hand_least_seconds():
    """The 32 panels by hand: 31 of 128 columns at columns 0, 128, ...,
    3840, and the last 32 wide at column 3968 with 432 rows."""
    total = 0.0
    for k in range(PANELS):
        c = 128 * k
        r, w = 4400 - c, (128 if k < 31 else 32)
        flops = 2.0 * r * w * w - 2.0 / 3.0 * w ** 3
        nbytes = 2.0 * r * w * 8 + w * 8
        total += max(flops / 67e12, nbytes / 3.35e12)
    return total


def _events(calls=2, spans=True):
    """``calls`` factor spans, each with 32 ``dhqr.panel`` spans (a copy
    and a ctypes panel kernel linked to the span) and a trailing GEMM
    between panels. ``spans=False`` leaves the ``dhqr.*`` events out."""
    ev, corr = [], 0
    step = KERNEL_NS + COPY_NS + 200
    for call in range(calls):
        t0 = call * (PANELS * step + 1000)
        ev += [Event("hqrbench.factor", "user_annotation", t0,
                     t0 + PANELS * step + 500),
               Event("hqrbench.solve", "user_annotation",
                     t0 + PANELS * step + 500, t0 + PANELS * step + 900)]
        for k in range(PANELS):
            t = t0 + 10 + k * step
            span, op, gemm = corr + 1, corr + 2, corr + 3
            corr += 10
            if spans:
                ev.append(Event("dhqr.panel", "user_annotation", t,
                                t + KERNEL_NS + COPY_NS, span))
            ev += [Event("aten::copy_", "cpu_op", t + 1, t + 2, op),
                   Event("aten::mm", "cpu_op", t + KERNEL_NS + COPY_NS + 10,
                         t + KERNEL_NS + COPY_NS + 20, gemm)]
            device = [("elementwise_copy", t + 5, t + 5 + COPY_NS, op,
                       t + 3),
                      ("void panel_qr_kernel<double, 2, 4>",
                       t + 5 + COPY_NS, t + 5 + COPY_NS + KERNEL_NS, span,
                       t + 4),
                      ("sm90_xmma_gemm_f64f64", t + KERNEL_NS + COPY_NS + 30,
                       t + KERNEL_NS + COPY_NS + 150, gemm,
                       t + KERNEL_NS + COPY_NS + 15)]
            for i, (name, s, e, linked, launch) in enumerate(device):
                c = 10 ** 6 + corr + i
                ev += [Event("cudaLaunchKernel", "cuda_runtime", launch,
                             launch + 1, corr=c),
                       Event(name, "kernel", s, e, corr=c, linked=linked)]
    return ev


def _view(events, calls=2):
    return TraceView(events, calls, CTX, CLASSES)


def test_the_configuration_panels_by_hand():
    got = panel_f64_roofline_pct.panels(4400, 4000)
    assert len(got) == PANELS
    assert got[:31] == [(4400 - 128 * k, 128) for k in range(31)]
    assert got[-1] == (432, 32)
    assert panel_f64_roofline_pct.least_seconds(CTX) == pytest.approx(
        _hand_least_seconds(), rel=1e-12)
    # every panel of this configuration is bound by its bytes
    assert _hand_least_seconds() == pytest.approx(sum(
        (2.0 * r * w * 8 + w * 8) / 3.35e12 for r, w in got), rel=1e-12)


def test_the_kernel_roofline_over_the_panel_kernels():
    kernel_s = 2 * PANELS * KERNEL_NS * 1e-9
    assert panel_f64_roofline_pct.read(_view(_events())) == pytest.approx(
        100.0 * _hand_least_seconds() * 2 / kernel_s)


def test_the_step_roofline_over_every_operation_of_the_panel_spans():
    # the copy and the kernel of each panel step, not the trailing GEMM
    step_s = 2 * PANELS * (KERNEL_NS + COPY_NS) * 1e-9
    assert panel_f64_step_roofline_pct.read(_view(_events())) == \
        pytest.approx(100.0 * _hand_least_seconds() * 2 / step_s)


def test_readers_read_none_where_the_trace_has_nothing():
    no_spans = _view(_events(spans=False))
    assert panel_f64_step_roofline_pct.read(no_spans) is None
    assert panel_f64_roofline_pct.read(no_spans) is not None
    no_kernels = [e for e in _events()
                  if "panel_qr_kernel" not in e.name]
    assert panel_f64_roofline_pct.read(_view(no_kernels)) is None
    assert panel_f64_roofline_pct.read(_view(_events(), calls=0)) is None


def test_the_cell_is_found_by_name():
    c = spec.load_cell(CELL)
    assert (c.config["m"], c.config["n"]) == (4400, 4000)
    assert c.config["dtype"] == "float64"
    assert c.config["options"] == {"engine": "householder", "blocked": True,
                                   "use_pallas": "always",
                                   "precision": "highest"}
    assert c.chips == 1 and c.traffic["entry"] == "qr_solve"
    assert set(c.limits) == {"factor_err", "fit_err"}
    assert [m["name"] for m in c.per_layer] == [
        "panel_f64_roofline_pct", "panel_f64_step_roofline_pct"]
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_inputs_draw_float64():
    cfg = dict(spec.load_cell(CELL).config, m=44, n=40)
    inputs = Inputs(cfg, 2 ** 33 + 5, "cpu")
    A, b = inputs.matrix("call", 0), inputs.rhs("call", 0)
    assert A.dtype == b.dtype == torch.float64
    assert A.shape == (44, 40) and b.shape == (44,)
    assert torch.equal(A, Inputs(cfg, 2 ** 33 + 5, "cpu").matrix("call", 0))
    assert 0.0 <= float(A.min()) and float(A.max()) < 1.0


class Float32Factorization:
    def __init__(self, H, alpha):
        self.H, self.alpha = H, alpha

    def solve(self, b):
        return ref.solve(self.H, self.alpha, b.float())


class Float32Control:
    """The plain reference in float32, the precision just below the
    configuration's float64, in the program's place."""

    @staticmethod
    def qr(A, device=None, **options):
        return Float32Factorization(*ref.qr(A.float()))


def _small():
    c = spec.load_cell(CELL)
    c.config = dict(c.config, m=1024, n=256)
    return c


def test_the_float32_control_fails_every_limit():
    r = run_cell(_small(), 2 ** 35 + 17, 0.3, False, Float32Control, "cpu",
                 time.perf_counter())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["correct"] is False
    # not by one limit alone: each number misses its limit by far
    for name, v in r["check"].items():
        assert v["value"] > 1e4 * v["limit"], (name, v)


@pytest.mark.parametrize("prog, correct", [(dhqr_tpu_torch, True),
                                           (Float32Control, False)])
def test_each_side_gets_its_verdict(prog, correct):
    found = readings(_small(), prog, 2 ** 35 + 19, "cpu")
    assert found["failed"] == 0 and found["correct"] is correct
