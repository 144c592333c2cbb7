"""The program's ``dhqr.*`` spans on hand-made events: nesting, the
attribution of device operations through their linked host operation,
self time, idle inside a span, and the five readers built on them."""

import re

import pytest

from hqrbench import program, work
from hqrbench.trace import Event, TraceView

CLASSES = [("gemm", re.compile("gemm|gemv")),
           ("panel", re.compile("panel_qr_kernel")),
           ("trsm", re.compile("trsm"))]
CTX = {"m": 1024, "n": 256, "item": 4,
       "peak": {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}}
PEAK = CTX["peak"]
WINDOW_NS = 3900


def _events(spans=True, extra=()):
    """Two calls of qr (two 128-wide panels, one trailing update) then
    solve. Host: the benchmark's spans, the program's spans and the aten
    ops inside them; device: a copy and a ctypes kernel linked to the
    first panel's span, a GEMM in the trailing update, the second panel's
    kernel, a GEMV in Q^H b, a trsm in back-substitution, each with its
    runtime launch. ``spans=False`` leaves the ``dhqr.*`` events out."""
    ev = []
    for call, t in enumerate((0, 2000)):
        c = 100 * call
        ev += [Event("hqrbench.draw", "user_annotation", t, t + 100),
               Event("hqrbench.factor", "user_annotation", t + 100, t + 700),
               Event("hqrbench.solve", "user_annotation", t + 700, t + 900),
               Event("hqrbench.wait", "user_annotation", t + 900, t + 1900)]
        mine = [Event("dhqr.qr", "user_annotation", t + 100, t + 690, c + 10),
                Event("dhqr.factor", "user_annotation", t + 120, t + 600,
                      c + 11),
                Event("dhqr.panel", "user_annotation", t + 130, t + 300,
                      c + 2),
                Event("dhqr.trailing", "user_annotation", t + 310, t + 400,
                      c + 12),
                Event("dhqr.panel", "user_annotation", t + 410, t + 590,
                      c + 4),
                Event("dhqr.solve", "user_annotation", t + 700, t + 890,
                      c + 13),
                Event("dhqr.apply_qt", "user_annotation", t + 710, t + 800,
                      c + 14),
                Event("dhqr.back_substitute", "user_annotation", t + 810,
                      t + 880, c + 15),
                # the device-side copy of a span: neither span nor work
                Event("dhqr.panel", "gpu_user_annotation", t + 160, t + 400)]
        ev += mine if spans else []
        ev += [Event("aten::copy_", "cpu_op", t + 140, t + 150, c + 1),
               Event("aten::mm", "cpu_op", t + 320, t + 330, c + 3),
               Event("aten::mm", "cpu_op", t + 720, t + 730, c + 5),
               Event("aten::linalg_solve_triangular", "cpu_op", t + 820,
                     t + 830, c + 6)]
        device = [("elementwise_copy", t + 160, t + 200, c + 1, t + 145),
                  ("void panel_qr_kernel<float>", t + 200, t + 400, c + 2,
                   t + 260),
                  ("sm90_xmma_gemm_f32", t + 400, t + 500, c + 3, t + 325),
                  ("void panel_qr_kernel<float>", t + 500, t + 650, c + 4,
                   t + 450),
                  ("gemv2T_kernel", t + 750, t + 800, c + 5, t + 725),
                  ("trsm_left_kernel", t + 830, t + 860, c + 6, t + 825)]
        for i, (name, s, e, linked, launch) in enumerate(device):
            corr = 1000 + c + i
            ev += [Event("cudaLaunchKernel", "cuda_runtime", launch,
                         launch + 4, corr=corr),
                   Event(name, "kernel", s, e, corr=corr, linked=linked)]
    return ev + list(extra)


def _view(events, calls=2):
    return TraceView(events, calls, CTX, CLASSES)


def test_nesting_attribution_and_self_time():
    view = _view(_events())
    prog = program.of(view)
    assert program.of(view) is prog
    assert prog.count(("dhqr.panel",)) == 4
    parents = {prog.spans[i].name: prog.spans[prog.parent[i]].name
               for i in range(len(prog.spans)) if prog.parent[i] is not None}
    assert parents == {"dhqr.factor": "dhqr.qr", "dhqr.panel": "dhqr.factor",
                       "dhqr.trailing": "dhqr.factor",
                       "dhqr.apply_qt": "dhqr.solve",
                       "dhqr.back_substitute": "dhqr.solve"}
    names = [None if i is None else prog.spans[i].name for i in prog.op_span]
    assert names == ["dhqr.panel", "dhqr.panel", "dhqr.trailing",
                     "dhqr.panel", "dhqr.apply_qt",
                     "dhqr.back_substitute"] * 2
    assert prog.device_seconds(("dhqr.panel",)) == pytest.approx(780e-9)
    # dhqr.qr less dhqr.factor, dhqr.solve less its two children
    assert prog.self_seconds(("dhqr.qr",)) == pytest.approx(2 * 110e-9)
    assert prog.self_seconds(("dhqr.solve",)) == pytest.approx(2 * 30e-9)
    assert prog.entry_shares(("hqrbench.factor", "hqrbench.solve")) == \
        pytest.approx({"dhqr": 2 * 570e-9, "outside": 0.0,
                       "unattributed": 0.0})
    # the first panel waits 30 ns for its copy; the second is never idle
    assert prog.idle_seconds(("dhqr.panel",)) == pytest.approx(2 * 30e-9)


def test_readers_on_a_two_call_trace():
    from hqrbench.metrics import (api_self_ms, panel_idle_pct,
                                  panel_step_roofline_pct,
                                  solve_step_roofline_pct,
                                  trailing_step_roofline_pct)

    view = _view(_events())
    assert api_self_ms.read(view) == pytest.approx(1e3 * 140e-9)
    panel_least = work.panel_least_seconds(1024, 256, 2, 4, PEAK)
    assert panel_step_roofline_pct.read(view) == pytest.approx(
        100 * panel_least * 2 / 780e-9)
    trailing_least = work.trailing_least_seconds(1024, 256, 2, 4, PEAK)
    assert trailing_step_roofline_pct.read(view) == pytest.approx(
        100 * trailing_least * 2 / 200e-9)
    solve_least = work.solve_least_seconds(1024, 256, 4, PEAK)
    assert solve_step_roofline_pct.read(view) == pytest.approx(
        100 * solve_least * 2 / 160e-9)
    assert panel_idle_pct.read(view) == pytest.approx(
        100 * 60 / WINDOW_NS)


def test_a_missing_linked_host_op_is_unattributed():
    lost = Event("void panel_qr_kernel<float>", "kernel", 2660, 2690,
                 corr=5000, linked=999)
    view = _view(_events(extra=[lost]))
    prog = program.of(view)
    assert prog.linked.count(False) == 1
    assert prog.unattributed_seconds() == pytest.approx(30e-9)
    assert prog.device_seconds(("dhqr.panel",)) == pytest.approx(780e-9)
    shares = prog.entry_shares(("hqrbench.factor", "hqrbench.solve"))
    assert shares["unattributed"] == 0.0  # no launch: in no entry span
    assert view.unattributed == 1


def test_uneven_panel_counts_read_none():
    from hqrbench.metrics import (api_self_ms, panel_step_roofline_pct,
                                  trailing_step_roofline_pct)

    view = _view(_events(), calls=3)  # four panels over three calls
    assert panel_step_roofline_pct.read(view) is None
    assert trailing_step_roofline_pct.read(view) is None
    assert api_self_ms.read(view) is not None


def test_a_program_without_spans_reads_none():
    from hqrbench.metrics import (api_self_ms, panel_idle_pct,
                                  panel_step_roofline_pct,
                                  solve_step_roofline_pct,
                                  trailing_step_roofline_pct)

    view = _view(_events(spans=False))
    for reader in (api_self_ms, panel_idle_pct, panel_step_roofline_pct,
                   solve_step_roofline_pct, trailing_step_roofline_pct):
        assert reader.read(view) is None


@pytest.mark.parametrize("name", ["enqueue_ms", "panel_roofline_pct",
                                  "trailing_roofline_pct",
                                  "solve_roofline_pct", "device_idle_pct"])
def test_existing_readers_ignore_the_program_spans(name):
    from hqrbench import spec

    read = spec.reader(name)
    with_spans = read(_view(_events()))
    assert with_spans is not None
    assert with_spans == read(_view(_events(spans=False)))
