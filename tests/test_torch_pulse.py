"""PyTorch port: pulse, the collective profiler of the mesh dispatches, and
its network model (``dhqr_tpu_torch.obs.pulse`` / ``obs.netmodel``) — the
JAX checks of ``tests/test_pulse.py`` that read no XLA trace, with the
port's event vocabulary (NCCL kernels, c10d operators), the netmodel held
to the JAX one on the same inputs, and one measured dispatch on 2 gloo CPU
ranks: its report's census is the wire seam's, its DHQR306 verdict
``skip`` with the reason (gloo has no interconnect bandwidth), and the
armed dispatch's result is the plain one's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dhqr_tpu.obs import netmodel as jnet  # noqa: E402
from dhqr_tpu.obs import pulse as jpulse  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
from dhqr_tpu_torch import faults, obs  # noqa: E402
from dhqr_tpu_torch.obs import netmodel, pulse  # noqa: E402
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    ROWS,
    run_calls,
    run_ranks,
)
from dhqr_tpu_torch.utils.config import FaultConfig, ObsConfig  # noqa: E402

A, b = random_problem(32, 24, np.float64, seed=95)
TALL, TALL_B = random_problem(64, 8, np.float64, seed=96)


# ------------------------------------------------------------- netmodel

def test_classify_event_port_vocabulary():
    cases = {
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL": "psum",
        "ncclDevKernel_Broadcast_RING_LL": "broadcast",
        "ncclKernel_AllGather_RING_LL_Sum_int8_t": "all_gather",
        "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL": "reduce_scatter",
        "c10d::allreduce_": "psum",
        "c10d::broadcast_": "broadcast",
        "c10d::allgather_": "all_gather",
        "c10d::_allgather_base_": "all_gather",
        "c10d::alltoall_": "all_to_all",
        "ncclDevKernel_SendRecv": "ppermute",
        "record_param_comms": None,
        "aten::mm": None,
        "panel_qr_f32": None,
    }
    for name, family in cases.items():
        assert netmodel.classify_event(name) == family, name


def test_wire_bytes_algorithm_factors_match_jax():
    for family in ("psum", "all_gather", "reduce_scatter", "all_to_all",
                   "ppermute", "pbroadcast", "future_collective"):
        for P in (1, 2, 4, 8):
            assert netmodel.wire_bytes(family, 1000, P) == \
                jnet.wire_bytes(family, 1000, P)
    # the port's broadcast moves each byte over each of P-1 ring links
    assert netmodel.wire_bytes("broadcast", 1000, 4) == pytest.approx(750.0)
    assert netmodel.wire_bytes("broadcast", 1000, 1) == 0.0
    assert netmodel.collective_time_s("psum", 1e6, 2, 100.0) == \
        pytest.approx(1e-5)
    assert netmodel.collective_time_s("psum", 1e6, 2, None) is None
    assert netmodel.effective_gbps(1e9, 0.5) == 2.0
    assert netmodel.effective_gbps(1e9, 0.0) is None


@pytest.mark.parametrize("args", [
    ("psum", 20e-6, 1e6, 2, 100.0, 8.0), ("psum", 2e-3, 1e6, 2, 100.0, 8.0),
    ("psum", 2e-3, 0, 2, 100.0, 8.0), ("all_gather", 1e-4, 4e6, 4, 200.0,
                                       8.0)])
def test_explain_measured_matches_jax(args):
    mine, theirs = netmodel.explain_measured(*args), \
        jnet.explain_measured(*args)
    mine.pop("reason", None), theirs.pop("reason", None)  # the port's words
    assert mine == theirs
    skip = netmodel.explain_measured("psum", 2e-3, 1e6, 2, 0.0, 8.0)
    assert skip["status"] == "skip" and "bandwidth" in skip["reason"]
    tagged = netmodel.explain_measured("psum", 1e-5, 1e6, 2, 100.0, 8.0,
                                       wire_format="int8")
    assert tagged["f32_equivalent_bytes"] == 4_000_000


@pytest.mark.parametrize("args", [(2e-3, 1e-3, 100.0, 1e6), (3e-3, 0.0),
                                  (1e-3, 5e-3), (0.0, 0.0), (None, 2e-3),
                                  (1e-3, None), (2e-3, 1e-3, 100.0),
                                  (2e-3, 1e-3, None, 1e6)])
def test_comms_roofline_matches_jax(args):
    assert netmodel.comms_roofline(*args) == jnet.comms_roofline(*args)


def test_comms_roofline_fields():
    blk = netmodel.comms_roofline(2e-3, 1e-3, link_gbps=100.0,
                                  wire_bytes_moved=1e6)
    assert blk["comms_bound"] == "comms"
    assert blk["comms_fraction"] == pytest.approx(2 / 3, abs=1e-3)
    assert blk["overlap_headroom_s"] == pytest.approx(1e-3)
    assert blk["exposed_floor_s"] == pytest.approx(1e-3)
    null = netmodel.comms_roofline(None, None)
    assert null["comms_bound"] is None and "comms_reason" in null
    assert netmodel.comms_roofline(1e-3, 5e-3)["exposed_floor_s"] == 0.0


# ------------------------------------------------------- census parsing

def _event(name, lane="CPU/0/1", dur=10.0, device=False):
    return {"name": name, "dur": dur, "lane": lane, "device": device}


def test_collective_census_families_and_lanes():
    events = []
    for lane in ("CUDA/0/7", "CUDA/0/9"):  # two streams of one rank
        events += [_event("panel_qr_f32", lane, 100.0, True),
                   _event("ncclDevKernel_Broadcast_RING_LL", lane, 20.0,
                          True),
                   _event("ncclDevKernel_AllReduce_Sum_f32", lane, 30.0,
                          True)]
    events.append(_event("c10d::broadcast_", "CPU/-1/1", 5.0))  # host op
    census = pulse.collective_census(events)
    assert census["device_events"] == 6
    assert census["families"]["broadcast"] == {"events": 2,
                                               "time_us": 40.0}
    assert census["families"]["psum"]["events"] == 2
    assert len(census["lanes"]) == 2  # the host op is not read
    assert census["lanes"]["CUDA/0/7"]["busy_us"] == pytest.approx(150.0)
    assert census["lanes"]["CUDA/0/7"]["collective_us"] == \
        pytest.approx(50.0)


def test_collective_census_reads_the_host_without_device_collectives():
    events = [_event("aten::mm", "CUDA/0/7", 3.0, True),
              _event("c10d::allreduce_"), _event("c10d::broadcast_")]
    census = pulse.collective_census(events)
    assert census["device_events"] == 1
    assert set(census["families"]) == {"psum", "broadcast"}
    # gloo's worker events are the collectives' execution: read them, not
    # the c10d operators that enqueue them (one event per collective)
    events += [_event("gloo:all_reduce", "CPU/-1/3", 40.0),
               _event("gloo:broadcast", "CPU/-1/2", 60.0)]
    census = pulse.collective_census(events)
    assert census["families"] == {"psum": {"events": 1, "time_us": 40.0},
                                  "broadcast": {"events": 1,
                                                "time_us": 60.0}}


def test_measure_warm_run_suspends_the_fault_harness():
    """The warm run of a measurement must not consume schedule visits:
    the harness reads None there, and the measured run sees it."""
    seen = []

    def thunk():
        seen.append(faults.active())
        return 7

    with faults.injected(FaultConfig(
            sites=(("parallel.collective.corrupt", 1.0, 1, 3),))) as h:
        out, report = pulse.measure("unit", thunk)
    assert out == 7 and seen == [None, h]
    assert report.analytic is None and report.analytic_unavailable
    assert report.dhqr306["status"] == "skip"


# --------------------------------------------------------------- DHQR306

def test_dhqr306_fail_on_unexplainable_family():
    measured = {"all_to_all": {"launches": 1, "time_s": 1e-4}}
    analytic = {"psum": {"launches": 2, "volume_bytes": 100}}
    verdict = pulse._check_dhqr306(measured, analytic, (), 2, 100.0, 8.0)
    assert verdict["status"] == "fail"
    assert "no counterpart in the wire census" in \
        verdict["checks"][0]["reason"]


def test_dhqr306_contract_families_and_opacity():
    measured = {"all_gather": {"launches": 1, "time_s": 1e-6},
                "psum": {"launches": 3, "time_s": 1e-6}}
    analytic = {"all_gather": {"launches": 1, "volume_bytes": 1_000_000},
                "psum": {"launches": 3, "volume_bytes": 1_000_000}}
    verdict = pulse._check_dhqr306(measured, analytic, (), 1, None, 8.0,
                                   contract_families=())
    assert verdict["status"] == "fail"
    assert all(c["status"] == "fail" for c in verdict["checks"])
    verdict = pulse._check_dhqr306(measured, analytic, ("psum",), 2,
                                   100.0, 8.0)
    by_fam = {c["family"]: c for c in verdict["checks"]}
    assert by_fam["psum"]["status"] == "skip"
    assert by_fam["all_gather"]["status"] == "ok"
    # the same verdicts as the JAX package's rules on the same rows
    for args in ((measured, analytic, ("psum",), 2, 100.0, 8.0),
                 (measured, analytic, (), 1, None, 8.0)):
        mine = pulse._check_dhqr306(*args)
        theirs = jpulse._check_dhqr306(*args)
        assert mine["status"] == theirs["status"]
        assert [c["status"] for c in mine["checks"]] == \
            [c["status"] for c in theirs["checks"]]


def test_dhqr306_wire_check_red_green_and_link_reason():
    analytic = {"broadcast": {"launches": 1, "volume_bytes": int(1e6)}}
    green = pulse._check_dhqr306(
        {"broadcast": {"launches": 1, "time_s": 2e-5}}, analytic, (), 2,
        100.0, 8.0)
    assert green["status"] == "ok"
    red = pulse._check_dhqr306(
        {"broadcast": {"launches": 1, "time_s": 2e-3}}, analytic, (), 2,
        100.0, 8.0)
    assert red["status"] == "fail"
    why = "the gloo backend carries collectives through host memory"
    skip = pulse._check_dhqr306(
        {"broadcast": {"launches": 1, "time_s": 2e-3}}, analytic, (), 2,
        None, 8.0, link_reason=why)
    assert skip["status"] == "skip" and skip["reason"] == why
    assert skip["checks"][0]["reason"] == why


# ------------------------------------------------------ report + store

def test_report_fields_and_to_json_match_jax():
    mine = [f.name for f in dataclasses.fields(pulse.PulseReport)]
    theirs = [f.name for f in dataclasses.fields(jpulse.PulseReport)]
    assert mine == theirs
    kw = dict(label="x", n_devices=2, wire_format="bf16", wall_s=0.25,
              measured={"broadcast": {"launches": 3, "time_s": 1e-3}},
              dhqr306={"status": "skip", "checks": []}, ici_gbps=900.0)
    assert pulse.PulseReport(**kw).to_json() == \
        jpulse.PulseReport(**kw).to_json()
    row = pulse.PulseReport(label="x", n_devices=2).to_json()
    assert row["measured"] is None and row["measured_unavailable"]
    assert row["analytic"] is None and row["analytic_unavailable"]
    assert row["skew"] is None and row["skew_unavailable"]
    assert pulse.PulseReport(label="x").dhqr306_pass is True


def test_store_capture_once_and_stats():
    store = pulse.PulseStore(max_reports=2)
    assert store.begin("a") is True
    assert store.begin("a") is False
    rep = pulse.PulseReport(label="a", n_devices=2,
                            dhqr306={"status": "fail", "checks": []})
    store.capture("a", rep)
    stats = store.stats()
    assert stats["captures"] == 1 and stats["reports"] == 1
    assert stats["unsupported"] == 1 and stats["dhqr306_failures"] == 1
    for label in ("b", "c"):
        store.begin(label)
        store.capture(label, pulse.PulseReport(label=label))
    stats = store.stats()
    assert stats["reports"] == 2 and stats["evicted"] == 1
    assert store.report("a") is None and store.begin("a") is False
    with pytest.raises(ValueError):
        pulse.PulseStore(max_reports=0)


def test_rows_from_json_and_format_table():
    rep = pulse.PulseReport(
        label="blocked_qr[P=2,32x24,nb=4,block]", n_devices=2,
        measured={"broadcast": {"launches": 12, "time_s": 1e-3}},
        comms={"comms_fraction": 0.25, "effective_gbps": 1.5},
        dhqr306={"status": "skip", "checks": []})
    rows = pulse.rows_from_json([{"pulse": rep.to_json()}, {"stage": "x"},
                                 rep.to_json(), 3])
    assert len(rows) == 2 and rows[0]["label"] == rep.label
    table = pulse.format_table(rows)
    assert "broadcast:12x" in table and "skip" in table
    assert table.splitlines()[0].split()[0] == "label"


def test_observed_dispatch_disarmed_is_plain():
    pulse.disarm()
    calls = []
    out = pulse.observed_dispatch("label", lambda: calls.append(1) or 42)
    assert out == 42 and calls == [1] and pulse.active() is None


def test_pulsed_scope_nests_and_restores():
    pulse.disarm()
    with pulse.pulsed(max_reports=3) as outer:
        assert pulse.active() is outer
        with pulse.pulsed() as inner:
            assert pulse.active() is inner
        assert pulse.active() is outer
    assert pulse.active() is None


def test_obsconfig_pulse_env(monkeypatch):
    monkeypatch.setenv("DHQR_OBS_PULSE", "1")
    monkeypatch.setenv("DHQR_OBS_PULSE_REPORTS", "32")
    cfg = ObsConfig.from_env()
    assert cfg.pulse is True and cfg.pulse_reports == 32
    monkeypatch.setenv("DHQR_OBS_PULSE", "off")
    assert ObsConfig.from_env().pulse is False
    with pytest.raises(ValueError):
        ObsConfig(pulse_reports=0)


def test_obs_arm_arms_and_disarms_pulse():
    obs.arm(ObsConfig(pulse=True, pulse_reports=17))
    store = pulse.active()
    assert store is not None and store.max_reports == 17
    obs.arm(ObsConfig())          # declaratively off
    assert pulse.active() is None
    obs.arm(ObsConfig(pulse=True))
    obs.disarm()
    assert pulse.active() is None
    assert obs.PulseReport is pulse.PulseReport


# --------------------------------------------- one measured gloo dispatch

@pytest.fixture(scope="module")
def two():
    qr_bf16 = ("sharded_blocked_qr", (A, COLS), dict(block_size=4,
                                                     comms="bf16"))
    cases = [{"steps": [("obs.pulse.arm", (), {}), qr_bf16],
              "census": True},                       # measured
             [qr_bf16],                               # measured already
             [("sharded_tsqr_lstsq", (TALL, TALL_B, ROWS),
               dict(block_size=4, comms="int8"))],
             [("obs.pulse.active", (), {}), (".reports", (), {})],
             [("obs.pulse.active", (), {}), (".stats", (), {})],
             [("obs.pulse.disarm", (), {}), qr_bf16]]  # disarmed
    return run_ranks(run_calls, 2, device="cpu", timeout_s=240, cases=cases)


def test_measured_gloo_dispatch_reports_the_census_and_skips(two):
    for rank in two:
        status, _, census = rank[0]
        assert status == "ok"
        reports = rank[3][1]
        assert len(reports) == 2
        qr_rep, tsqr_rep = reports
        assert qr_rep.label == "blocked_qr[P=2,32x24,nb=4,block,wbf16]"
        assert tsqr_rep.label == "tsqr_lstsq[P=2,64x8,nb=4,wint8]"
        assert qr_rep.n_devices == 2 and qr_rep.wire_format == "bf16"
        assert qr_rep.device_kind == "cpu"
        # the analytic side is the seam's census of the measured run: the
        # case saw the dispatch twice (warm, measured)
        fams = qr_rep.analytic
        assert set(fams) == {"broadcast"}
        bcasts = [e for e in census if e["family"] == "broadcast"]
        assert fams["broadcast"]["collectives"] * 2 == len(bcasts)
        assert fams["broadcast"]["volume_bytes"] * 2 == \
            sum(e["bytes"] for e in bcasts)
        # bf16 on the wire for these float64 words: a quarter
        assert fams["broadcast"]["raw_bytes"] == \
            4 * fams["broadcast"]["volume_bytes"]
        assert set(tsqr_rep.analytic) == {"all_gather", "psum"}
        for rep in reports:
            assert rep.measured is not None, rep.measured_unavailable
            assert set(rep.measured) <= set(rep.analytic)
            for family, row in rep.measured.items():  # one per collective
                assert row["launches"] == rep.analytic[family]["launches"]
            assert rep.dhqr306["status"] == "skip"
            assert "gloo" in rep.dhqr306["reason"]
            assert rep.dhqr306_pass and rep.ici_gbps is None
            assert rep.wall_s > 0
        stats = rank[4][1]
        assert stats["captures"] == 2 and stats["reports"] == 2


def test_armed_and_disarmed_dispatches_are_the_plain_one(two):
    for rank in two:
        measured, warm, plain = rank[0][1], rank[1][1], rank[5][1]
        for a, w, p in zip(measured, warm, plain):
            np.testing.assert_array_equal(a, p)
            np.testing.assert_array_equal(w, p)
    np.testing.assert_array_equal(two[0][5][1][0], two[1][5][1][0])
