"""PyTorch port: the two-tier topology — ``TierAxes``, ``parse_topo``,
``detect_topology``, the axis helpers, ``pod_mesh`` / ``global_pod_mesh``
on gloo ranks, the platform table's interconnect rows and the two-tier
DHQR306 bound (the JAX checks of ``tests/test_topology.py``, the port's
spelling) — and the factors on 2x2 (hierarchical and flat), 1x4 and 4x1
pod meshes of 4 gloo CPU ranks against the JAX package's ``pod_mesh``
twin on the conftest's 8-device CPU mesh.

Tolerances, float64, relative to the largest entry: 1e-9 uncompressed,
2^-6 under ``dcn:bf16``, 4/127 under ``dcn:int8``. One spawn per rank
count (4, and 1 for the one-rank mesh).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.parallel import sharded_qr as jsq  # noqa: E402
from dhqr_tpu.parallel import topology as jtopo  # noqa: E402
from dhqr_tpu.parallel.mesh import pod_mesh as jax_pod_mesh  # noqa: E402
from dhqr_tpu.parallel.sharded_cholqr import sharded_cholqr_lstsq  # noqa: E402,E501
from dhqr_tpu.parallel.sharded_tsqr import sharded_tsqr_lstsq  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu_torch.obs.netmodel import explain_measured, wire_bytes  # noqa: E402,E501
from dhqr_tpu_torch.parallel import topology as topo  # noqa: E402
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    ROWS,
    pod,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)
from dhqr_tpu_torch.parallel.mesh import PodMesh  # noqa: E402
from dhqr_tpu_torch.parallel.topology import TierAxes  # noqa: E402
from dhqr_tpu_torch.utils import platform as plat  # noqa: E402

NB = 4
A, b = random_problem(32, 24, np.float64, seed=91)
TALL, TALL_B = random_problem(64, 8, np.float64, seed=92)
TOPOS = {"2x2": (2, 2, True), "2x2f": (2, 2, False), "1x4": (1, 4, True),
         "4x1": (4, 1, True)}
COMMS = (None, "dcn:bf16")
TOL = {None: 1e-9, "dcn:bf16": 2.0 ** -6, "dcn:int8": 4 / 127}


def _fake_pod(dcn, ici):
    return PodMesh(None, torch.device("cpu"), "cols", dcn, ici)


def _fake_1d(name="cols", size=4):
    return types.SimpleNamespace(axis_names=(name,), shape={name: size})


# ---------------------------------------------------------------- TierAxes

def test_tier_axes_fields_labels_and_hash_match_jax():
    t = TierAxes(dcn_size=2, ici_size=4)
    jt = jtopo.TierAxes(dcn_size=2, ici_size=4)
    assert dataclasses.asdict(t) == dataclasses.asdict(jt)
    assert t.size == jt.size == 8
    assert t.label() == jt.label() == "2x4"
    flat = dataclasses.replace(t, hierarchical=False)
    assert flat.label() == "2x4f" and t != flat
    assert len({t, flat, TierAxes(dcn_size=2, ici_size=4)}) == 2
    assert topo.DCN_AXIS == jtopo.DCN_AXIS
    assert topo.ICI_AXIS == jtopo.ICI_AXIS


def test_tier_axes_validation():
    with pytest.raises(ValueError, match="tier sizes"):
        TierAxes(dcn_size=0, ici_size=4)
    with pytest.raises(ValueError, match="distinct"):
        TierAxes(dcn="ici", ici="ici")


@pytest.mark.parametrize("spec", ["2x4", " 1X8 ", None, "", "2x", "x4",
                                  "2x4x2", "ax4", "0x8", "2-4"])
def test_parse_topo_matches_jax(spec):
    try:
        want = ("ok", jtopo.parse_topo(spec))
    except ValueError as e:
        want = ("raised", str(e))
    try:
        got = ("ok", topo.parse_topo(spec))
    except ValueError as e:
        got = ("raised", str(e))
    assert got == want


def test_detect_topology_env_override(monkeypatch):
    hosts = ["h0"] * 8
    monkeypatch.setenv("DHQR_TOPO", "2x4")
    assert topo.detect_topology(hosts) == (2, 4)
    monkeypatch.setenv("DHQR_TOPO", "1x8")
    assert topo.detect_topology(hosts) is None
    monkeypatch.setenv("DHQR_TOPO", "3x2")
    with pytest.raises(ValueError, match="does not factor"):
        topo.detect_topology(hosts)


def test_detect_topology_groups_ranks_by_host(monkeypatch):
    monkeypatch.delenv("DHQR_TOPO", raising=False)
    assert topo.detect_topology(["a"] * 4) is None          # one host: flat
    assert topo.detect_topology(["a", "a", "b", "b"]) == (2, 2)
    assert topo.detect_topology(["a", "b", "c", "d"]) == (4, 1)
    assert topo.detect_topology(["a", "a", "a", "b"]) is None  # ragged
    assert topo.detect_topology(["a", "a", "b", "b", "c"], 4) == (2, 2)


# ------------------------------------------------------------- resolution

def test_resolve_axis_on_1d_and_pod_meshes():
    cmesh = _fake_1d()
    assert topo.resolve_axis(cmesh, "cols") == "cols"
    with pytest.raises(KeyError, match="not in mesh axes"):
        topo.resolve_axis(cmesh, "rows")
    pmesh, taxes = _fake_pod(2, 4), TierAxes(dcn_size=2, ici_size=4)
    resolved = topo.resolve_axis(pmesh, "cols")
    assert resolved == taxes and resolved.hierarchical
    assert topo.resolve_axis(pmesh, taxes) is taxes
    with pytest.raises(ValueError, match="does not match mesh"):
        topo.resolve_axis(pmesh, TierAxes(dcn_size=4, ici_size=2))
    with pytest.raises(ValueError, match="do not carry tier axis"):
        topo.resolve_axis(cmesh, taxes)


def test_axis_size_spec_axes_axis_label():
    taxes = TierAxes(dcn_size=2, ici_size=4)
    assert topo.axis_size(_fake_pod(2, 4), taxes) == 8
    assert topo.axis_size(_fake_1d(), "cols") == 4
    assert topo.spec_axes(taxes) == jtopo.spec_axes(
        jtopo.TierAxes(dcn_size=2, ici_size=4)) == ("dcn", "ici")
    assert topo.spec_axes("cols") == "cols"
    assert topo.axis_label("cols", 4) == "4"
    assert topo.axis_label(taxes, 8) == "2x4"
    assert topo.axis_label(dataclasses.replace(taxes, hierarchical=False),
                           8) == "2x4f"


def test_pod_mesh_one_device_degenerate_resolves():
    pmesh = _fake_pod(1, 1)
    assert dict(pmesh.shape) == {"dcn": 1, "ici": 1}
    assert isinstance(topo.resolve_axis(pmesh, "cols"), TierAxes)
    assert topo.axis_size(pmesh, TierAxes()) == 1


# ------------------------------------------- platform and the DHQR306 bound

def test_platform_interconnect_rows():
    assert plat.device_dcn_gbps("cpu") is None
    assert plat.device_ici_gbps("cpu") is None
    assert plat.device_dcn_gbps("definitely-not-a-card") is None
    assert plat.device_ici_gbps("definitely-not-a-card") is None
    h100 = "NVIDIA H100 80GB HBM3"
    assert plat.device_ici_gbps(h100) == 900.0
    assert plat.device_hbm_gbps(h100) == 3350.0
    assert plat.device_peak_tflops(h100) == 989.0
    assert plat.device_dcn_gbps(h100) is None  # the datasheet gives none
    assert "datasheet" in plat._DEVICE_PEAKS[h100]["dcn_reason"]
    assert not any(k.startswith("TPU") for k in plat._DEVICE_PEAKS)


def test_explain_measured_dcn_share_without_bandwidth_skips():
    out = explain_measured("psum", measured_s=1e-3, volume_bytes=1 << 20,
                           P=8, link_gbps=300.0, slack=8.0,
                           dcn_volume_bytes=1 << 18, dcn_gbps=None)
    assert out["status"] == "skip"
    assert "device_dcn_gbps" in out["reason"]
    assert out["dcn_volume_bytes"] == 1 << 18


def test_explain_measured_two_tier_bound_sums_tiers():
    vol, dcn_share = float(1 << 20), float(1 << 18)
    out = explain_measured("psum", measured_s=1e-6, volume_bytes=vol,
                           P=8, link_gbps=300.0, slack=8.0,
                           dcn_volume_bytes=dcn_share, dcn_gbps=25.0)
    expect = (wire_bytes("psum", vol - dcn_share, 8) / (300.0 * 1e9)
              + wire_bytes("psum", dcn_share, 8) / (25.0 * 1e9))
    assert out["status"] == "ok"
    assert out["bound_s"] == pytest.approx(expect, abs=1e-6)
    assert out["dcn_gbps"] == 25.0
    flat = explain_measured("psum", measured_s=1e-6, volume_bytes=vol,
                            P=8, link_gbps=300.0, slack=8.0)
    assert flat["bound_s"] == pytest.approx(
        wire_bytes("psum", vol, 8) / (300.0 * 1e9), abs=1e-6)


# ----------------------------------------------------- on four gloo ranks

def _cases():
    cases = {
        "pod_2x2": [("pod_mesh", (), dict(topo="2x2", device="cpu"))],
        "pod_hosts": [("pod_mesh", (), dict(devices=["a", "a", "b", "b"],
                                            device="cpu"))],
        "pod_flat": [("pod_mesh", (), dict(device="cpu"))],
        "pod_4_ranks": [("pod_mesh", (4,), dict(topo=(4, 1), device="cpu"))],
        "global_pod": [("global_pod_mesh", (), dict(topo=(2, 2),
                                                    device="cpu"))],
        "bad_factor": [("pod_mesh", (), dict(topo="3x2", device="cpu"))],
        "bad_count": [("pod_mesh", (10 ** 6,), dict(device="cpu"))],
        "axis_index": [("parallel.topology.axis_index",
                        (pod("2x2"), TierAxes(dcn_size=2, ici_size=2)), {})],
    }
    for name, (dcn, ici, hier) in TOPOS.items():
        axis = TierAxes(dcn_size=dcn, ici_size=ici, hierarchical=hier)
        for comms in COMMS:
            cases[f"qr_{name}_{comms}"] = {
                "steps": [("sharded_blocked_qr", (A, pod(f"{dcn}x{ici}")),
                           dict(block_size=NB, axis_name=axis,
                                comms=comms))],
                "census": True}
    cases["default_axis_2x2"] = [("sharded_blocked_qr", (A, pod("2x2")),
                                  dict(block_size=NB))]
    cases["solve_2x2"] = [("qr", (A,), dict(mesh=pod("2x2"), block_size=NB,
                                            comms="dcn:bf16")),
                          (".solve", (b,), {})]
    cases["tsqr_2x2"] = [("lstsq", (TALL, TALL_B), dict(
        mesh=pod("2x2"), engine="tsqr", block_size=NB))]
    cases["tsqr_2x2_dcn_int8"] = [("sharded_tsqr_lstsq", (
        TALL, TALL_B, pod("2x2")), dict(block_size=NB, comms="dcn:int8"))]
    cases["cholqr_2x2"] = [("sharded_cholqr_lstsq", (TALL, TALL_B,
                                                     pod("2x2")), {})]
    cases["tsqr_rows"] = [("sharded_tsqr_lstsq", (TALL, TALL_B, ROWS),
                           dict(block_size=NB))]
    return cases


CASES = _cases()


@pytest.fixture(scope="module")
def four():
    per_rank = run_ranks(run_calls, 4, device="cpu", timeout_s=240,
                         cases=list(CASES.values()))
    return [dict(zip(CASES, r)) for r in per_rank]


def _ok(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[1]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_pod_mesh_axis_naming_and_rank_order(four):
    for r, got in enumerate(four):
        mesh, taxes = _ok(got["pod_2x2"])
        assert mesh["axis_names"] == ("dcn", "ici")
        assert mesh["shape"] == {"dcn": 2, "ici": 2}
        assert (taxes.dcn_size, taxes.ici_size, taxes.hierarchical) == \
            (2, 2, True)
        # rank (d, i) is flat rank d * ici_size + i (column_mesh's order)
        d, i = divmod(r, 2)
        assert mesh["rank"] == r and mesh["ranks"] == [0, 1, 2, 3]
        assert mesh["ici_ranks"] == [2 * d, 2 * d + 1]
        assert mesh["dcn_ranks"] == [i, 2 + i]
        assert _ok(got["pod_hosts"])[1] == taxes
        assert _ok(got["global_pod"])[1] == taxes
        assert _ok(got["axis_index"]) == r
        flat_mesh, flat = _ok(got["pod_flat"])  # one host: 1 x P
        assert (flat.dcn_size, flat.ici_size) == (1, 4)
        assert flat_mesh["ici_ranks"] == [0, 1, 2, 3]
        assert _ok(got["pod_4_ranks"])[1] == TierAxes(dcn_size=4,
                                                      ici_size=1)


def test_pod_mesh_validation(four):
    for got in four:
        assert got["bad_factor"][:2] == ("raised", "ValueError")
        assert "does not factor" in got["bad_factor"][2]
        assert got["bad_count"][:2] == ("raised", "ValueError")
        assert "only" in got["bad_count"][2]


def test_pod_results_are_identical_across_ranks(four):
    assert results_equal_across_ranks(
        [[o[:2] for name, o in sorted(r.items())
          if name.startswith(("qr_", "solve", "tsqr", "cholqr"))]
         for r in four])


@pytest.mark.parametrize("comms", COMMS)
@pytest.mark.parametrize("name", sorted(TOPOS))
def test_pod_factors_match_jax_pod_mesh(four, name, comms):
    dcn, ici, hier = TOPOS[name]
    pmesh, taxes = jax_pod_mesh(4, topo=(dcn, ici))
    axis = dataclasses.replace(taxes, hierarchical=hier)
    H_j, alpha_j = jsq.sharded_blocked_qr(jnp.asarray(A), pmesh,
                                          block_size=NB, axis_name=axis,
                                          comms=comms)
    H, alpha = _ok(four[0][f"qr_{name}_{comms}"])
    assert _rel(H, H_j) <= TOL[comms] and _rel(alpha, alpha_j) <= TOL[comms]
    if comms is None:  # every schedule gives the 1-D factors, to roundoff
        H1, _ = _ok(four[0]["default_axis_2x2"])
        assert _rel(H, H1) <= 1e-12


def test_census_dcn_leg_is_half_the_flat_payload(four):
    """Each member of a host carries 1/ici_size of the rows across the
    hosts: the hierarchical 2x2 schedule's cross-host bytes are half the
    flat schedule's payload, plus at most one padding row per part; under
    dcn:bf16 a quarter of that (2-byte words for these 8-byte ones)."""
    def legs(name):
        entries = four[0][name][2]
        return ({leg: sum(e["bytes"] for e in entries
                          if e["leg"] == leg and e["family"] == "broadcast")
                 for leg in ("flat", "ici", "dcn")},
                [e for e in entries if e["family"] == "broadcast"])

    flat, flat_entries = legs("qr_2x2f_None")
    hier, hier_entries = legs("qr_2x2_None")
    assert hier["flat"] == 0 and flat["dcn"] == 0
    pad = sum(8 * e["shapes"][0][1] + 8 for e in flat_entries)
    assert flat["flat"] / 2 <= hier["dcn"] <= flat["flat"] / 2 + pad
    assert all(e["crosses_dcn"] for e in flat_entries)
    assert all(e["crosses_dcn"] == (e["leg"] == "dcn") for e in hier_entries)
    bf16, _ = legs("qr_2x2_dcn:bf16")
    assert bf16["dcn"] == hier["dcn"] / 4
    assert bf16["ici"] == hier["ici"]  # exact inside the host


def test_pod_solves_and_row_engines_match_jax(four):
    from dhqr_tpu import lstsq as jax_lstsq_model
    from dhqr_tpu import qr as jax_qr

    pmesh, _ = jax_pod_mesh(4, topo=(2, 2))
    got = four[0]
    f_j = jax_qr(jnp.asarray(A), mesh=pmesh, block_size=NB, comms="dcn:bf16")
    x_j = f_j.solve(jnp.asarray(b))
    assert _rel(_ok(got["solve_2x2"]), x_j) <= 2.0 ** -6
    xt_j = jax_lstsq_model(jnp.asarray(TALL), jnp.asarray(TALL_B),
                           mesh=pmesh, engine="tsqr", block_size=NB)
    assert _rel(_ok(got["tsqr_2x2"]), xt_j) <= 1e-9
    assert _rel(_ok(got["tsqr_2x2"]), _ok(got["tsqr_rows"])) <= 1e-12
    xi_j = sharded_tsqr_lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B), pmesh,
                              block_size=NB, comms="dcn:int8")
    assert _rel(_ok(got["tsqr_2x2_dcn_int8"]), xi_j) <= 4 / 127
    xc_j = sharded_cholqr_lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                pmesh)
    assert _rel(_ok(got["cholqr_2x2"]), xc_j) <= 1e-9


def test_one_rank_pod_mesh_is_degenerate():
    (got,) = run_ranks(run_calls, 1, device="cpu", timeout_s=120, cases=[
        [("pod_mesh", (1,), dict(device="cpu"))],
        [("sharded_blocked_qr", (A, pod("1x1")), dict(block_size=NB))]])
    mesh, taxes = _ok(got[0])
    assert mesh["shape"] == {"dcn": 1, "ici": 1}
    assert (taxes.dcn_size, taxes.ici_size) == (1, 1)
    H_j, _ = jsq.sharded_blocked_qr(jnp.asarray(A), jax_pod_mesh(1)[0],
                                    block_size=NB)
    assert _rel(_ok(got[1])[0], H_j) <= 1e-9


def test_exports_match_jax():
    import dhqr_tpu

    for name in ("TierAxes", "pod_mesh", "global_pod_mesh", "PulseReport"):
        assert name in dt.__all__ and name in dhqr_tpu.__all__, name
    assert dt.TierAxes is TierAxes and dt.parallel.TierAxes is TierAxes
    assert dt.pod_mesh is dt.parallel.pod_mesh
    assert dt.global_pod_mesh is dt.parallel.global_pod_mesh
