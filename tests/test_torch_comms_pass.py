"""PyTorch port: the comms audit and its cost model (ROADMAP item 18b).

* ``analysis/cost_model.py`` is the port's own copy: every function returns
  exactly the JAX module's integer over a grid of (m, n, nb, P, nrhs),
  wire formats and topologies, and its literal copies of the wire
  vocabulary equal the port's ``precision`` / ``parallel.wire`` values;
* ``comms_contracts.json`` holds the JAX file's rows (same row set, models,
  slack, factors and rungs), its families in the port's c10d names
  through ``family_map``;
* the registry's comms hooks name the JAX registry's routes;
* the census side by side with the JAX pass's ``collect_comms`` on the same
  shapes, for every comms route at P in {2, 4}: launches and bytes per
  mapped family equal, except where the contract row says why they
  differ (``launches_differ`` / ``bytes_differ``), and both under the
  shared budget x slack. One spawn of P gloo ranks per P runs every route
  (module fixture); the JAX side runs on the conftest's virtual CPU
  devices;
* planted faults beside the JAX pass: a contract row missing a family
  (DHQR301) and a donated route that clones (DHQR304);
* the order audit reads the logged issue order (0 for the default
  schedule, 1 for the lookahead).
"""

import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dhqr_tpu.analysis import comms_pass as jcp  # noqa: E402
from dhqr_tpu.analysis import cost_model as jcm  # noqa: E402
from dhqr_tpu.precision import PRECISION_POLICIES as JPOL  # noqa: E402
from dhqr_tpu.tune import registry as jreg  # noqa: E402
from dhqr_tpu_torch.analysis import comms_pass, cost_model, oplog  # noqa: E402
from dhqr_tpu_torch.tune import registry as treg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_CENSUS = (2, 4)


@pytest.fixture
def jax_walk(monkeypatch):
    import jax.core
    import jax.extend.core

    for name in ("ClosedJaxpr", "Jaxpr"):
        monkeypatch.setattr(jax.core, name,
                            getattr(jax.extend.core, name), raising=False)


def _rules(findings):
    return sorted({f.rule for f in findings if not f.suppressed})


# -- the cost model ------------------------------------------------------------

GRID = list(itertools.product((32, 64, 256), (8, 16, 32), (4, 8),
                              (2, 4, 8), (1, 3)))


@pytest.mark.parametrize("name", sorted(jcm.MODELS))
def test_word_models_equal_the_jax_module(name):
    for m, n, nb, P, nrhs in GRID:
        assert cost_model.MODELS[name](m, n, nb, P, nrhs=nrhs) == \
            jcm.MODELS[name](m, n, nb, P, nrhs=nrhs)


@pytest.mark.parametrize("comms", [None, "bf16", "int8", "dcn:bf16",
                                   "dcn:int8"])
def test_budgets_equal_the_jax_module(comms):
    for name in sorted(jcm.MODELS):
        for m, n, nb, P, nrhs in GRID:
            assert cost_model.budget_bytes(name, m, n, nb, P, 4, nrhs=nrhs,
                                           comms=comms) == \
                jcm.budget_bytes(name, m, n, nb, P, 4, nrhs=nrhs,
                                 comms=comms)
            assert cost_model.payload_schedule(name, m, n, nb, P, nrhs) \
                == jcm.payload_schedule(name, m, n, nb, P, nrhs)
            for topo in (None, (2, P // 2), (1, P)):
                for hier in (True, False):
                    assert cost_model.tiered_budget_bytes(
                        name, m, n, nb, P, 4, nrhs=nrhs, comms=comms,
                        topology=topo, hierarchical=hier) == \
                        jcm.tiered_budget_bytes(
                            name, m, n, nb, P, 4, nrhs=nrhs, comms=comms,
                            topology=topo, hierarchical=hier)


def test_cost_model_vocabulary_is_the_ports():
    from dhqr_tpu_torch import precision
    from dhqr_tpu_torch.parallel import wire

    assert cost_model.WIRE_ITEMSIZE == jcm.WIRE_ITEMSIZE == {
        k: v for k, v in precision.WIRE_ITEMSIZE.items() if k}
    assert cost_model.DCN_TIERED == jcm.DCN_TIERED == wire._DCN_TIERED
    assert cost_model.CSNE_SWEEPS == jcm.CSNE_SWEEPS == wire.CSNE_SWEEPS
    with pytest.raises(KeyError, match="warp"):
        cost_model.budget_bytes("warp", 8, 8, 4, 2, 4)


# -- the contracts and the registry's comms hooks -------------------------------

def test_contract_rows_are_the_jax_rows():
    mine = comms_pass.load_contracts()
    theirs = jcp.load_contracts()
    assert set(mine) == set(theirs)
    fmap = comms_pass.family_map()
    for key, row in mine.items():
        j = theirs[key]
        for field in ("model", "slack", "replicated_factor", "comms",
                      "hierarchical", "dcn_slack"):
            assert row.get(field) == j.get(field), (key, field)
        assert row["jax_collectives"] == j["collectives"], key
        mapped = {f for prim in j["collectives"] for f in fmap[prim]}
        assert set(row["collectives"]) <= mapped, key
    assert treg.contract_names() == jreg.contract_names() == set(mine)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("sweep", [True, False])
def test_comms_routes_are_the_jax_registrys(P, sweep):
    mine = treg.comms_routes(P, sweep)
    theirs = jreg.comms_routes(P, sweep)
    assert [r.name for r in mine] == [r.name for r in theirs]
    for r, j in zip(mine, theirs):
        assert r.contract == j.contract
        assert {k: v for k, v in r.comms_trace.items() if k != "policy"} \
            == {k: v for k, v in j.comms_trace.items() if k != "policy"}


def test_serve_and_donated_routes_are_the_jax_registrys():
    assert [r.name for r in treg.serve_routes()] == \
        [r.name for r in jreg.serve_routes()]
    assert [r.name for r in treg.donated_routes()] == \
        [r.name for r in jreg.donated_routes()]
    for r in treg.serve_routes():
        j = jreg.route(r.name)
        assert r.serve["kind"] == j.serve["kind"]
        assert [sorted(c) for c in r.serve["cells"]] == \
            [sorted(c) for c in j.serve["cells"]]


# -- the census, side by side with the JAX pass ---------------------------------

@pytest.fixture(scope="module")
def census():
    """{P: (per-rank rows of one spawn of P gloo ranks, {label: row
    index})}: every comms route of both halves at the accurate preset."""
    out = {}
    for P in P_CENSUS:
        ranks = comms_pass.census(P, presets=("accurate",), device="cpu")
        out[P] = (ranks, {row["label"]: i for i, row in enumerate(ranks[0])})
    return out


def _jax_stats(P, label):
    pol = JPOL["accurate"]
    for sweep in (True, False):
        for engine, lab, thunk, params in jcp._engine_specs(
                P, "accurate", pol, sweep_presets=sweep):
            if lab == label:
                closed = thunk()
                return jcp.collect_comms(closed), params, closed
    raise KeyError(label)


def _cases():
    out = []
    for P in P_CENSUS:
        for sweep in (True, False):
            tag = f"[P={P},accurate]" if sweep else f"[P={P}]"
            for r in jreg.comms_routes(P, sweep):
                name = r.comms_trace.get("label", r.name)
                out.append((P, f"comms::{name}{tag}"))
    return out


@pytest.mark.parametrize("P,label", _cases())
def test_census_beside_the_jax_census(census, jax_walk, P, label):
    ranks, index = census[P]
    i = index[label]
    row = ranks[0][i]
    assert row["error"] is None and not any(r[i]["foreign"] for r in ranks)
    mine = comms_pass.merge_ranks([r[i]["stats"] for r in ranks])
    theirs, jparams, _ = _jax_stats(P, label)
    contract = comms_pass.load_contracts()[row["engine"]]
    fmap = comms_pass.family_map()
    assert row["params"] == comms_pass.EngineParams(**vars(jparams))
    port_launches = {prim: sum(mine.launches().get(f, 0) for f in fams)
                     for prim, fams in fmap.items()}
    jax_launches = {prim: theirs.launches().get(prim, 0) for prim in fmap}
    if "launches_differ" in contract:
        assert sum(port_launches.values()) < sum(jax_launches.values())
    else:
        assert port_launches == jax_launches
    if "bytes_differ" in contract:
        assert mine.total_volume_bytes() < theirs.total_volume_bytes()
    else:
        assert mine.total_volume_bytes() == theirs.total_volume_bytes()
        assert mine.dcn_volume_bytes() == theirs.dcn_volume_bytes()
    assert comms_pass.check_comms(mine, label, contract, row["params"]) \
        == []
    p = row["params"]
    if p.topology is None:
        budget = cost_model.budget_bytes(contract["model"], p.m, p.n, p.nb,
                                         P, 4, comms=contract.get("comms"))
    else:
        budget = cost_model.tiered_budget_bytes(
            contract["model"], p.m, p.n, p.nb, P, 4,
            comms=contract.get("comms"), topology=p.topology)["total"]
    slack = contract.get("slack", 1.5)
    assert mine.total_volume_bytes() <= budget * slack
    assert theirs.total_volume_bytes() <= budget * slack


def test_census_is_green_against_the_contracts(census):
    from dhqr_tpu_torch.analysis.findings import apply_graph_suppressions

    for P in P_CENSUS:
        found = apply_graph_suppressions(comms_pass.check_census(
            census[P][0], comms_pass.load_contracts()))
        assert _rules(found) == [], [f.render() for f in found]


def test_logged_issue_order(census):
    ranks, index = census[2]
    for label, depth in (("comms::blocked_qr[P=2,accurate]", 0),
                         ("comms::blocked_qr_lookahead[P=2,accurate]", 1)):
        seen = [comms_pass.overlap_distance(r[index[label]]["order"], 4)
                for r in ranks]
        assert min(d for d in seen if d is not None) == depth, (label, seen)


def test_overlap_distance_reads_a_depth_two_ring():
    b = oplog.OpEvent("collective", "c10d.broadcast_.default",
                      family="broadcast_")
    w = oplog.OpEvent("op", "aten.addmm_.default", out_shapes=((32, 8),))
    log = oplog.OpLog()
    for e in (b, b, b, w, w, b, w):
        log.add(e)
    assert comms_pass.issue_order(log, 4) == [
        "broadcast", "broadcast", "broadcast", "wide_dot", "wide_dot",
        "broadcast", "wide_dot"]
    assert comms_pass.overlap_distance(log, 4) == 2


# -- planted faults, beside the JAX pass ----------------------------------------

def test_contract_missing_a_family_is_dhqr301(census, jax_walk):
    ranks, index = census[2]
    i = index["comms::blocked_qr[P=2,accurate]"]
    mine = comms_pass.merge_ranks([r[i]["stats"] for r in ranks])
    row = dict(comms_pass.load_contracts()["blocked_qr"], collectives=[])
    found = comms_pass.check_comms(mine, "planted", row, ranks[0][i]["params"])
    assert [(f.rule, f.snippet) for f in found] == [("DHQR301",
                                                     "broadcast_")]
    _, jparams, closed = _jax_stats(2, "comms::blocked_qr[P=2,accurate]")
    jrow = dict(jcp.load_contracts()["blocked_qr"], collectives=[])
    assert [(f.rule, f.snippet) for f in jcp.check_comms(
        closed, "planted", jrow, jparams)] == [("DHQR301", "psum")]


def test_donated_route_that_clones_is_dhqr304():
    import jax
    import jax.numpy as jnp

    from dhqr_tpu.ops.blocked import _blocked_qr_impl as jimpl
    from dhqr_tpu_torch.ops.blocked import _blocked_qr_impl

    assert comms_pass.check_donation(device="cpu") == []
    A = torch.as_tensor(np.random.default_rng(2).standard_normal((16, 8)),
                        dtype=torch.float32)
    found = comms_pass.check_donation([
        ("planted/clones", lambda A, nb: _blocked_qr_impl(A.clone(), nb),
         (A, 4))])
    assert [f.rule for f in found] == ["DHQR304"]
    assert "storage" in found[0].message and "clone" in found[0].message
    assert [f.rule for f in jcp.check_donation([
        ("planted/no-donate", jimpl,
         (jax.ShapeDtypeStruct((16, 8), jnp.float32), 4))])] == ["DHQR304"]


def test_contracts_file_documents_its_map():
    with open(comms_pass.CONTRACTS_PATH, encoding="utf-8") as fh:
        data = json.load(fh)
    assert data["family_map"] == {"psum": ["allreduce_", "broadcast_"],
                                  "all_gather": ["allgather_"]}
    for key, row in data["engines"].items():
        for note in ("launches_differ", "bytes_differ"):
            assert row.get(note, "x"), (key, note)
