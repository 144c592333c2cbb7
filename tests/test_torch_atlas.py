"""PyTorch port: the atlas, the xray and pulse smokes, and the CLI with
every pass (ROADMAP item 18b).

* The five graph passes carry the JAX package's rule IDs
  (``jaxpr_pass``, ``comms_pass``, ``xray_smoke``, ``pulse_smoke``,
  ``atlas``), and the CLI's catalogue assembles every pass's rows.
* The atlas is green on the committed tree, with the registry's
  self-check, the contract bijection and the route lookup; its probe grids
  are the JAX package's with the port's platform tags.
* Planted drifts, each flagged by its exact rule beside the JAX atlas
  flagging the same drift: a route whose trace spec names no builder
  (DHQR501), a dead and a missing contract row (DHQR502), a serve key
  minted without ``panel_impl`` (DHQR503: its collided cells run
  different programs), a donation probe drift (DHQR504), a grid candidate
  outside the registry (DHQR505).
* The smokes on the CPU: no finding, and the card-only numbers (MFU,
  roofline, the measured census) null with their reasons.
* The whole slice: ``python -m dhqr_tpu_torch.analysis check`` with every
  pass exits 0 on the CPU (one preset, 2 ranks; the full preset x
  {2, 4, 8} matrix is under ``-m slow``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from dhqr_tpu.analysis import atlas as jatlas  # noqa: E402
from dhqr_tpu.tune import registry as jreg  # noqa: E402
from dhqr_tpu_torch.analysis import (  # noqa: E402
    atlas,
    cli,
    comms_pass,
    pulse_smoke,
    xray_smoke,
)
from dhqr_tpu_torch.tune import registry  # noqa: E402


def _rules(findings):
    return sorted({f.rule for f in findings if not f.suppressed})


@pytest.mark.parametrize("module", ["jaxpr_pass", "comms_pass", "atlas",
                                    "pulse_smoke", "xray_smoke"])
def test_rule_ids_are_the_jax_packages(module):
    import importlib

    mine = importlib.import_module(f"dhqr_tpu_torch.analysis.{module}")
    theirs = importlib.import_module(f"dhqr_tpu.analysis.{module}")
    assert [r[0] for r in mine.RULES] == [r[0] for r in theirs.RULES]
    assert [r[2] for r in mine.RULES] == [r[2] for r in theirs.RULES]


def test_catalogue_has_every_pass():
    from dhqr_tpu.analysis.cli import rule_catalogue as jcatalogue

    mine = {r[0] for r in cli.rule_catalogue()}
    assert mine == {r[0] for r in jcatalogue()}


# -- the committed tree ---------------------------------------------------------

def test_registry_self_check_and_lookup():
    assert registry.self_check() == []
    r = registry.route("blocked_qr_wire_bf16")
    assert r.comms == "bf16" and r.contract == "blocked_qr_wire_bf16"
    with pytest.raises(KeyError):
        registry.route("no_such_route")
    for r in registry.routes():
        assert r.jaxpr or r.comms_trace or r.serve or r.donation, r.name


def test_probe_grids_are_the_jax_packages():
    tags = {"tpu": "torch-cuda", "cpu": "torch-cpu"}
    assert atlas.GRID_PROBES == tuple(
        p[:5] + (tags[p[5]],) for p in jatlas.GRID_PROBES)
    assert atlas.SERVE_PROBE_SHAPES == jatlas.SERVE_PROBE_SHAPES


def test_atlas_green_on_committed_tree():
    stats: dict = {}
    assert atlas.run_atlas_pass(device="cpu", stats=stats) == []
    assert stats["collided_groups_run"] >= 1 and stats["events_compared"]


# -- planted drifts, beside the JAX atlas ---------------------------------------

def test_dhqr501_route_with_no_run_spec_mechanism():
    ghost = dataclasses.replace(
        registry.route("householder_single"), name="ghost",
        jaxpr=({"label": "ghost[{preset}]", "builder": "ghost_builder",
                "axes": ()},))
    routes = registry.routes() + (ghost,)
    found = atlas.check_route_coverage(routes=routes)
    assert _rules(found) == ["DHQR501"]
    assert {f.snippet for f in found} == {"ghost:jaxpr:ghost_builder"}
    jghost = dataclasses.replace(jreg.route("householder_single"),
                                 name="ghost", jaxpr=ghost.jaxpr)
    jfound = jatlas.check_route_coverage(
        routes=jreg.routes() + (jghost,),
        jaxpr_builders={s["builder"] for r in jreg.routes()
                        for s in r.jaxpr},
        comms_builders={r.comms_trace["builder"] for r in jreg.routes()
                        if r.comms_trace})
    assert {f.snippet for f in jfound} == {"ghost:jaxpr:ghost_builder"}
    # the labels the pass logs, two-way against the registry
    runs_labels = atlas.expected_jaxpr_labels(devices=1) - {"qr[accurate]"}
    found = atlas.check_route_coverage(traced_labels=runs_labels
                                       | {"rogue[accurate]"})
    assert {f.snippet for f in found} == {"untraced:qr[accurate]",
                                          "unregistered:rogue[accurate]"}


def test_dhqr502_dead_and_missing_rows():
    contracts = dict(comms_pass.load_contracts())
    contracts["ghost_engine"] = {"collectives": [], "model": "none",
                                 "slack": 1.0, "replicated_factor": 2.0}
    contracts.pop("blocked_qr")
    found = atlas.check_contract_pricing(contracts=contracts)
    assert _rules(found) == ["DHQR502"]
    assert {f.snippet for f in found} == {"dead-row:ghost_engine",
                                          "missing-row:blocked_qr"}
    row = dict(comms_pass.load_contracts()["blocked_qr"], model="warp",
               collectives=["broadcast_", "pteleport"])
    found = atlas.check_contract_pricing(
        contracts={**comms_pass.load_contracts(), "blocked_qr": row})
    assert {f.snippet for f in found} == {"model:blocked_qr",
                                          "collectives:blocked_qr"}
    assert atlas.check_contract_pricing() == []


def test_dhqr503_dropping_panel_impl_from_the_key():
    from dhqr_tpu.serve.engine import _plan_key as jplan_key
    from dhqr_tpu_torch.serve.engine import _plan_key

    def dropped(kind, count, m, n, dtype, cfg, scfg):
        key, bucket = _plan_key(kind, count, m, n, dtype, cfg, scfg)
        return key._replace(panel_impl="loop"), bucket

    def jdropped(kind, count, m, n, dtype, cfg, scfg):
        key, bucket = jplan_key(kind, count, m, n, dtype, cfg, scfg)
        return key._replace(panel_impl="loop"), bucket

    want = {"servekey:batched_lstsq,batched_lstsq_recursive",
            "servekey:batched_qr,batched_qr_recursive"}
    found = atlas.check_cache_keys(key_fn=dropped, device="cpu")
    assert _rules(found) == ["DHQR503"]
    assert {f.snippet for f in found} == want
    jfound = jatlas.check_cache_keys(key_fn=jdropped)
    assert {f.snippet for f in jfound} == want


def test_dhqr504_donation_drift_both_ways():
    found = atlas.check_donation_routes(
        entries=["ops/blocked.blocked_householder_qr[donate]",
                 "ops/rogue._mystery"])
    assert _rules(found) == ["DHQR504"]
    assert {f.snippet for f in found} == {
        "unprobed:ops/blocked._batched_qr_impl",
        "unregistered:ops/rogue._mystery"}
    assert atlas.check_donation_routes() == []


def test_dhqr505_grid_candidate_outside_the_registry():
    routes = tuple(r for r in registry.routes()
                   if r.name != "sketched_lstsq")
    found = atlas.check_grid_drift(routes=routes)
    assert _rules(found) == ["DHQR505"]
    assert any("sketch" in f.snippet for f in found)
    jroutes = tuple(r for r in jreg.routes() if r.name != "sketched_lstsq")
    assert {f.snippet.split(":")[1] for f in
            jatlas.check_grid_drift(routes=jroutes)} == \
        {f.snippet.split(":")[1] for f in found}


# -- the smokes -----------------------------------------------------------------

def test_xray_smoke_on_the_cpu():
    stats: dict = {}
    assert xray_smoke.run_xray_smoke(device="cpu", stats=stats) == []
    assert stats["analytic_flops"] > 0 and stats["mfu"] is None
    assert stats["roofline_bound"] is None and stats["roofline_reason"]
    assert stats["measured_unavailable"]


def test_pulse_smoke_on_the_cpu():
    stats: dict = {}
    assert pulse_smoke.run_pulse_smoke(device="cpu", stats=stats) == []
    assert stats["analytic"]["broadcast"]["launches"] == 2
    assert stats["dhqr306_pass"]


def test_xray_roofline_on_a_known_card():
    from dhqr_tpu_torch.obs import xray
    from dhqr_tpu_torch.serve.engine import _plan_key
    from dhqr_tpu_torch.utils.config import DHQRConfig, ServeConfig

    key, _ = _plan_key("lstsq", 1, 24, 8, "float32",
                       DHQRConfig(block_size=8), ServeConfig())
    rep = xray.report_for(key, object(), device_kind="NVIDIA H100 80GB HBM3")
    assert rep.roofline_bound == "memory"
    assert rep.roofline_reason == xray.ANALYTIC_BYTES_REASON
    assert rep.intensity_flops_per_byte == round(
        rep.analytic_flops / xray._analytic_bytes_for_key(key), 3)
    assert xray.report_for(key, object(), device_kind="cpu") \
        .roofline_bound is None


# -- the whole slice ------------------------------------------------------------

def test_cli_with_every_pass_exits_0_on_the_cpu(capsys):
    assert cli.main(["check", "--device", "cpu", "--devices", "2",
                     "--preset", "accurate"]) == 0
    assert "dhqr-lint: 0 finding(s)" in capsys.readouterr().err


@pytest.mark.slow
def test_cli_full_matrix_on_the_cpu(capsys):
    assert cli.main(["check", "--device", "cpu"]) == 0
    assert cli.main(["comms", "--device", "cpu", "--json"]) == 0


def test_cli_comms_command_and_flags(tmp_path, capsys):
    import json

    assert cli.main(["comms", "--device", "cpu", "--devices", "2",
                     "--preset", "fast", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["findings"] == []
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert cli.main(["check", str(good), "--no-jaxpr", "--no-comms",
                     "--no-xray", "--no-pulse", "--no-atlas", "--preset",
                     "fast", "--devices", "4", "--contracts",
                     comms_pass.CONTRACTS_PATH]) == 0
    with pytest.raises(SystemExit):
        cli.main(["check", str(good), "--jaxpr"])
