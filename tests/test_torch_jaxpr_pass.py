"""PyTorch port: the op log and the jaxpr pass (ROADMAP item 18b).

The op log (``analysis/oplog.py``) is the port's jaxpr: a dispatch mode
that records what an entry point dispatches, with the panel kernels
recorded as launches by their wrapper. Here, on the CPU:

* the seam: the wrapper records one event per call, path ``plain`` on a
  CPU tensor, nothing when no log is armed; the log sees aten ops, c10d
  collectives with their group, an f64 promotion and a host sync;
* the registry's jaxpr hooks name the JAX registry's routes, per preset;
* the pass is clean over every preset (0 unsuppressed findings) and logs
  exactly the labels the registry owes it on a 1-rank mesh;
* planted faults, each flagged by its exact rule beside the JAX pass
  flagging the same fault: an f64 promotion (DHQR101), a host round trip
  inside a program (DHQR102), a collective on a group outside the mesh —
  the WORLD group (DHQR103), a route that raises (DHQR104).

The JAX side's jaxpr walk reads ``jax.core.ClosedJaxpr``; where the
installed jax has moved it to ``jax.extend.core``, the ``jax_walk``
fixture points the old name at it for the test's duration (the JAX
package itself is unchanged).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.tune import registry as jreg  # noqa: E402
from dhqr_tpu_torch.analysis import jaxpr_pass, oplog  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402
from dhqr_tpu_torch.precision import PRECISION_POLICIES  # noqa: E402
from dhqr_tpu_torch.tune import registry as treg  # noqa: E402

PRESETS = list(PRECISION_POLICIES)


@pytest.fixture
def jax_walk(monkeypatch):
    import jax.core
    import jax.extend.core

    for name in ("ClosedJaxpr", "Jaxpr"):
        monkeypatch.setattr(jax.core, name,
                            getattr(jax.extend.core, name), raising=False)


def _rules(findings):
    return sorted({f.rule for f in findings if not f.suppressed})


# -- the seam -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_kernel_seam_records_the_plain_path_on_the_cpu(dtype):
    rng = np.random.default_rng(0)
    panel = torch.as_tensor(rng.standard_normal((24, 4)), dtype=dtype)
    with oplog.record() as log:
        pf, alpha = hp._panel_qr_kernel(panel, 2)
    (ev,) = log.kernel_events()
    assert (ev.name, ev.path, ev.out_shapes, ev.offset) == (
        hp.KERNELS[dtype], "plain", ((24, 4),), 2)
    assert ev.out_dtypes == (str(dtype).replace("torch.", ""),)
    # disarmed: nothing recorded anywhere, same factors
    assert oplog.ARMED is None
    pf2, alpha2 = hp._panel_qr_kernel(panel, 2)
    assert len(log.kernel_events()) == 1
    assert torch.equal(pf, pf2) and torch.equal(alpha, alpha2)


def test_oplog_sees_ops_promotions_and_syncs():
    a = torch.ones(4, 4)
    with oplog.record("probe") as log:
        c = a @ a  # dhqr: ignore[DHQR002] the op under test, not a route's contraction
        d = c.double()
        float(c.sum().item())
    names = [e.name for e in log.events()]
    assert "aten.mm.default" in names
    f64 = [e for e in log.events() if e.out_dtypes == ("float64",)]
    assert f64 and f64[0].where == "<outside dhqr_tpu_torch>"
    assert [e.sync for e in log.syncs()] == ["_local_scalar_dense"]
    assert d.dtype == torch.float64 and oplog.ARMED is None


def test_scopes_nest_and_iter_jaxprs_walks_them():
    with oplog.record() as log:
        torch.ones(2) + 1
        with oplog.scope("shard:x", input_bytes=8):
            torch.ones(2) * 2
            with oplog.scope("relayout"):
                torch.ones(3)
    names = [s.name for s in jaxpr_pass.iter_jaxprs(log)]
    assert names == ["entry", "shard:x", "relayout"]
    assert [s.name for s in jaxpr_pass.sub_jaxprs([log, {"k": log.root}])] \
        == ["entry", "entry"]
    assert log.root.scopes[0].input_bytes == 8
    assert len(log.events()) == sum(len(s.eqns)
                                    for s in jaxpr_pass.iter_jaxprs(log))


# -- the registry's jaxpr hooks -------------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("devices", [1, 8])
def test_jaxpr_routes_are_the_jax_registrys(preset, devices):
    mine = treg.jaxpr_routes(preset, devices=devices)
    theirs = jreg.jaxpr_routes(preset, devices=devices)
    assert [r.name for r in mine] == [r.name for r in theirs]
    for r, j in zip(mine, theirs):
        assert [(s["label"], s["builder"], s["axes"]) for s in r.jaxpr] == \
            [(s["label"], s["builder"], s["axes"]) for s in j.jaxpr]


# -- the pass on the committed tree ---------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_jaxpr_pass_clean_per_preset(preset):
    runs = jaxpr_pass.run_routes([preset], device="cpu")
    findings = jaxpr_pass.run_jaxpr_pass(runs=runs)
    assert _rules(findings) == [], "\n".join(f.render() for f in findings)
    labels = {label for label, _, _ in runs}
    expected = {s["label"].format(preset=preset)
                for r in treg.jaxpr_routes(preset, devices=1)
                for s in r.jaxpr}
    assert labels == expected
    mesh = [log for label, log, axes in runs if axes]
    assert mesh and all(log.collectives() for log in mesh)
    assert all(not log.collectives() for label, log, axes in runs
               if not axes)


# -- planted faults, beside the JAX pass ----------------------------------------

def test_planted_f64_promotion_is_dhqr101(jax_walk):
    from dhqr_tpu.analysis.jaxpr_pass import check_jaxpr as jcheck

    a = torch.ones(4, 4)
    with oplog.record() as log:
        torch.matmul(a.double(), a.double().T)  # dhqr: ignore[DHQR002] the planted fault
    assert _rules(jaxpr_pass.check_jaxpr(log, "leak")) == ["DHQR101"]

    def leak(x):
        return jnp.matmul(x * np.float64(2.0), x.T, precision="highest")

    closed = jax.make_jaxpr(leak)(jnp.zeros((4, 4), jnp.float32))  # x64 on: conftest
    assert _rules(jcheck(closed, "leak")) == ["DHQR101"]


def test_planted_host_round_trip_is_dhqr102(jax_walk):
    from dhqr_tpu.analysis.jaxpr_pass import check_jaxpr as jcheck

    a = torch.ones(4)
    with oplog.record() as log:
        a * a.sum().item()
    found = jaxpr_pass.check_jaxpr(log, "sync")
    assert _rules(found) == ["DHQR102"]
    assert found[0].snippet.startswith("_local_scalar_dense@")

    def with_callback(x):
        return jax.pure_callback(lambda v: np.asarray(v) * 2,
                                 jax.ShapeDtypeStruct(x.shape, x.dtype), x)

    closed = jax.make_jaxpr(with_callback)(jnp.zeros((4,), jnp.float32))
    assert _rules(jcheck(closed, "cb")) == ["DHQR102"]


def test_planted_world_collective_is_dhqr103(jax_walk):
    import torch.distributed as dist

    from dhqr_tpu.analysis.jaxpr_pass import check_jaxpr as jcheck
    from dhqr_tpu.parallel.mesh import column_mesh as jmesh
    from dhqr_tpu.parallel.sharded_qr import sharded_blocked_qr as jqr
    from dhqr_tpu_torch.parallel import sharded_blocked_qr

    A = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    with jaxpr_pass.solo_meshes(torch.device("cpu")) as (meshes, groups):
        with oplog.record(groups=groups) as log:
            sharded_blocked_qr(A, meshes["cols"], block_size=4)
        assert jaxpr_pass.check_jaxpr(log, "ok", mesh_axes=("cols",)) == []
        x = torch.ones(4)
        with oplog.record(groups=groups) as log:
            dist.all_reduce(x, group=dist.group.WORLD)
        found = jaxpr_pass.check_jaxpr(log, "world", mesh_axes=("cols",))
        assert _rules(found) == ["DHQR103"]
        assert found[0].snippet == f"allreduce_[{oplog.group_name(None)}]"
    closed = jax.make_jaxpr(lambda a: jqr(a, jmesh(1), block_size=4))(
        jnp.zeros((16, 8), jnp.float32))
    assert jcheck(closed, "ok", mesh_axes=("cols",)) == []
    assert _rules(jcheck(closed, "bad", mesh_axes=("rows",))) == ["DHQR103"]


def test_a_route_that_raises_is_dhqr104():
    run = jaxpr_pass._unexpressible("ghost_route", "ghost_builder")
    findings = jaxpr_pass.run_jaxpr_pass(runs=[("ghost", ValueError("x"),
                                                 ())])
    assert _rules(findings) == ["DHQR104"]
    with pytest.raises(RuntimeError, match="ghost_builder"):
        run({})


def test_suppressions_carry_their_reason():
    from dhqr_tpu_torch.analysis.findings import (
        Finding,
        apply_graph_suppressions,
        load_graph_suppressions,
    )

    entries = load_graph_suppressions()
    assert all(e["reason"] and e["rule"] and e["snippet"] for e in entries)
    f = Finding("DHQR102", "qr[fast]", 0, "m", snippet="s@x.py:f")
    (got,) = apply_graph_suppressions(
        [f], [{"rule": "DHQR102", "snippet": "s@x.py:f", "label": "qr[*]",
               "reason": "by design"}])
    assert got.suppressed and got.reason == "by design"
    (kept,) = apply_graph_suppressions(
        [f], [{"rule": "DHQR102", "snippet": "s@x.py:f", "label": "lstsq*",
               "reason": "by design"}])
    assert not kept.suppressed
