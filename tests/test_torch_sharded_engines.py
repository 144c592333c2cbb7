"""PyTorch port: the mesh tier through the public entry points — ``qr``,
``QRFactorization``, ``qr_explicit`` and ``lstsq`` with ``mesh=``, the
row-sharded TSQR / CholeskyQR engines, the refusals with their messages,
the knobs ported last (the depth-k pipeline, a compressed wire, the
two-tier pod mesh), and the rank launcher — on gloo process groups of 2
and 4 CPU ranks, against the JAX package on the conftest's 8-device CPU
mesh.

The ranks run through ``parallel/_ranks.run_ranks`` with its
``run_calls`` worker, one spawn per rank count for the module. Inputs are
made with numpy from a seed. Tolerances, relative to the largest entry:
factors within 1e-9 (float64), x within 1e-8 (float64 and complex128),
2e-5 in float32; every x under the reference's 8x criterion.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
from dhqr_tpu.parallel import column_mesh, row_mesh  # noqa: E402
from dhqr_tpu.parallel import sharded_qr as jsq  # noqa: E402
from dhqr_tpu.parallel.sharded_cholqr import sharded_cholqr_lstsq  # noqa: E402
from dhqr_tpu.parallel.sharded_solve import sharded_lstsq, sharded_solve  # noqa: E402,E501
from dhqr_tpu.parallel.mesh import pod_mesh as jax_pod_mesh  # noqa: E402
from dhqr_tpu.parallel.sharded_tsqr import sharded_tsqr_lstsq  # noqa: E402
from dhqr_tpu.utils.testing import (  # noqa: E402
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch.parallel import column_mesh as torch_column_mesh  # noqa: E402,E501
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    PREV,
    ROWS,
    pod,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)

RANKS = (2, 4)
NB = 4
A, b = random_problem(32, 24, np.float64, seed=61)
A_PAD = A[:, :23]
B2 = np.stack([b, 1 - b], axis=1)
TALL, TALL_B = random_problem(64, 8, np.float64, seed=62)
TALL_C, TALL_CB = random_problem(64, 8, np.complex128, seed=63)
WIDE = A[:16]

# The model tier: name -> steps (the same on every rank count).
CASES = {
    "qr_solve": [("qr", (A,), dict(mesh=COLS, block_size=NB)),
                 (".solve", (b,), {})],
    "qr_cyclic_la_H": [("qr", (A,), dict(mesh=COLS, block_size=NB,
                                          layout="cyclic", lookahead=True)),
                       (".natural_H", (), {})],
    "qr_agg_alpha": [("qr", (A,), dict(mesh=COLS, block_size=NB,
                                        agg_panels=2)),
                     (".condition_estimate", (), {})],
    "qr_pad_solve2": [("qr", (A_PAD,), dict(mesh=COLS, block_size=NB,
                                             layout="cyclic")),
                      (".solve", (B2[:, :],), {})],
    "qr_unblocked_solve": [("qr", (A,), dict(mesh=COLS, block_size=NB,
                                              blocked=False, layout="cyclic")),
                           (".solve", (b,), {})],
    "qr_R": [("qr", (A,), dict(mesh=COLS, block_size=NB, layout="cyclic")),
             (".r_matrix", (), {})],
    "qr_Q": [("qr", (A,), dict(mesh=COLS, block_size=NB)),
             (".q_columns", (), {})],
    "qr_explicit": [("qr_explicit", (A_PAD,), dict(mesh=COLS, block_size=NB,
                                                   layout="cyclic"))],
    "qr_to_numpy": [("qr", (A_PAD,), dict(mesh=COLS, block_size=NB,
                                          layout="cyclic", lookahead=True)),
                    ("interop.factorization_to_numpy", (PREV,), {})],
    "qr_policy_refine": [("qr", (A,), dict(mesh=COLS, block_size=NB,
                                            policy="balanced")),
                         (".solve", (b,), {})],
    "qr_depth1_is_lookahead": [("qr", (A[:, :8],), dict(
        mesh=COLS, block_size=NB, lookahead=True, overlap_depth=2)),
        (".natural_H", (), {})],
    "lstsq": [("lstsq", (A, b), dict(mesh=COLS, block_size=NB))],
    "lstsq_pad_agg_la": [("lstsq", (A_PAD, b), dict(
        mesh=COLS, block_size=NB, agg_panels=2, lookahead=True))],
    "lstsq_unblocked_cyclic": [("lstsq", (A_PAD, b), dict(
        mesh=COLS, block_size=NB, blocked=False, layout="cyclic"))],
    "lstsq_refine": [("lstsq", (A, b), dict(mesh=COLS, block_size=NB,
                                             refine=2))],
    "tsqr": [("lstsq", (TALL, TALL_B), dict(mesh=ROWS, engine="tsqr",
                                            block_size=NB))],
    "tsqr_c128": [("lstsq", (TALL_C, TALL_CB), dict(mesh=ROWS,
                                                    engine="tsqr"))],
    "tsqr_f32_kernel": [("sharded_tsqr_lstsq", (
        TALL.astype(np.float32), TALL_B.astype(np.float32), ROWS),
        dict(block_size=NB, use_pallas="always"))],
    "cholqr2": [("lstsq", (TALL, TALL_B), dict(mesh=ROWS,
                                               engine="cholqr2"))],
    "cholqr3": [("lstsq", (TALL, TALL_B), dict(mesh=ROWS,
                                               engine="cholqr3"))],
    # the knobs that raised NotPortedError until the wire was ported
    "pipeline": [("sharded_blocked_qr", (A, COLS), dict(
        block_size=NB, overlap_depth=2, lookahead=True))],
    "comms": [("lstsq", (A, b), dict(mesh=COLS, comms="bf16"))],
    "comms_engine": [("sharded_tsqr_lstsq", (TALL, TALL_B, ROWS), dict(
        comms="int8"))],
    "two_tier": [("sharded_blocked_qr", (A, pod("")), dict(block_size=NB))],
}

# Refusals: name -> (steps, the JAX call that must raise the same message,
# or None where the port raises its own).
REFUSALS = {
    "agg1": ([("sharded_blocked_qr", (A, COLS), dict(agg_panels=1))],
             lambda m: jsq.sharded_blocked_qr(A, m, agg_panels=1)),
    "depth0": ([("sharded_blocked_qr", (A, COLS), dict(
        overlap_depth=0, lookahead=True))],
        lambda m: jsq.sharded_blocked_qr(A, m, overlap_depth=0,
                                         lookahead=True)),
    "depth_no_lookahead": ([("sharded_blocked_qr", (A, COLS), dict(
        overlap_depth=2))],
        lambda m: jsq.sharded_blocked_qr(A, m, overlap_depth=2)),
    "depth_agg": ([("sharded_blocked_qr", (A, COLS), dict(
        overlap_depth=2, lookahead=True, agg_panels=2))],
        lambda m: jsq.sharded_blocked_qr(A, m, overlap_depth=2,
                                         lookahead=True, agg_panels=2)),
    "donate": ([("qr", (A,), dict(mesh=COLS, donate=True))],
               lambda m: dhqr_tpu.qr(jnp.asarray(A), mesh=m, donate=True)),
    "m_lt_n": ([("sharded_blocked_qr", (WIDE, COLS), dict(block_size=NB))],
               lambda m: jsq.sharded_blocked_qr(WIDE, m, block_size=NB)),
    "chain_pad": ([("sharded_blocked_qr", (A_PAD, COLS), dict(
        block_size=NB, _store_layout_output=True))],
        lambda m: jsq.sharded_blocked_qr(A_PAD, m, block_size=NB,
                                         _store_layout_output=True)),
    "solve_chain_pad": ([("sharded_solve", (A_PAD, b[:23], b, COLS), dict(
        block_size=NB, _H_in_store_layout=True))],
        lambda m: sharded_solve(A_PAD, b[:23], b, m, block_size=NB,
                                _H_in_store_layout=True)),
    "unblocked_lookahead": ([("qr", (A,), dict(mesh=COLS, blocked=False,
                                               lookahead=True))],
                            lambda m: dhqr_tpu.qr(jnp.asarray(A), mesh=m,
                                                  blocked=False,
                                                  lookahead=True)),
    "lstsq_m_lt_n": ([("lstsq", (WIDE, b[:16]), dict(mesh=COLS))],
                     lambda m: dhqr_tpu.lstsq(jnp.asarray(WIDE),
                                              jnp.asarray(b[:16]), mesh=m)),
    "sketch": ([("lstsq", (A, b), dict(mesh=COLS, engine="sketch"))],
               lambda m: dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                        mesh=m, engine="sketch")),
    "cholqr_refine": ([("lstsq", (TALL, TALL_B), dict(
        mesh=ROWS, engine="cholqr2", refine=1))],
        lambda m: dhqr_tpu.lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                 mesh=row_mesh(m.size), engine="cholqr2",
                                 refine=1)),
    "tsqr_refine": ([("lstsq", (TALL, TALL_B), dict(
        mesh=ROWS, engine="tsqr", refine=1))],
        lambda m: dhqr_tpu.lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                 mesh=row_mesh(m.size), engine="tsqr",
                                 refine=1)),
    "mesh_axis": ([("lstsq", (TALL, TALL_B), dict(
        mesh=ROWS, engine="tsqr", mesh_axis="cols"))],
        lambda m: dhqr_tpu.lstsq(jnp.asarray(TALL), jnp.asarray(TALL_B),
                                 mesh=row_mesh(m.size), engine="tsqr",
                                 mesh_axis="cols")),
    "tsqr_divisible": ([("sharded_tsqr_lstsq", (TALL[:63], TALL_B[:63],
                                                ROWS), {})],
                       lambda m: sharded_tsqr_lstsq(
                           TALL[:63], TALL_B[:63], row_mesh(m.size))),
    "tsqr_tall": ([("sharded_tsqr_lstsq", (A, b, ROWS), {})],
                  lambda m: sharded_tsqr_lstsq(A, b, row_mesh(m.size))),
    "cholqr_m_lt_n": ([("sharded_cholqr_lstsq", (WIDE, b[:16], ROWS), {})],
                      lambda m: sharded_cholqr_lstsq(
                          WIDE, b[:16], row_mesh(m.size))),
    "policy_refine": ([("sharded_lstsq", (A, b, COLS), dict(
        policy="balanced"))],
        lambda m: sharded_lstsq(A, b, m, policy="balanced")),
    "layout": ([("sharded_blocked_qr", (A, COLS), dict(layout="diagonal"))],
               lambda m: jsq.sharded_blocked_qr(A, m, layout="diagonal")),
    "two_tier_on_1d": ([("sharded_blocked_qr", (A, COLS), dict(
        axis_name=("dcn", "ici")))], None),
    "row_mesh_for_columns": ([("qr", (A,), dict(mesh=ROWS))], None),
}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def ranks():
    """``ranks(P)``: {case name: rank 0's outcome} from one spawn of P
    ranks on the first call; every rank's outcome is bit-identical."""
    runs = {}

    def get(P):
        if P not in runs:
            names = list(CASES) + list(REFUSALS)
            steps = list(CASES.values()) + [s for s, _ in REFUSALS.values()]
            per_rank = run_ranks(run_calls, P, device="cpu", timeout_s=240,
                                 cases=steps)
            assert results_equal_across_ranks(per_rank)
            runs[P] = dict(zip(names, per_rank[0]))
        return runs[P]

    return get


def _ok(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[1]


@pytest.mark.parametrize("P", RANKS)
def test_qr_on_a_mesh_matches_jax(ranks, P):
    """``qr(mesh=)`` keeps each rank's block; its solves, ``natural_H``,
    ``r_matrix``, ``q_columns`` and ``qr_explicit`` match the JAX mesh
    factorization's, every layout and schedule to the same factors."""
    mesh = column_mesh(P)
    fact = dhqr_tpu.qr(jnp.asarray(A), mesh=mesh, block_size=NB)
    H_j, alpha_j = np.asarray(fact.H), np.asarray(fact.alpha)
    x_j = np.asarray(fact.solve(jnp.asarray(b)))
    got = ranks(P)
    assert _rel(_ok(got["qr_solve"]), x_j) <= 1e-8
    assert _rel(_ok(got["qr_cyclic_la_H"]), H_j) <= 1e-9
    assert _rel(_ok(got["qr_agg_alpha"]),
                np.abs(alpha_j).max() / np.abs(alpha_j).min()) <= 1e-9
    assert _rel(_ok(got["qr_unblocked_solve"]), x_j) <= 1e-8
    assert _rel(_ok(got["qr_policy_refine"]), x_j) <= 1e-8
    R, Q = _ok(got["qr_R"]), _ok(got["qr_Q"])
    assert _rel(R, np.asarray(fact.r_matrix())) <= 1e-9
    assert _rel(Q, np.asarray(fact.q_columns())) <= 1e-9
    assert _rel(Q @ R, A) <= 1e-12
    # overlap_depth is clamped to the panels after the first: at P = 2,
    # n = 8 holds two panels, so depth 2 is the lookahead order; at P = 4
    # the panel width drops to 2 and four panels run the depth-2 pipeline
    f8 = dhqr_tpu.qr(jnp.asarray(A[:, :8]), mesh=mesh, block_size=NB,
                     lookahead=True,
                     **({} if P == 2 else {"overlap_depth": 2}))
    assert _rel(_ok(got["qr_depth1_is_lookahead"]),
                np.asarray(f8.H)) <= 1e-9


@pytest.mark.parametrize("P", RANKS)
def test_padded_factorization_on_a_mesh(ranks, P):
    """n = 23: the factorization holds the padded blocks, solves a
    two-column b and materializes (Q, R) of the (32, 23) A."""
    x_j = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A_PAD), jnp.asarray(b),
                                    mesh=column_mesh(P), block_size=NB))
    X = _ok(ranks(P)["qr_pad_solve2"])
    assert X.shape == (23, 2)
    assert _rel(X[:, 0], x_j) <= 1e-8
    H, alpha = _ok(ranks(P)["qr_to_numpy"])
    f_j = dhqr_tpu.qr(jnp.asarray(A_PAD), mesh=column_mesh(P), block_size=NB)
    assert H.shape == (32, 23) and alpha.shape == (23,)
    assert _rel(H, f_j.H) <= 1e-9 and _rel(alpha, f_j.alpha) <= 1e-9
    Q, R = _ok(ranks(P)["qr_explicit"])
    assert Q.shape == (32, 23) and R.shape == (23, 23)
    assert _rel(Q @ R, A_PAD) <= 1e-12
    assert _rel(Q.T @ Q, np.eye(23)) <= 1e-12
    for name in ("lstsq_pad_agg_la", "lstsq_unblocked_cyclic"):
        x = _ok(ranks(P)[name])
        assert _rel(x, x_j) <= 1e-8, name


@pytest.mark.parametrize("P", RANKS)
def test_lstsq_on_a_mesh_matches_jax(ranks, P):
    mesh = column_mesh(P)
    x_j = np.asarray(dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b),
                                    mesh=mesh, block_size=NB))
    bar = 8 * oracle_residual(A, b)
    for name in ("lstsq", "lstsq_refine"):
        x = _ok(ranks(P)[name])
        assert _rel(x, x_j) <= 1e-8, name
        assert normal_equations_residual(A, x, b) <= bar


@pytest.mark.parametrize("P", RANKS)
def test_row_engines_match_jax(ranks, P):
    """TSQR (leaves and combine; float32 with the panels on the Hopper
    kernel's plain version) and CholeskyQR2/3 on the row mesh."""
    mesh = row_mesh(P)
    got = ranks(P)
    x_t = np.asarray(sharded_tsqr_lstsq(TALL, TALL_B, mesh, block_size=NB))
    x_c = np.asarray(sharded_tsqr_lstsq(TALL_C, TALL_CB, mesh))
    assert _rel(_ok(got["tsqr"]), x_t) <= 1e-8
    assert _rel(_ok(got["tsqr_c128"]), x_c) <= 1e-8
    assert _rel(_ok(got["tsqr_f32_kernel"]), x_t) <= 2e-5
    for name, shift in (("cholqr2", False), ("cholqr3", True)):
        x_j = np.asarray(sharded_cholqr_lstsq(TALL, TALL_B, mesh,
                                              shift=shift))
        assert _rel(_ok(got[name]), x_j) <= 1e-8, name
    bar = 8 * oracle_residual(TALL, TALL_B)
    for name in ("tsqr", "cholqr2", "cholqr3"):
        assert normal_equations_residual(TALL, _ok(got[name]), TALL_B) <= bar
    assert normal_equations_residual(
        TALL_C, _ok(got["tsqr_c128"]), TALL_CB) <= 8 * oracle_residual(
            TALL_C, TALL_CB)


def _jax_outcome(call, P):
    try:
        call(column_mesh(P))
    except Exception as exc:  # the refusal under test
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("name", sorted(n for n, (_, j) in REFUSALS.items()
                                        if j is not None))
def test_refusals_match_jax_messages(ranks, P, name):
    outcome = ranks(P)[name]
    assert outcome[0] == "raised", outcome
    assert outcome[1:] == _jax_outcome(REFUSALS[name][1], P)


@pytest.mark.parametrize("P", RANKS)
def test_unported_mesh_knobs_raise(ranks, P):
    """The knobs that raised NotPortedError before the wire was ported
    run and match the JAX package: a depth-2 pipeline (1e-9), a compressed
    wire through
    the model tier and a row engine (within the wire's rounding, 2^-6 /
    4/127) and a pod mesh's two-tier axis (1e-9). What still raises: a
    two-tier spelling on a 1-D mesh and a column call on a row mesh, the
    axis KeyError, as in the JAX package."""
    got = ranks(P)
    mesh = column_mesh(P)
    H_j, alpha_j = jsq.sharded_blocked_qr(A, mesh, block_size=NB,
                                          overlap_depth=2, lookahead=True)
    H, alpha = _ok(got["pipeline"])
    assert _rel(H, H_j) <= 1e-9 and _rel(alpha, alpha_j) <= 1e-9
    x_j = dhqr_tpu.lstsq(jnp.asarray(A), jnp.asarray(b), mesh=mesh,
                         comms="bf16")
    assert _rel(_ok(got["comms"]), x_j) <= 2.0 ** -6
    xt_j = sharded_tsqr_lstsq(TALL, TALL_B, row_mesh(P), comms="int8")
    assert _rel(_ok(got["comms_engine"]), xt_j) <= 4 / 127
    H_p, _ = jsq.sharded_blocked_qr(A, jax_pod_mesh(P)[0], block_size=NB)
    assert _rel(_ok(got["two_tier"])[0], H_p) <= 1e-9
    for name in ("two_tier_on_1d", "row_mesh_for_columns"):
        assert got[name][:2] == ("raised", "KeyError"), got[name]


def test_a_rank_that_raises_fails_the_run():
    """The launcher raises in the parent with the rank's traceback (here
    every rank builds a mesh on a group that does not exist)."""
    with pytest.raises(RuntimeError, match=r"rank \d of 2 raised"):
        run_ranks(torch_column_mesh, 2, device="cpu", timeout_s=120,
                  group="no-group")


def test_initialize_alone_is_a_noop(monkeypatch):
    """One process with no arguments and no torchrun variables stays
    standalone (the docstring's contract); a mesh then needs a group."""
    from dhqr_tpu_torch import parallel

    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    parallel.initialize()
    assert not torch.distributed.is_initialized()
    info = parallel.process_info()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    with pytest.raises(RuntimeError, match="process group"):
        parallel.column_mesh(device="cpu")
