"""PyTorch port: the column-sharded engines of ``dhqr_tpu_torch.parallel``
(``sharded_blocked_qr``, ``sharded_householder_qr``, ``sharded_solve``,
``sharded_lstsq``) on gloo process groups of 2 and 4 CPU ranks, against
the JAX package's mesh engines on the conftest's 8-device CPU mesh.

The ranks run through the port's launcher (``parallel/_ranks.run_ranks``
with its ``run_calls`` worker): one spawn per rank count for the module,
every case of that rank count in it; inputs are made with numpy from a
seed. Shapes: 32 x 24 (6 or 8 panels, the JAX engine's unrolled path),
72 x 72 (18 or 24 panels, its scanned path, n / nb > MAX_UNROLLED_PANELS)
and 32 x 23 (an n the engines pad). Each port schedule is held to the
JAX engine's twin where the JAX side runs it here, and to the JAX default
at the same shape otherwise (every JAX schedule agrees with its default to
roundoff; compiling each twin would cost ~3 s). Tolerances, relative to
the largest entry: H and alpha in natural order within 1e-9 in float64 and
complex128 (the JAX tests' own rtol), 2e-5 in float32 and complex64
(against the JAX float64 / complex128 factors of the same input);
x within 1e-8 (float64) and under the 8x criterion.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.ops.blocked import MAX_UNROLLED_PANELS  # noqa: E402
from dhqr_tpu.parallel import column_mesh  # noqa: E402
from dhqr_tpu.parallel import layout as jlay  # noqa: E402
from dhqr_tpu.parallel import sharded_qr as jsq  # noqa: E402
from dhqr_tpu.parallel.sharded_solve import (  # noqa: E402
    sharded_lstsq as jax_lstsq,
    sharded_solve as jax_solve,
)
from dhqr_tpu.utils.testing import (  # noqa: E402
    normal_equations_residual,
    oracle_residual,
    random_problem,
)
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    results_equal_across_ranks,
    run_calls,
    run_ranks,
)

NB = 4
SHAPES = {"U": (32, 24), "S": (72, 72), "pad": (32, 23)}
SCHEDULES = {"default": {}, "la": {"lookahead": True},
             "agg2": {"agg_panels": 2}, "agg3": {"agg_panels": 3},
             "agg2la": {"agg_panels": 2, "lookahead": True},
             "agg3la": {"agg_panels": 3, "lookahead": True}}
LAYOUTS = ("block", "cyclic")
RANKS = (2, 4)
TOL = {np.float64: 1e-9, np.complex128: 1e-9, np.float32: 2e-5,
       np.complex64: 2e-5}
WIDE = {np.float32: np.float64, np.complex64: np.complex128}

# (shape, dtype, layout, schedule, P) run on the JAX mesh; every other case
# is held to the JAX default of its shape and dtype.
JAX_TWINS = {
    ("U", np.float64, "block", "default", 2),
    ("U", np.float64, "cyclic", "la", 2),
    ("U", np.float64, "block", "agg3la", 4),
    ("S", np.float64, "block", "default", 4),
    ("pad", np.float64, "block", "default", 2),
    ("U", np.complex128, "cyclic", "la", 2),
}

# The port's cases: (shape, dtype, layout, schedule, use_pallas).
QR_CASES = (
    [("U", np.float64, lay, s, "auto") for lay in LAYOUTS for s in SCHEDULES]
    + [("S", np.float64, "block", "default", "auto"),
       ("S", np.float64, "cyclic", "la", "auto"),
       ("S", np.float64, "block", "agg3", "auto"),
       ("S", np.float64, "cyclic", "agg2la", "auto"),
       ("pad", np.float64, "block", "default", "auto"),
       ("pad", np.float64, "cyclic", "la", "auto"),
       ("pad", np.float64, "block", "agg2", "auto"),
       ("U", np.complex128, "cyclic", "la", "auto"),
       ("U", np.complex128, "block", "agg2", "auto"),
       ("U", np.float32, "block", "default", "always"),
       ("U", np.float32, "cyclic", "agg2la", "always"),
       ("U", np.float32, "cyclic", "la", "never"),
       ("U", np.complex64, "cyclic", "la", "always")])
UNBLOCKED_CASES = (("U", "block", 1), ("U", "cyclic", 2), ("pad", "cyclic", 4))


def _problem(shape, dtype):
    m, n = SHAPES[shape]
    A, b = random_problem(m, n, WIDE.get(dtype, dtype), seed=51)
    return A.astype(dtype), b.astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cases():
    """name -> steps of every case the ranks run (the same for each P)."""
    cases = {}
    for shape, dtype, layout, sched, pallas in QR_CASES:
        A, _ = _problem(shape, dtype)
        cases[("qr", shape, dtype, layout, sched, pallas)] = [(
            "sharded_blocked_qr", (A, COLS),
            dict(block_size=NB, layout=layout, use_pallas=pallas,
                 **SCHEDULES[sched]))]
    for shape, layout, store_nb in UNBLOCKED_CASES:
        A, _ = _problem(shape, np.float64)
        cases[("unblocked", shape, layout)] = [(
            "sharded_householder_qr", (A, COLS),
            dict(layout=layout, store_nb=store_nb))]
    for shape in ("U", "pad"):
        A, b = _problem(shape, np.float64)
        B = np.stack([b, 2 * b + 1], axis=1)
        H, alpha = _jax_qr(shape, np.float64, "block", "default", 2)
        for layout in LAYOUTS:
            cases[("lstsq", shape, layout)] = [(
                "sharded_lstsq", (A, b, COLS),
                dict(block_size=NB, layout=layout))]
            cases[("solve", shape, layout)] = [(
                "sharded_solve", (H, alpha, B, COLS),
                dict(block_size=NB, layout=layout))]
    return cases


@functools.lru_cache(maxsize=None)
def _jax_qr(shape, dtype, layout, sched, P):
    A, _ = _problem(shape, dtype)
    H, alpha = jsq.sharded_blocked_qr(
        jnp.asarray(A.astype(WIDE.get(dtype, dtype))), column_mesh(P),
        block_size=NB, layout=layout, **SCHEDULES[sched])
    return np.asarray(H), np.asarray(alpha)


def _jax_ref(shape, dtype, layout, sched, P):
    """The JAX twin when it runs here, else the JAX run of the same shape
    and dtype (its default where there is one)."""
    wide = WIDE.get(dtype, dtype)
    if (shape, wide, layout, sched, P) in JAX_TWINS:
        return _jax_qr(shape, dtype, layout, sched, P)
    twins = sorted((t for t in JAX_TWINS if t[:2] == (shape, wide)),
                   key=lambda t: (t[3] != "default", t[4]))
    return _jax_qr(shape, dtype, *twins[0][2:])


@pytest.fixture(scope="module")
def ranks():
    """``ranks(P)``: {case name: rank 0's outcome}, from one spawn of P
    ranks on the first call; every rank's outcome is checked
    bit-identical to rank 0's (the outputs are replicated)."""
    runs = {}

    def get(P):
        if P not in runs:
            cases = _cases()
            per_rank = run_ranks(run_calls, P, timeout_s=240,
                                 cases=list(cases.values()))
            assert results_equal_across_ranks(per_rank)
            runs[P] = dict(zip(cases, per_rank[0]))
        return runs[P]

    return get


def _ok(outcome):
    assert outcome[0] == "ok", outcome
    return outcome[1]


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("P", RANKS)
def test_blocked_schedules_match_jax(ranks, P, layout, sched):
    H, alpha = _ok(ranks(P)[("qr", "U", np.float64, layout, sched, "auto")])
    Hj, aj = _jax_ref("U", np.float64, layout, sched, P)
    assert H.shape == Hj.shape and alpha.shape == aj.shape
    assert _rel(H, Hj) <= 1e-9 and _rel(alpha, aj) <= 1e-9


@pytest.mark.parametrize("P", RANKS)
def test_blocked_scanned_path_matches_jax(ranks, P):
    m, n = SHAPES["S"]
    nb, _ = jlay.plan_padding(n, P, NB)
    assert n // nb > MAX_UNROLLED_PANELS
    for shape, dtype, layout, sched, pallas in QR_CASES:
        if shape != "S":
            continue
        H, alpha = _ok(ranks(P)[("qr", shape, dtype, layout, sched, pallas)])
        Hj, aj = _jax_ref(shape, dtype, layout, sched, P)
        assert _rel(H, Hj) <= 1e-9 and _rel(alpha, aj) <= 1e-9, \
            (layout, sched)


@pytest.mark.parametrize("P", RANKS)
def test_padded_n_matches_jax(ranks, P):
    """n = 23 does not divide into panels over the ranks: padded by
    orthogonal columns, factored, cut back to (32, 23)."""
    for shape, dtype, layout, sched, pallas in QR_CASES:
        if shape != "pad":
            continue
        H, alpha = _ok(ranks(P)[("qr", shape, dtype, layout, sched, pallas)])
        Hj, aj = _jax_ref(shape, dtype, layout, sched, P)
        assert H.shape == SHAPES["pad"] and alpha.shape == (23,)
        assert _rel(H, Hj) <= 1e-9 and _rel(alpha, aj) <= 1e-9, \
            (layout, sched)


@pytest.mark.parametrize("dtype", [np.complex128, np.float32,
                                   np.complex64], ids=lambda d: d.__name__)
@pytest.mark.parametrize("P", RANKS)
def test_blocked_other_dtypes_match_jax(ranks, P, dtype):
    """complex128 at 1e-9; float32 and complex64 (the panels on the Hopper
    kernel's plain version with use_pallas="always", or the plain panel
    loop) at 2e-5 of the JAX factors of the same input in double."""
    for shape, dt, layout, sched, pallas in QR_CASES:
        if dt != dtype:
            continue
        H, alpha = _ok(ranks(P)[("qr", shape, dt, layout, sched, pallas)])
        assert H.dtype == dtype
        Hj, aj = _jax_ref(shape, dt, layout, sched, P)
        tol = TOL[dtype]
        assert _rel(H, Hj) <= tol and _rel(alpha, aj) <= tol, \
            (layout, sched, pallas)


@pytest.mark.parametrize("P", RANKS)
def test_unblocked_matches_jax(ranks, P):
    """One broadcast per column; the cyclic store in blocks of 2 and 4
    columns; n = 23 padded."""
    for shape, layout, store_nb in UNBLOCKED_CASES:
        A, _ = _problem(shape, np.float64)
        Hj, aj = jsq.sharded_householder_qr(jnp.asarray(A), column_mesh(2))
        H, alpha = _ok(ranks(P)[("unblocked", shape, layout)])
        assert _rel(H, Hj) <= 1e-9 and _rel(alpha, aj) <= 1e-9, \
            (shape, layout)


@pytest.mark.parametrize("P", RANKS)
def test_solves_match_jax(ranks, P):
    """``sharded_lstsq`` (b a vector) and ``sharded_solve`` of the JAX
    mesh factors (b two columns), block and cyclic, within 1e-8 of the JAX
    mesh's x and under the 8x criterion."""
    mesh = column_mesh(2)
    for shape in ("U", "pad"):
        A, b = _problem(shape, np.float64)
        B = np.stack([b, 2 * b + 1], axis=1)
        x_j = np.asarray(jax_lstsq(jnp.asarray(A), jnp.asarray(b),
                                           mesh, block_size=NB))
        H, alpha = _jax_qr(shape, np.float64, "block", "default", 2)
        X_j = np.asarray(jax_solve(jnp.asarray(H), jnp.asarray(alpha),
                                           jnp.asarray(B), mesh,
                                           block_size=NB))
        bar = 8 * oracle_residual(A, b)
        for layout in LAYOUTS:
            x = _ok(ranks(P)[("lstsq", shape, layout)])
            X = _ok(ranks(P)[("solve", shape, layout)])
            assert x.shape == (A.shape[1],) and X.shape == (A.shape[1], 2)
            assert _rel(x, x_j) <= 1e-8 and _rel(X, X_j) <= 1e-8, \
                (shape, layout)
            assert normal_equations_residual(A, x, b) <= bar
            assert normal_equations_residual(A, X[:, 0], b) <= bar
