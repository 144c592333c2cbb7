"""PyTorch port: gradients through the mesh — the ``autograd.Function`` s of
``dhqr_tpu_torch.parallel`` (``sharded_qr._ShardedHouseholderQR``,
``sharded_solve._ShardedSolve`` / ``_ShardedLstsq``,
``sharded_tsqr._RowLstsq``) on gloo groups of 2 and 4 CPU ranks, against
``jax.grad`` / ``jax.jvp`` of the JAX package's mesh routes on the
conftest's 8-device CPU mesh.

The ranks run through ``parallel/_ranks.run_grads``: one spawn per rank
count for the module, every case in it, each case differentiated in
reverse mode (``backward``) and forward mode (forward-AD dual tensors, or
``torch.func.jvp``); inputs are made with numpy from a seed. The JAX
reference is the default of each route (every JAX schedule agrees with its
default to 2e-15), compiled once (``lru_cache``); every port schedule and
layout is held to it, and the factorization's to the port's single-device
``householder_factor`` gradient too. Shapes: 32 x 24 (nb 4), 32 x 23 (an
n the engines pad) and the 256 x 32 row mesh. Tolerances, relative: 1e-9
in float64 and complex128 (PyTorch's complex gradient is the conjugate of
``jax.grad``'s); the compressed row engines within 1e-3 of the exact
gradient; float32 on the kernel route within 2x the single-device float32
route's error against the float64 gradient.

The loss on each rank is ``sum Re <w, out>`` over its outputs. A
store-order block (``qr(mesh=).H``) is a sharded output: the global loss
sums the ranks' block losses. alpha and x are replicated: the global loss
counts them once.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.parallel import column_mesh  # noqa: E402
from dhqr_tpu.parallel.sharded_solve import (  # noqa: E402
    sharded_solve as jax_sharded_solve,
)
from dhqr_tpu.parallel.sharded_tsqr import row_mesh as jax_row_mesh  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
from dhqr_tpu_torch.ops.differentiable import (  # noqa: E402
    _wy_vjp,
    householder_factor,
)
from dhqr_tpu_torch.parallel._ranks import (  # noqa: E402
    COLS,
    ROWS,
    Arg,
    results_equal_across_ranks,
    run_grads,
    run_ranks,
)
from dhqr_tpu_torch.parallel.layout import (  # noqa: E402
    natural_store_positions,
    plan_padding,
)

NB = 4
RANKS = (2, 4)
TOL = 1e-9
SHAPES = {"U": (32, 24), "pad": (32, 23), "rows": (256, 32)}
SCHEDULES = {"default": {}, "la": {"lookahead": True},
             "agg2": {"agg_panels": 2},
             "agg2la": {"agg_panels": 2, "lookahead": True},
             "depth2": {"lookahead": True, "overlap_depth": 2},
             "unblocked": {"blocked": False}}
LAYOUTS = ("block", "cyclic")
# (shape, dtype, layout, schedule, use_pallas) of the qr cases
QR_CASES = (
    [("U", np.float64, lay, s, "auto") for lay in LAYOUTS for s in SCHEDULES]
    + [("U", np.complex128, "block", "default", "auto"),
       ("U", np.complex128, "cyclic", "la", "auto"),
       ("pad", np.float64, "block", "default", "auto"),
       ("pad", np.float64, "cyclic", "agg2la", "auto"),
       ("pad", np.float64, "block", "unblocked", "auto"),
       ("U", np.float32, "block", "default", "always"),
       ("U", np.float32, "cyclic", "agg2la", "always")])
LSTSQ_VARIANTS = {"blocked": {}, "cyclic": {"layout": "cyclic"},
                  "la": {"lookahead": True}, "unblocked": {"blocked": False}}
# (shape, dtype, variant) of the one-shot lstsq cases
LSTSQ_CASES = ([("U", np.float64, v) for v in LSTSQ_VARIANTS]
               + [("U", np.complex128, "blocked"),
                  ("U", np.complex128, "unblocked"),
                  ("pad", np.float64, "blocked")])
SOLVE_CASES = [("U", np.float64, "block"), ("U", np.float64, "cyclic"),
               ("U", np.complex128, "block"), ("pad", np.float64, "block")]
ROW_CASES = [(np.float64, "tsqr", None), (np.float64, "cholqr2", None),
             (np.float64, "cholqr3", None), (np.complex128, "tsqr", None)]
COMPRESSED = [("tsqr", "bf16"), ("cholqr2", "int8")]
WIDE = {np.float32: np.float64}


def _like(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@functools.lru_cache(maxsize=None)
def _inputs(shape, dtype):
    """``(A, b, W, wa, wx, dA, db)``: the problem, the weights of H, alpha
    and x in the loss, and the tangents of A and b."""
    m, n = SHAPES[shape]
    A, b = random_problem(m, n, WIDE.get(dtype, dtype), seed=81)
    return (A.astype(dtype), b.astype(dtype), _like((m, n), dtype, 82),
            _like((n,), dtype, 83), _like((n,), dtype, 84),
            _like((m, n), dtype, 85), _like((m,), dtype, 86))


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _cases():
    """name -> case of every case the ranks run (the same for each P)."""
    cases = {}
    for key in QR_CASES:
        shape, dtype, layout, sched, pallas = key
        A, _, W, wa, _, dA, _ = _inputs(shape, dtype)
        cases[("qr",) + key] = {
            "inputs": [A], "wrt": [0], "out": ["H", "alpha"],
            "steps": [("qr", (Arg(0),), dict(
                mesh=COLS, block_size=NB, layout=layout, use_pallas=pallas,
                **SCHEDULES[sched]))],
            "weights": [("store", W), wa], "tangents": [dA],
            "mode": "func" if key == QR_CASES[0] else "dual"}
    for key in LSTSQ_CASES:
        shape, dtype, variant = key
        A, b, _, _, wx, dA, db = _inputs(shape, dtype)
        cases[("lstsq",) + key] = {
            "inputs": [A, b],
            "steps": [("lstsq", (Arg(0), Arg(1)), dict(
                mesh=COLS, block_size=NB, **LSTSQ_VARIANTS[variant]))],
            "weights": [wx], "tangents": [dA, db],
            "mode": "func" if key == LSTSQ_CASES[0] else "dual"}
    A, b, _, _, wx, dA, db = _inputs("U", np.float64)
    B = np.stack([b, 2 * b + 1], axis=1)
    cases[("lstsq_rhs",)] = {
        "inputs": [A, B], "wrt": [1],
        "steps": [("lstsq", (Arg(0), Arg(1)), dict(mesh=COLS,
                                                   block_size=NB))],
        "weights": [np.stack([wx, -wx], axis=1)],
        "tangents": [np.stack([db, db], axis=1)]}
    for key in SOLVE_CASES:
        shape, dtype, layout = key
        A, b, _, _, wx, dA, db = _inputs(shape, dtype)
        cases[("solve",) + key] = {
            "inputs": [A, b],
            "steps": [("qr", (Arg(0),), dict(mesh=COLS, block_size=NB,
                                             layout=layout)),
                      (".solve", (Arg(1),), {})],
            "weights": [wx], "tangents": [dA, db]}
    A, b, W, wa, wx, dA, db = _inputs("U", np.float64)
    cases[("natural",)] = {
        "inputs": [A], "out": [0, 1],
        "steps": [("sharded_blocked_qr", (Arg(0), COLS),
                   {"block_size": NB})],
        "weights": [W, wa], "tangents": [dA]}
    H, alpha = _jax_qr_factors()
    cases[("natural_solve",)] = {
        "inputs": [H, alpha, b],
        "steps": [("sharded_solve", (Arg(0), Arg(1), Arg(2), COLS),
                   {"block_size": NB})],
        "weights": [wx],
        "tangents": [_like(H.shape, np.float64, 87),
                     _like(alpha.shape, np.float64, 88), db]}
    for dtype, engine, comms in ROW_CASES + [
            (np.float64, e, c) for e, c in COMPRESSED]:
        A, b, _, _, wx, dA, db = _inputs("rows", dtype)
        cases[("rows", dtype, engine, comms)] = {
            "inputs": [A, b],
            "steps": [("lstsq", (Arg(0), Arg(1)), dict(
                mesh=ROWS, engine=engine, comms=comms))],
            "weights": [wx], "tangents": [dA, db]}
    return cases


@pytest.fixture(scope="module")
def ranks():
    """``ranks(P)``: {case name: [every rank's result]}, from one spawn of
    P ranks on the first call; every case must run, and every rank's
    gradients must be bit-identical to rank 0's (the inputs are
    replicated)."""
    runs = {}

    def get(P):
        if P not in runs:
            cases = _cases()
            per_rank = run_ranks(run_grads, P, device="cpu", timeout_s=300,
                                 cases=list(cases.values()))
            runs[P] = {}
            for i, name in enumerate(cases):
                outcomes = [r[i] for r in per_rank]
                assert outcomes[0][0] == "ok", (name, outcomes[0])
                results = [o[1] for o in outcomes]
                assert results_equal_across_ranks(
                    [(r["grads"], r["gu"]) for r in results]), name
                runs[P][name] = results
        return runs[P]

    return get


# -- the JAX references ---------------------------------------------------------

def _jloss(ws, outs):
    return sum(jnp.sum(jnp.real(jnp.conj(w) * o)) for w, o in zip(ws, outs))


def _port_grad(g):
    """jax.grad's gradient in PyTorch's convention (the conjugate)."""
    return np.conj(np.asarray(g))


@functools.lru_cache(maxsize=None)
def _jax_qr(shape, dtype):
    """(loss, grad, (dH, dalpha)) of qr(A, mesh=).H / .alpha."""
    A, _, W, wa, _, dA, _ = _inputs(shape, dtype)
    mesh = column_mesh(4)

    def outs(A):
        fact = dhqr_tpu.qr(A, mesh=mesh, block_size=NB)
        return fact.H, fact.alpha

    loss, g = jax.value_and_grad(lambda A: _jloss((W, wa), outs(A)))(
        jnp.asarray(A))
    _, tangents = jax.jvp(outs, (jnp.asarray(A),), (jnp.asarray(dA),))
    return float(loss), _port_grad(g), tuple(np.asarray(t) for t in tangents)


def _jax_x_route(fn, shape, dtype, jvp=True):
    """(grads in A and b, dx) of ``fn(A, b)`` (an x) under the loss."""
    A, b, _, _, wx, dA, db = _inputs(shape, dtype)
    args = (jnp.asarray(A), jnp.asarray(b))
    g = jax.grad(lambda A, b: _jloss((wx,), (fn(A, b),)), (0, 1))(*args)
    dx = np.asarray(jax.jvp(fn, args, (jnp.asarray(dA), jnp.asarray(db)))[1]) \
        if jvp else None
    return tuple(_port_grad(x) for x in g), dx


@functools.lru_cache(maxsize=None)
def _jax_lstsq(shape, dtype):
    mesh = column_mesh(4)
    return _jax_x_route(
        lambda A, b: dhqr_tpu.lstsq(A, b, mesh=mesh, block_size=NB), shape,
        dtype)


@functools.lru_cache(maxsize=None)
def _jax_solve(shape, dtype):
    mesh = column_mesh(4)
    return _jax_x_route(
        lambda A, b: dhqr_tpu.qr(A, mesh=mesh, block_size=NB).solve(b),
        shape, dtype)


@functools.lru_cache(maxsize=None)
def _jax_rows(dtype, engine, comms=None):
    mesh = jax_row_mesh(4)
    return _jax_x_route(
        lambda A, b: dhqr_tpu.lstsq(A, b, mesh=mesh, engine=engine,
                                    comms=comms),
        "rows", dtype, jvp=comms is None)


@functools.lru_cache(maxsize=None)
def _jax_qr_factors():
    """The single-device factors of the "U" problem (the natural-order
    input of ``sharded_solve``)."""
    A = _inputs("U", np.float64)[0]
    fact = dhqr_tpu.qr(jnp.asarray(A), block_size=NB)
    return np.asarray(fact.H), np.asarray(fact.alpha)


def _single_factor_grad(shape, dtype, use_pallas="never"):
    """The port's single-device householder_factor gradient of the loss."""
    A, _, W, wa, _, _, _ = _inputs(shape, dtype)
    At = torch.tensor(A, requires_grad=True)
    H, alpha = householder_factor(At, NB, kernel=use_pallas == "always")
    _torch_loss((W, wa), (H, alpha)).backward()
    return At.grad.numpy()


def _torch_loss(ws, outs):
    return sum(torch.sum(torch.real(torch.from_numpy(np.asarray(w)).conj()
                                    * o)) for w, o in zip(ws, outs))


# -- helpers for the ranks' results ----------------------------------------------

def _natural(blocks, shape, P, layout):
    """The natural-order (m, n) matrix from every rank's store-order block
    of a mesh factorization of ``shape``."""
    m, n = shape
    nb, n_pad = plan_padding(n, P, NB)
    H = np.concatenate(blocks, axis=1)
    if layout == "cyclic":
        H = H[:, natural_store_positions(n_pad, P, nb)]
    return H[:m, :n]


def _global(results, values: str):
    """The global loss (or <w, J u>) of a qr case: the ranks' block terms
    summed, alpha's (replicated) counted once."""
    return sum(r[values][0] for r in results) + results[0][values][1]


@pytest.mark.parametrize("P", RANKS)
def test_every_case_differentiates_alike_on_every_rank(ranks, P):
    """Every case runs on every rank (the spawn of this rank count), and
    every rank's gradients, and its replicated outputs and their tangents,
    are bit-identical to rank 0's."""
    for name, results in ranks(P).items():
        if name[0] != "qr":
            assert results_equal_across_ranks(
                [(r["outs"], r["jvp"]) for r in results]), name


# -- the column mesh: qr(mesh=) -------------------------------------------------

@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("P", RANKS)
def test_qr_schedules_match_jax(ranks, P, layout, sched):
    """Every schedule and layout of qr(mesh=): A's gradient within 1e-9 of
    jax.grad's and of the port's single-device gradient, the tangents of
    H and alpha of jax.jvp's, the forward with grad the forward without
    it bit for bit."""
    results = ranks(P)[("qr", "U", np.float64, layout, sched, "auto")]
    r0 = results[0]
    _, jgrad, (jdH, jdalpha) = _jax_qr("U", np.float64)
    assert _rel(r0["grads"][0], jgrad) <= TOL
    assert _rel(r0["grads"][0],
                _single_factor_grad("U", np.float64)) <= TOL
    dH = _natural([r["jvp"][0] for r in results], SHAPES["U"], P, layout)
    assert _rel(dH, jdH) <= TOL and _rel(r0["jvp"][1], jdalpha) <= TOL
    for r in results:
        for plain, out in zip(r["plain"], r["outs"]):
            assert np.array_equal(plain, out)


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("case", [
    c for c in QR_CASES
    if c[1] != np.float32 and (c[0], c[1]) != ("U", np.float64)],
    ids=lambda c: "-".join(str(v) for v in (c[0], np.dtype(c[1]).name,
                                             c[2], c[3])))
def test_qr_complex_and_padded_match_jax(ranks, P, case):
    """complex128 (the conjugate of jax.grad's gradient) and an n the
    engines pad (32 x 23: orthogonal columns appended, cut back)."""
    shape, dtype, layout, _, _ = case
    results = ranks(P)[("qr",) + case]
    _, jgrad, (jdH, jdalpha) = _jax_qr(shape, dtype)
    assert results[0]["grads"][0].shape == SHAPES[shape]
    assert _rel(results[0]["grads"][0], jgrad) <= TOL
    dH = _natural([r["jvp"][0] for r in results], SHAPES[shape], P, layout)
    assert _rel(dH, jdH) <= TOL and _rel(results[0]["jvp"][1], jdalpha) <= TOL


@pytest.mark.parametrize("P", RANKS)
def test_kernel_route_forward_is_unchanged_by_grad(ranks, P):
    """float32 with use_pallas="always" (the kernel's wrapper; its plain
    version on the CPU): with grad on, the same bits and the same wrapper
    calls as without; the gradient within 2x the single-device float32
    route's error against the float64 gradient."""
    ref = _single_factor_grad("U", np.float64)
    single = _rel(_single_factor_grad("U", np.float32, "always"), ref)
    for shape, dtype, layout, sched, pallas in QR_CASES:
        if dtype != np.float32:
            continue
        results = ranks(P)[("qr", shape, dtype, layout, sched, pallas)]
        for r in results:
            n_plain, n_grad = r["calls"]
            assert n_grad == n_plain
            for plain, out in zip(r["plain"], r["outs"]):
                assert out.dtype == np.float32 and np.array_equal(plain, out)
        assert sum(r["calls"][0] for r in results) > 0
        assert _rel(results[0]["grads"][0], ref) <= 2 * single, sched


@pytest.mark.parametrize("P", RANKS)
def test_conventions_sum_of_block_losses_not_p_times(ranks, P):
    """A store-order block is a sharded output: the ranks' block losses
    sum to JAX's loss over the global H (alpha, replicated, counted once),
    and every rank's gradient is the whole gradient of that one loss, not
    P times it."""
    results = ranks(P)[("qr", "U", np.float64, "cyclic", "default", "auto")]
    jloss, jgrad, _ = _jax_qr("U", np.float64)
    assert abs(_global(results, "losses") - jloss) <= TOL * abs(jloss)
    for r in results:
        assert _rel(r["grads"][0], jgrad) <= TOL
        assert _rel(r["grads"][0], P * jgrad) >= 0.5


@pytest.mark.parametrize("P", RANKS)
def test_natural_outputs_are_replicated(ranks, P):
    """sharded_blocked_qr's natural-order H and alpha are replicated: each
    rank's loss is the whole loss, used once (the gradient equals
    jax.grad's on every rank, not P times it)."""
    results = ranks(P)[("natural",)]
    jloss, jgrad, (jdH, jdalpha) = _jax_qr("U", np.float64)
    for r in results:
        assert abs(sum(r["losses"]) - jloss) <= TOL * abs(jloss)
        assert _rel(r["grads"][0], jgrad) <= TOL
        assert _rel(r["jvp"][0], jdH) <= TOL
        assert _rel(r["jvp"][1], jdalpha) <= TOL


@pytest.mark.parametrize("P", RANKS)
def test_adjoint_identity(ranks, P):
    """<w, J u> = <J^T w, u> through each route's jvp and backward, with
    the conventions' global sums (qr: the blocks summed, alpha once): to
    1e-9 in double, 1e-5 in float32."""
    run = ranks(P)
    for name, results in run.items():
        if name[0] == "qr":
            wJu = _global(results, "wJu")
        else:
            wJu = sum(results[0]["wJu"])
        gu = results[0]["gu"]
        tol = 1e-5 if results[0]["grads"][0].dtype == np.float32 else TOL
        assert abs(wJu - gu) <= tol * max(abs(gu), 1.0), name


# -- the column mesh: lstsq, fact.solve, sharded_solve ---------------------------

@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("case", LSTSQ_CASES,
                         ids=lambda c: f"{c[0]}-{np.dtype(c[1]).name}-{c[2]}")
def test_lstsq_matches_jax(ranks, P, case):
    """lstsq(mesh=), blocked (the closed-form rule on the sharded factors,
    in each layout and schedule) and unblocked (through the factorization
    and the solve): the gradients in A and b and the tangent of x within
    1e-9 of the JAX default's."""
    shape, dtype, _ = case
    r0 = ranks(P)[("lstsq",) + case][0]
    (gA, gb), dx = _jax_lstsq(shape, dtype)
    assert _rel(r0["grads"][0], gA) <= TOL
    assert _rel(r0["grads"][1], gb) <= TOL
    assert _rel(r0["jvp"][0], dx) <= TOL
    assert np.array_equal(r0["plain"][0], r0["outs"][0])


@pytest.mark.parametrize("P", RANKS)
def test_lstsq_rhs_only_with_several_columns(ranks, P):
    """b (m, 2) alone followed: its gradient is the single-device
    lstsq_diff's, and its tangent too."""
    A, b, _, _, wx, _, db = _inputs("U", np.float64)
    B = np.stack([b, 2 * b + 1], axis=1)
    Bt = torch.tensor(B, requires_grad=True)
    x = dt.lstsq_diff(torch.from_numpy(A), Bt, NB, device="cpu")
    _torch_loss((np.stack([wx, -wx], axis=1),), (x,)).backward()
    dx = torch.func.jvp(
        lambda B: dt.lstsq_diff(torch.from_numpy(A), B, NB, device="cpu"),
        (torch.from_numpy(B),),
        (torch.from_numpy(np.stack([db, db], axis=1)),))[1]
    r0 = ranks(P)[("lstsq_rhs",)][0]
    assert _rel(r0["grads"][0], Bt.grad.numpy()) <= TOL
    assert _rel(r0["jvp"][0], dx.numpy()) <= TOL


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("case", SOLVE_CASES,
                         ids=lambda c: f"{c[0]}-{np.dtype(c[1]).name}-{c[2]}")
def test_factorization_solve_matches_jax(ranks, P, case):
    """qr(A, mesh=).solve(b): A's gradient through the store-order (H,
    alpha) and the solve, and b's, within 1e-9 of jax.grad's of the JAX
    mesh route; the tangent of x of jax.jvp's."""
    shape, dtype, _ = case
    r0 = ranks(P)[("solve",) + case][0]
    (gA, gb), dx = _jax_solve(shape, dtype)
    assert _rel(r0["grads"][0], gA) <= TOL
    assert _rel(r0["grads"][1], gb) <= TOL
    assert _rel(r0["jvp"][0], dx) <= TOL


@pytest.mark.parametrize("P", RANKS)
def test_sharded_solve_in_natural_factors(ranks, P):
    """sharded_solve with a natural-order H (a replicated input): every
    rank's H, alpha and b gradients are the whole ones, as jax.grad of the
    JAX mesh solve of the same factors gives them."""
    H, alpha = _jax_qr_factors()
    _, b, _, _, wx, _, db = _inputs("U", np.float64)
    dH, dalpha = (_like(H.shape, np.float64, 87),
                  _like(alpha.shape, np.float64, 88))
    mesh = column_mesh(4)

    def fn(H, alpha, b):
        return jax_sharded_solve(H, alpha, b, mesh, block_size=NB)

    args = tuple(jnp.asarray(v) for v in (H, alpha, b))
    jg = jax.grad(lambda *a: _jloss((wx,), (fn(*a),)), (0, 1, 2))(*args)
    jdx = jax.jvp(fn, args, tuple(jnp.asarray(v) for v in (dH, dalpha,
                                                             db)))[1]
    for r in ranks(P)[("natural_solve",)]:
        for g, j in zip(r["grads"], jg):
            assert _rel(g, _port_grad(j)) <= TOL
        assert _rel(r["jvp"][0], jdx) <= TOL


# -- the row mesh ----------------------------------------------------------------

@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("case", ROW_CASES,
                         ids=lambda c: f"{np.dtype(c[0]).name}-{c[1]}")
def test_row_engines_match_jax(ranks, P, case):
    """lstsq(mesh=row_mesh, engine=tsqr|cholqr2|cholqr3): the closed-form
    rule with R and x replicated and each rank's rows gathered, within
    1e-9 of jax.grad / jax.jvp of the JAX row mesh."""
    dtype, engine, comms = case
    r0 = ranks(P)[("rows",) + case][0]
    (gA, gb), dx = _jax_rows(dtype, engine)
    assert _rel(r0["grads"][0], gA) <= TOL
    assert _rel(r0["grads"][1], gb) <= TOL
    assert _rel(r0["jvp"][0], dx) <= TOL


@pytest.mark.parametrize("P", RANKS)
@pytest.mark.parametrize("engine,comms", COMPRESSED)
def test_compressed_row_engines_within_1e3(ranks, P, engine, comms):
    """A compressed wire: the forward's CSNE sweeps solve for w too, so the
    gradient is within 1e-3 of the exact one (printed beside JAX's own
    distance, which differentiates through the rounding)."""
    r0 = ranks(P)[("rows", np.float64, engine, comms)][0]
    (gA, gb), _ = _jax_rows(np.float64, engine)
    (jA, jb), _ = _jax_rows(np.float64, engine, comms)
    port, jax_dist = _rel(r0["grads"][0], gA), _rel(jA, gA)
    print(f"{engine} comms={comms} P={P}: port {port:.3g} "
          f"(b {_rel(r0['grads'][1], gb):.3g}), JAX {jax_dist:.3g}")
    assert port <= 1e-3 and _rel(r0["grads"][1], gb) <= 1e-3


def test_wy_vjp_is_additive_over_column_blocks():
    """The reason the Y-cotangents may be summed at the owner: _wy_vjp's
    return is a sum over the trailing columns, so the column blocks' parts
    add up to the whole's (and each block's C and O come out as the
    whole's)."""
    rng = np.random.default_rng(89)
    m, nb, c = 20, 4, 9
    Y = torch.from_numpy(np.tril(rng.standard_normal((m, nb))))
    C = torch.from_numpy(rng.standard_normal((m, c)))
    O = torch.from_numpy(rng.standard_normal((m, c)))
    Cw, Ow = C.clone(), O.clone()
    whole = _wy_vjp(Y, Cw, Ow, "highest")
    parts = torch.zeros_like(whole)
    for cols in (slice(0, 2), slice(2, 7), slice(7, 9)):
        Cp, Op = C[:, cols].clone(), O[:, cols].clone()
        parts += _wy_vjp(Y, Cp, Op, "highest")
        assert torch.allclose(Cp, Cw[:, cols], rtol=0, atol=1e-13)
        assert torch.allclose(Op, Ow[:, cols], rtol=0, atol=1e-13)
    assert _rel(parts.numpy(), whole.numpy()) <= 1e-14



def test_census_of_every_thread_sees_a_backward_thread():
    """Autograd runs a backward on CUDA tensors on a thread of its own: a
    census scope opened with every_thread=True counts that thread's
    collectives, a scope of the calling thread alone does not."""
    import threading

    from dhqr_tpu_torch.analysis.jaxpr_pass import solo_meshes
    from dhqr_tpu_torch.parallel import wire

    with solo_meshes(torch.device("cpu")) as (meshes, _):
        mesh = meshes["cols"]
        with wire.census() as mine, \
                wire.census(every_thread=True) as every:
            worker = threading.Thread(
                target=lambda: wire.wire_psum(torch.ones(3), mesh))
            worker.start()
            worker.join()
            wire.wire_psum(torch.ones(2), mesh)
    assert [e["shapes"] for e in every.entries] == [[[3]], [[2]]]
    assert [e["shapes"] for e in mine.entries] == [[[2]]]
