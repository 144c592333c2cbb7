"""PyTorch port: ``ops/differentiable.py`` (``lstsq_diff`` as a
``torch.autograd.Function``) and gradients through the public ``lstsq``,
against ``jax.grad`` / ``jax.jvp`` of ``dhqr_tpu``.

Tolerances: float64 gradients and tangents match the JAX package's to
1e-9 (relative, both closed-form rules from one factorization), float32 to
2e-3 (the rules amplify f32 rounding by ~cond(A)^2 at these shapes).
Complex gradients are held by ``torch.autograd.gradcheck`` only: PyTorch
and JAX use different conjugation conventions for them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel  # noqa: E402

TOL = {np.float64: 1e-9, np.float32: 2e-3}


def _rel(x, ref):
    ref = np.asarray(ref)
    return np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)


def _weights(shape, dtype, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _torch_grads(fn, A, b, w):
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    loss = torch.sum(fn(At, bt) * torch.from_numpy(w))
    loss.backward()
    return At.grad.numpy(), bt.grad.numpy()


def _jax_grads(fn, A, b, w):
    gA, gb = jax.grad(lambda A, b: jnp.sum(fn(A, b) * w), argnums=(0, 1))(
        jnp.asarray(A), jnp.asarray(b))
    return np.asarray(gA), np.asarray(gb)


@pytest.mark.parametrize("rhs", ["vector", "block"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lstsq_diff_gradients_match_jax(dtype, rhs):
    A, b = random_problem(60, 20, dtype, seed=41)
    if rhs == "block":
        b = np.stack([b, b[::-1]], axis=1)
    w = _weights((20,) + b.shape[1:], dtype, seed=42)
    gA, gb = _torch_grads(lambda A, b: dt.lstsq_diff(A, b, 8, device="cpu"),
                          A, b, w)
    jA, jb = _jax_grads(lambda A, b: dhqr_tpu.lstsq_diff(A, b, 8), A, b, w)
    assert _rel(gA, jA) <= TOL[dtype] and _rel(gb, jb) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lstsq_diff_jvp_matches_jax(dtype):
    A, b = random_problem(50, 12, dtype, seed=43)
    dA = _weights(A.shape, dtype, seed=44)
    db = _weights(b.shape, dtype, seed=45)
    x, dx = torch.func.jvp(
        lambda A, b: dt.lstsq_diff(A, b, 4, refine=1, device="cpu"),
        tuple(torch.from_numpy(v) for v in (A, b)),
        tuple(torch.from_numpy(v) for v in (dA, db)))
    xj, dxj = jax.jvp(lambda A, b: dhqr_tpu.lstsq_diff(A, b, 4, refine=1),
                      (jnp.asarray(A), jnp.asarray(b)),
                      (jnp.asarray(dA), jnp.asarray(db)))
    assert _rel(x.numpy(), xj) <= TOL[dtype] / 10
    assert _rel(dx.numpy(), dxj) <= TOL[dtype]


@pytest.mark.parametrize("refine", [0, 1, 2])
def test_public_lstsq_gradients_match_jax(refine):
    """torch.autograd through dt.lstsq (blocked, m >= n) at every refine,
    against jax.grad through dhqr_tpu.lstsq."""
    A, b = random_problem(72, 24, np.float64, seed=46)
    w = _weights((24,), np.float64, seed=47)
    gA, gb = _torch_grads(lambda A, b: dt.lstsq(A, b, block_size=8,
                                                refine=refine, device="cpu"),
                          A, b, w)
    jA, jb = _jax_grads(lambda A, b: dhqr_tpu.lstsq(A, b, block_size=8,
                                                    refine=refine), A, b, w)
    assert _rel(gA, jA) <= 1e-9 and _rel(gb, jb) <= 1e-9


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("rhs", [(), (2,)])
def test_gradcheck_with_forward_ad(dtype, rhs):
    g = torch.Generator().manual_seed(48)
    A = torch.randn(8, 3, dtype=dtype, generator=g, requires_grad=True)
    b = torch.randn((8,) + rhs, dtype=dtype, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda A, b: dt.lstsq_diff(A, b, 2, refine=1, device="cpu"), (A, b),
        check_forward_ad=True)
    assert torch.autograd.gradcheck(
        lambda A, b: dt.lstsq(A, b, block_size=2, device="cpu"), (A, b),
        check_forward_ad=True)


def test_adjoint_identity_between_jvp_and_backward():
    """<w, J u> = <J^T w, u> with J the derivative of x(A, b): jvp and
    backward are adjoint to 1e-12 (relative)."""
    A, b = random_problem(40, 10, np.float64, seed=49)
    u = (_weights(A.shape, np.float64, 50), _weights(b.shape, np.float64, 51))
    w = torch.from_numpy(_weights((10,), np.float64, 52))
    At, bt = torch.tensor(A, requires_grad=True), torch.tensor(b,
                                                             requires_grad=True)
    fn = lambda A, b: dt.lstsq_diff(A, b, 4, device="cpu")  # noqa: E731
    _, Ju = torch.func.jvp(fn, (At.detach(), bt.detach()),
                           tuple(torch.from_numpy(v) for v in u))
    torch.sum(fn(At, bt) * w).backward()
    lhs = float(torch.sum(w * Ju))
    rhs = float(np.sum(At.grad.numpy() * u[0]) + np.sum(bt.grad.numpy() * u[1]))
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_forward_pass_is_the_blocked_solve():
    """lstsq_diff's forward is the blocked engine's solve, bit for bit, and
    the paths outside it refuse inputs that require grad."""
    A, b = random_problem(48, 16, np.float32, seed=53)
    x = dt.lstsq_diff(A, b, 8, refine=1, device="cpu")
    fact = dt.qr(A, block_size=8, device="cpu")
    fact.matrix = torch.from_numpy(A)
    assert torch.equal(x, fact.solve(b, refine=1))
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b)
    for call in (lambda: dt.lstsq(At, bt, blocked=False, device="cpu"),
                 lambda: dt.lstsq(At, bt, engine="tsqr", device="cpu"),
                 lambda: dt.lstsq(At[:8], bt[:8], device="cpu"),
                 lambda: dt.qr(At, device="cpu")):
        with pytest.raises(dt.NotPortedError, match="gradients"):
            call()
    with torch.no_grad():
        dt.lstsq(At, bt, blocked=False, device="cpu")
    for sched in ({"lookahead": True}, {"agg_panels": 2}):  # now ported
        torch.testing.assert_close(
            dt.lstsq_diff(A, b, 8, device="cpu", **sched),
            dt.lstsq_diff(A, b, 8, device="cpu"), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="agg_panels must be >= 2"):
        dt.lstsq_diff(A, b, 8, agg_panels=1, device="cpu")
    with pytest.raises(ValueError):
        dt.lstsq_diff(A[:8], b[:8], device="cpu")


_FACTORING_CALLS = {  # every exported entry point that factors A outside
    # lstsq_diff, by the plain panel loop and by the kernel's wrapper
    "qr": lambda A, b: dt.qr(A, device="cpu"),
    "qr_kernel": lambda A, b: dt.qr(A, use_pallas="always", device="cpu"),
    "qr_explicit": lambda A, b: dt.qr_explicit(A, device="cpu"),
    "blocked_householder_qr": lambda A, b: dt.blocked_householder_qr(
        A, 8, device="cpu"),
    "householder_qr": lambda A, b: dt.householder_qr(A, device="cpu"),
    "lstsq_unblocked": lambda A, b: dt.lstsq(A, b, blocked=False,
                                             device="cpu"),
    "lstsq_minimum_norm": lambda A, b: dt.lstsq(A[:8], b[:8], device="cpu"),
    "tsqr_lstsq": lambda A, b: dt.tsqr_lstsq(A, b, n_blocks=2, device="cpu"),
    "tsqr_lstsq_kernel": lambda A, b: dt.tsqr_lstsq(
        A, b, n_blocks=2, use_pallas="always", device="cpu"),
    "tsqr_r": lambda A, b: dt.tsqr_r(A, n_blocks=2, device="cpu"),
    "panel_qr_kernel": lambda A, b: hopper_panel.panel_qr_kernel(A),
}


@pytest.mark.parametrize("name", sorted(_FACTORING_CALLS))
def test_factoring_entry_points_refuse_a_matrix_that_requires_grad(name):
    """The panel engines (plain loop, kernel wrapper) own the refusal, so
    the exported ops raise as the routers do; with grad off they run."""
    A, b = random_problem(48, 16, np.float32, seed=54)
    At = torch.tensor(A, requires_grad=True)
    call = _FACTORING_CALLS[name]
    with pytest.raises(dt.NotPortedError, match="gradients"):
        call(At, torch.from_numpy(b))
    with torch.no_grad():
        call(At, torch.from_numpy(b))


@pytest.mark.parametrize("name", ["lstsq_unblocked", "tsqr_lstsq"])
def test_rhs_gradient_outside_lstsq_diff_matches_it(name):
    """A b that requires grad (A does not) needs no factorization gradient:
    the unblocked engine and TSQR give lstsq_diff's b-gradient to 1e-12 in
    float64."""
    A, b = random_problem(48, 16, np.float64, seed=55)
    w = torch.from_numpy(_weights((16,), np.float64, seed=56))

    def grad_b(fn):
        bt = torch.tensor(b, requires_grad=True)
        torch.sum(fn(torch.from_numpy(A), bt) * w).backward()
        return bt.grad.numpy()

    ref = grad_b(lambda A, b: dt.lstsq_diff(A, b, 8, device="cpu"))
    assert _rel(grad_b(_FACTORING_CALLS[name]), ref) <= 1e-12
