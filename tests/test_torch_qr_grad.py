"""PyTorch port: the differentiable Householder factorization
(``ops/differentiable.householder_factor``, its ``autograd.Function``)
against ``jax.jvp`` / ``jax.grad`` of ``dhqr_tpu``, ``gradcheck`` with
forward AD, the schedules and panel engines, the zero-column gate, the
guarded ladder, the ``donate`` refusal, and the forward with grad on.

Tolerances: float64 and complex128 tangents and gradients to 1e-9
(relative) of the JAX package's (complex gradients against the conjugate
of ``jax.grad``'s, PyTorch's convention); every schedule and panel engine
to 1e-9 of the default schedule's gradient.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
from dhqr_tpu_torch.ops import blocked  # noqa: E402
from dhqr_tpu_torch.ops.differentiable import householder_factor  # noqa: E402

TOL = 1e-9
DTYPES = [np.float64, np.complex128]


def _rel(x, ref):
    x, ref = np.asarray(x), np.asarray(ref)
    return np.linalg.norm(x - ref) / np.linalg.norm(ref)


def _like(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _packed(fact):
    return fact.H, fact.alpha


_JVP_ROUTES = {  # the port's call and the JAX package's, tuples of outputs
    "qr": (lambda A, b: _packed(dt.qr(A, block_size=8, device="cpu")),
           lambda A, b: _packed(dhqr_tpu.qr(A, block_size=8))),
    "qr_explicit": (lambda A, b: dt.qr_explicit(A, block_size=8,
                                                device="cpu"),
                    lambda A, b: dhqr_tpu.qr_explicit(A, block_size=8)),
    "lstsq_unblocked": (
        lambda A, b: (dt.lstsq(A, b, blocked=False, device="cpu"),),
        lambda A, b: (dhqr_tpu.lstsq(A, b, blocked=False),)),
}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", sorted(_JVP_ROUTES))
def test_jvp_matches_jax(name, dtype):
    A, b = random_problem(40, 12, dtype, seed=60)
    dA, db = _like(A.shape, dtype, 61), _like(b.shape, dtype, 62)
    port, ref = _JVP_ROUTES[name]
    outs, touts = torch.func.jvp(
        port, tuple(torch.from_numpy(v) for v in (A, b)),
        tuple(torch.from_numpy(v) for v in (dA, db)))
    jouts, jtouts = jax.jvp(ref, (jnp.asarray(A), jnp.asarray(b)),
                            (jnp.asarray(dA), jnp.asarray(db)))
    for o, t, jo, jt in zip(outs, touts, jouts, jtouts):
        assert _rel(o.numpy(), jo) <= TOL
        assert _rel(t.numpy(), jt) <= TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("shape,block_size", [((8, 3), 2), ((12, 5), 2),
                                              ((12, 5), 8)])
@pytest.mark.parametrize("unblocked", [False, True])
def test_gradcheck_with_forward_ad(dtype, shape, block_size, unblocked):
    g = torch.Generator().manual_seed(63)
    A = torch.randn(shape, dtype=dtype, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda A: householder_factor(A, block_size, unblocked=unblocked),
        (A,), check_forward_ad=True)


def _loss_weights(m, n, dtype, seed):
    return torch.from_numpy(_like((m, n), dtype, seed)), \
        torch.from_numpy(_like((n,), dtype, seed + 1))


def _grad(fn, A, W, w):
    """A's gradient of Re<W, H> + Re<w, alpha> with (H, alpha) = fn(A)."""
    At = torch.tensor(A, requires_grad=True)
    H, alpha = fn(At)
    (torch.sum(torch.real(W.conj() * H))
     + torch.sum(torch.real(w.conj() * alpha))).backward()
    return At.grad.numpy()


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("column", [0, 5])
def test_zero_column_gives_finite_equal_cotangents(dtype, column):
    """A zero column closes the reflector's gates (denom == 0): the port's
    cotangent is finite on every route and the same on each, and equal to
    the JAX package's wherever that one is finite (jax.grad's norm gives
    NaN in the zero column and the columns left of it: the derivative of
    sqrt at 0)."""
    A, _ = random_problem(40, 12, dtype, seed=64)
    A[:, column] = 0
    W, w = _loss_weights(40, 12, dtype, 65)
    routes = {
        "unblocked": lambda A: dt.householder_qr(A, device="cpu"),
        "blocked": lambda A: _packed(dt.qr(A, block_size=4, device="cpu")),
        "lookahead": lambda A: _packed(dt.qr(A, block_size=4, lookahead=True,
                                             device="cpu")),
    }
    grads = {k: _grad(fn, A, W, w) for k, fn in routes.items()}
    for g in grads.values():
        assert np.all(np.isfinite(g))
        assert _rel(g, grads["unblocked"]) <= TOL

    def jloss(A):
        f = dhqr_tpu.qr(A, block_size=4)
        return jnp.sum(jnp.real(jnp.conj(W.numpy()) * f.H)) \
            + jnp.sum(jnp.real(jnp.conj(w.numpy()) * f.alpha))

    jg = np.conj(np.asarray(jax.grad(jloss)(jnp.asarray(A))))
    finite = np.isfinite(jg)
    assert finite[:, column + 1:].all()
    assert _rel(grads["blocked"][finite], jg[finite]) <= TOL
    _, (dH, dalpha) = torch.func.jvp(
        lambda A: dt.householder_qr(A, device="cpu"), (torch.from_numpy(A),),
        (torch.from_numpy(_like(A.shape, dtype, 66)),))
    assert torch.isfinite(dH).all() and torch.isfinite(dalpha).all()


_SCHEDULES = {
    "lookahead": {"lookahead": True},
    "agg_panels2": {"agg_panels": 2},
    "agg_panels3": {"agg_panels": 3},
    "recursive": {"panel_impl": "recursive"},
    "unblocked": {"blocked": False},
}


@pytest.mark.parametrize("name", sorted(_SCHEDULES))
def test_schedules_and_panel_engines_give_the_default_gradient(name):
    """Every schedule and the recursive panels compute the same map A ->
    (H, alpha), so each gives the default schedule's gradient to 1e-9 (as
    the JAX package's tests/test_blocked.py holds its schedules')."""
    A, _ = random_problem(64, 40, np.float64, seed=67)
    W, w = _loss_weights(64, 40, np.float64, 68)
    opts = _SCHEDULES[name]
    bs = {} if opts.get("blocked") is False else {"block_size": 8}
    ref = _grad(lambda A: _packed(dt.qr(A, block_size=8, device="cpu")),
                A, W, w)
    got = _grad(lambda A: _packed(dt.qr(A, device="cpu", **bs, **opts)),
                A, W, w)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("impl", ["reconstruct", "reconstruct:16"])
def test_reconstruct_panels_differentiate_like_jax(impl):
    """The reconstruct panels pick R's diagonal signs from Q's diagonal,
    not from the pivot as the loop does, so their packed factors are
    another map than the loop's (some columns' signs differ, in both
    packages). The derivative follows the signs the factors carry: the
    packed-factor gradient equals jax.grad's through the JAX package's
    reconstruct engine, and the gradient of what the signs leave alone (a
    solve, Q R) equals the default schedule's."""
    A, b = random_problem(64, 40, np.float64, seed=67)
    W, w = _loss_weights(64, 40, np.float64, 68)
    got = _grad(lambda A: _packed(dt.qr(A, block_size=8, panel_impl=impl,
                                        device="cpu")), A, W, w)

    def jloss(A):
        f = dhqr_tpu.qr(A, block_size=8, panel_impl=impl)
        return jnp.sum(W.numpy() * f.H) + jnp.sum(w.numpy() * f.alpha)

    assert _rel(got, np.asarray(jax.grad(jloss)(jnp.asarray(A)))) <= TOL
    V = torch.from_numpy(_like((64, 40), np.float64, 69))

    def invariant(**opts):
        At = torch.tensor(A, requires_grad=True)
        f = dt.qr(At, block_size=8, device="cpu", **opts)
        (torch.sum(f.solve(b) * w)
         + torch.sum(V * (f.q_columns() @ f.r_matrix()))).backward()
        return At.grad.numpy()

    assert _rel(invariant(panel_impl=impl), invariant()) <= TOL


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_guarded_qr_differentiates_like_jax(dtype):
    """guarded_qr composes: its factorization's gradient (every guard mode,
    on a matrix each accepts at the first rung) equals qr's, and jax.grad's
    through the JAX package's guarded_qr (whose "full" mode converts its
    condition bound to a float, which jax.grad cannot trace)."""
    A, b = random_problem(48, 16, dtype, seed=69)
    W, w = _loss_weights(48, 16, dtype, 70)
    ref = _grad(lambda A: _packed(dt.qr(A, block_size=8, device="cpu")),
                A, W, w)
    for mode in ("screen", "fallback", "full"):
        got = _grad(lambda A: _packed(dt.guarded_qr(
            A, block_size=8, guards=mode, device="cpu").factorization),
            A, W, w)
        assert _rel(got, ref) <= TOL
        got = _grad(lambda A: _packed(dt.qr(A, block_size=8, guards=mode,
                                            device="cpu")), A, W, w)
        assert _rel(got, ref) <= TOL

    def jloss(A):
        f = dhqr_tpu.guarded_qr(A, block_size=8,
                                guards="fallback").factorization
        return jnp.sum(jnp.real(jnp.conj(W.numpy()) * f.H)) \
            + jnp.sum(jnp.real(jnp.conj(w.numpy()) * f.alpha))

    assert _rel(ref, np.conj(np.asarray(jax.grad(jloss)(jnp.asarray(A))))) \
        <= TOL


def test_donate_refuses_a_matrix_autograd_follows():
    """donate=True factors in A's storage, a tensor autograd tracks: the
    blocked engine and qr raise ValueError and say why, in both modes;
    without grad donation still factors in place."""
    A, _ = random_problem(24, 8, np.float64, seed=71)
    At = torch.tensor(A, requires_grad=True)
    for call in (lambda A: dt.qr(A, donate=True, device="cpu").alpha,
                 lambda A: dt.blocked_householder_qr(A, 4, donate=True,
                                                     device="cpu")[1]):
        with pytest.raises(ValueError, match="autograd"):
            call(At)
        with pytest.raises(ValueError, match="autograd"):
            torch.func.jvp(call, (torch.from_numpy(A),),
                           (torch.ones(24, 8, dtype=torch.float64),))
    D = torch.from_numpy(A.copy())
    H, _ = dt.blocked_householder_qr(D, 4, donate=True, device="cpu")
    assert H.data_ptr() == D.data_ptr()


def _counting_kernel(monkeypatch):
    """Count the kernel wrapper's calls (on the CPU it runs the plain
    version, so the launch counters stay at 0)."""
    calls = []

    def counting(real):
        def wrapper(*args, **kwargs):
            calls.append(args[0].shape)
            return real(*args, **kwargs)
        return wrapper

    for name in ("_panel_qr_kernel", "_panel_qr_kernel_in_place"):
        monkeypatch.setattr(blocked, name, counting(getattr(blocked, name)))
    return calls


_FORWARD_ROUTES = {
    "qr": lambda A: _packed(dt.qr(A, block_size=8, device="cpu")),
    "qr_kernel": lambda A: _packed(dt.qr(A, block_size=8,
                                         use_pallas="always", device="cpu")),
    "qr_kernel_lookahead": lambda A: _packed(dt.qr(
        A, block_size=8, use_pallas="always", lookahead=True, device="cpu")),
    "qr_agg": lambda A: _packed(dt.qr(A, block_size=8, agg_panels=2,
                                      device="cpu")),
    "householder_qr": lambda A: dt.householder_qr(A, device="cpu"),
    "tsqr_r": lambda A: (dt.tsqr_r(A, n_blocks=2, block_size=8,
                                   use_pallas="always", device="cpu"),),
}


@pytest.mark.parametrize("name", sorted(_FORWARD_ROUTES))
def test_forward_with_grad_is_the_forward_without(name, monkeypatch):
    """With grad on, the factorization's forward is the engine's, bit for
    bit, with the same kernel calls; autograd keeps (H, alpha) of a
    factorization and no per-column state (m n + n saved entries)."""
    A, _ = random_problem(48, 24, np.float32, seed=72)
    calls = _counting_kernel(monkeypatch)
    with torch.no_grad():
        ref = _FORWARD_ROUTES[name](torch.from_numpy(A))
    n_ref = len(calls)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    At = torch.tensor(A, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        got = _FORWARD_ROUTES[name](At)
    assert len(calls) == 2 * n_ref
    for g, r in zip(got, ref):
        assert g.requires_grad and torch.equal(g.detach(), r)
    if name in ("qr", "qr_kernel", "qr_kernel_lookahead", "qr_agg",
                "householder_qr"):
        assert sum(saved) <= 48 * 24 + 24
        sum(torch.sum(g) for g in got).backward()
        assert torch.isfinite(At.grad).all()


_APPLIES = ("apply_qt", "apply_q", "back_substitute", "solve_least_squares")


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("name", _APPLIES)
def test_solve_stage_differentiates_in_H_like_jax(name, dtype):
    """The solve stage's entry points take packed factors: their gradients
    in H, alpha and b (each a leaf here) equal jax.grad's."""
    A, b = random_problem(40, 12, dtype, seed=73)
    fact = dhqr_tpu.qr(jnp.asarray(A))
    H, alpha = np.asarray(fact.H), np.asarray(fact.alpha)
    out = 12 if name in ("back_substitute", "solve_least_squares") else 40
    wt = _like((out,), dtype, 74)
    leaves = [torch.tensor(v, requires_grad=True) for v in (H, alpha, b)]
    y = getattr(dt, name)(*leaves, device="cpu")
    torch.sum(torch.real(torch.from_numpy(wt).conj() * y)).backward()

    def jloss(H, alpha, b):
        return jnp.sum(jnp.real(jnp.conj(wt)
                                * getattr(dhqr_tpu, name)(H, alpha, b)))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(v)
                                              for v in (H, alpha, b)))
    for leaf, g in zip(leaves, jg):
        g = np.conj(np.asarray(g))
        if leaf.grad is None:
            assert not np.any(g)
        else:
            assert _rel(leaf.grad.numpy(), g) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("alpha", [None, -1])
def test_bf16_pass_products_differentiate_at_their_precision(alpha,
                                                             precision,
                                                             dtype):
    """gemm's bf16-pass products (``matmul``, and ``addmm`` c + alpha a b;
    on the card a bf16 GEMM with f32 output, which has no derivative of
    its own) are differentiable: the forward is the same bits with grad
    on, and the cotangents and tangents, products at the same precision,
    stay within the passes' rounding of the exact ones (3 passes ~1e-5, 1
    pass ~4e-3)."""
    from dhqr_tpu_torch.ops import gemm

    tol = {"high": 1e-4, "default": 2e-2}[precision]
    g = torch.Generator().manual_seed(75)
    a, b, c, W, da, db = (torch.randn(shape, dtype=dtype, generator=g)
                          for shape in ((24, 16), (16, 8), (24, 8), (24, 8),
                                        (24, 16), (16, 8)))
    if alpha is None:
        def product(a, b):
            return gemm.matmul(a, b, precision)
        scale = 1
    else:
        def product(a, b):
            return gemm.addmm(c, a, b, precision, alpha=alpha)
        scale = alpha

    def wide(t):
        return t.to(torch.complex128).numpy()

    with torch.no_grad():
        ref = product(a, b)
    at, bt = a.clone().requires_grad_(), b.clone().requires_grad_()
    y = product(at, bt)
    assert torch.equal(y.detach(), ref)
    torch.sum(torch.real(W.conj() * y)).backward()
    assert _rel(wide(at.grad), scale * wide(W) @ wide(b).conj().T) <= tol
    assert _rel(wide(bt.grad), scale * wide(a).conj().T @ wide(W)) <= tol
    _, ty = torch.func.jvp(product, (a, b), (da, db))
    assert _rel(wide(ty), scale * (wide(da) @ wide(b) + wide(a) @ wide(db))
                ) <= tol


def test_bf16_apply_precision_solve_differentiates():
    """A factorization whose solves apply Q^H in bf16 passes differentiates
    through them: float32 gradients within 2e-3 of the float64 ones."""
    A, b = random_problem(48, 16, np.float32, seed=76)
    w = torch.from_numpy(_like((16,), np.float32, 77))

    def grad(A, b, **kw):
        At = torch.tensor(A, requires_grad=True)
        torch.sum(w.to(At.dtype) * dt.qr(At, block_size=8, device="cpu",
                                         **kw).solve(b)).backward()
        return At.grad.numpy()

    ref = grad(A.astype(np.float64), b.astype(np.float64))
    assert _rel(grad(A, b, apply_precision="high"), ref) <= 2e-3
