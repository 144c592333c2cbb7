"""PyTorch port: ``ops/differentiable.py`` (``lstsq_diff`` as a
``torch.autograd.Function``) and gradients through the public ``lstsq``,
against ``jax.grad`` / ``jax.jvp`` of ``dhqr_tpu``.

Tolerances: float64 gradients and tangents match the JAX package's to
1e-9 (relative, both closed-form rules from one factorization), float32 to
2e-3 (the rules amplify f32 rounding by ~cond(A)^2 at these shapes).
Complex gradients match too, under the two packages' conventions: for a
real loss, PyTorch's ``.grad`` is the complex conjugate of ``jax.grad``'s,
so complex128 is held to 1e-9 against ``np.conj`` of the JAX gradient.

The factoring entry points outside ``lstsq_diff`` (``qr``, ``qr_explicit``,
``householder_qr``, ``blocked_householder_qr``, the unblocked and the
minimum-norm ``lstsq``, TSQR) differentiate through
``ops.differentiable.householder_factor`` and are held to ``jax.grad`` of
the same ``dhqr_tpu`` call; the kernel routes (``use_pallas="always"``,
the kernel's plain version on the CPU) to JAX's ``use_pallas="never"``.
The raw kernel wrapper, the batched engine and the mesh engines refuse a
matrix that autograd follows.
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
    the paths outside it give the same forward with and without grad."""
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
                 lambda: dt.qr(At, device="cpu").H):
        y = call()
        assert y.requires_grad
        with torch.no_grad():
            assert torch.equal(y, call())
    for sched in ({"lookahead": True}, {"agg_panels": 2}):  # now ported
        torch.testing.assert_close(
            dt.lstsq_diff(A, b, 8, device="cpu", **sched),
            dt.lstsq_diff(A, b, 8, device="cpu"), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="agg_panels must be >= 2"):
        dt.lstsq_diff(A, b, 8, agg_panels=1, device="cpu")
    with pytest.raises(ValueError):
        dt.lstsq_diff(A[:8], b[:8], device="cpu")


def _packed(fact, b):
    """The packed factors and a solve of a factorization."""
    return fact.H, fact.alpha, fact.solve(b)


_FACTORING_CALLS = {  # every exported entry point that factors A outside
    # lstsq_diff, by the plain panel loop and by the kernel's route: the
    # port's call and the JAX package's, each returning a tuple of outputs
    "qr": (lambda A, b: _packed(dt.qr(A, device="cpu"), b),
           lambda A, b: _packed(dhqr_tpu.qr(A), b)),
    "qr_kernel": (
        lambda A, b: _packed(dt.qr(A, use_pallas="always", device="cpu"), b),
        lambda A, b: _packed(dhqr_tpu.qr(A, use_pallas="never"), b)),
    "qr_explicit": (lambda A, b: dt.qr_explicit(A, device="cpu"),
                    lambda A, b: dhqr_tpu.qr_explicit(A)),
    "blocked_householder_qr": (
        lambda A, b: dt.blocked_householder_qr(A, 8, device="cpu"),
        lambda A, b: dhqr_tpu.blocked_householder_qr(A, 8)),
    "householder_qr": (lambda A, b: dt.householder_qr(A, device="cpu"),
                       lambda A, b: dhqr_tpu.householder_qr(A)),
    "lstsq_unblocked": (
        lambda A, b: (dt.lstsq(A, b, blocked=False, device="cpu"),),
        lambda A, b: (dhqr_tpu.lstsq(A, b, blocked=False),)),
    "lstsq_minimum_norm": (
        lambda A, b: (dt.lstsq(A[:8], b[:8], device="cpu"),),
        lambda A, b: (dhqr_tpu.lstsq(A[:8], b[:8]),)),
    "tsqr_lstsq": (
        lambda A, b: (dt.tsqr_lstsq(A, b, n_blocks=2, device="cpu"),),
        lambda A, b: (dhqr_tpu.tsqr_lstsq(A, b, n_blocks=2),)),
    "tsqr_lstsq_kernel": (
        lambda A, b: (dt.tsqr_lstsq(A, b, n_blocks=2, use_pallas="always",
                                    device="cpu"),),
        lambda A, b: (dhqr_tpu.tsqr_lstsq(A, b, n_blocks=2,
                                          use_pallas="never"),)),
    "tsqr_r": (lambda A, b: (dt.tsqr_r(A, n_blocks=2, device="cpu"),),
               lambda A, b: (dhqr_tpu.tsqr_r(A, n_blocks=2),)),
}
_KERNEL_ROUTES = ("qr_kernel", "tsqr_lstsq_kernel")  # f32 / c64 only
_PARITY_CASES = [(name, dtype) for name in sorted(_FACTORING_CALLS)
                 for dtype in ((np.float32, np.complex64)
                               if name in _KERNEL_ROUTES else
                               (np.float64, np.complex128))] + [
    ("qr", np.float32), ("tsqr_lstsq", np.float32)]
_GRAD_TOL = {np.float64: 1e-9, np.complex128: 1e-9, np.float32: 2e-3,
             np.complex64: 2e-3}


def _cotangents(outs, seed):
    """One seeded weight per output, of its shape and dtype."""
    rng = np.random.default_rng(seed)
    ws = []
    for o in outs:
        o = np.asarray(o.detach() if isinstance(o, torch.Tensor) else o)
        w = rng.standard_normal(o.shape)
        if np.iscomplexobj(o):
            w = w + 1j * rng.standard_normal(o.shape)
        ws.append(w.astype(o.dtype))
    return ws


@pytest.mark.parametrize("name,dtype", _PARITY_CASES,
                         ids=[f"{n}-{np.dtype(d).name}"
                              for n, d in _PARITY_CASES])
def test_factoring_entry_points_differentiate_like_jax(name, dtype):
    """The loss sum_i Re<W_i, out_i> over a route's outputs: A's and b's
    gradients equal the conjugate of jax.grad's through the same dhqr_tpu
    call (equal for real dtypes)."""
    A, b = random_problem(48, 16, dtype, seed=54)
    port, ref = _FACTORING_CALLS[name]
    ws = _cotangents(port(torch.from_numpy(A), torch.from_numpy(b)), 57)
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    outs = port(At, bt)
    sum(torch.sum(torch.real(torch.from_numpy(w).conj() * o))
        for w, o in zip(ws, outs)).backward()

    def loss(A, b):
        return sum(jnp.sum(jnp.real(jnp.conj(w) * o))
                   for w, o in zip(ws, ref(A, b)))

    jA, jb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(b))
    assert _rel(At.grad.numpy(), np.conj(np.asarray(jA))) <= _GRAD_TOL[dtype]
    if bt.grad is not None:
        assert _rel(bt.grad.numpy(), np.conj(np.asarray(jb))) \
            <= _GRAD_TOL[dtype]
    else:  # a factor-only route: b does not reach the outputs
        assert not np.any(np.asarray(jb))


def _batched_engine(A, b):
    from dhqr_tpu_torch.ops import blocked

    return blocked._batched_qr_impl(A[None].clone(), 8)


_REFUSING_CALLS = {  # where autograd does not follow, by design
    "panel_qr_kernel": lambda A, b: hopper_panel.panel_qr_kernel(A),
    "batched_qr": lambda A, b: dt.batched_qr([A], device="cpu"),
    "batched_lstsq": lambda A, b: dt.batched_lstsq([A], [b], device="cpu"),
    "batched_engine": _batched_engine,
}


@pytest.mark.parametrize("name", sorted(_REFUSING_CALLS))
def test_factoring_entry_points_refuse_a_matrix_that_requires_grad(name):
    """The raw kernel wrapper (a raw-pointer write) and the batched engine
    (in place on a donated stack; jax.grad fails there too) refuse, and
    say why; with grad off they run."""
    A, b = random_problem(48, 16, np.float32, seed=54)
    At = torch.tensor(A, requires_grad=True)
    call = _REFUSING_CALLS[name]
    with pytest.raises(dt.NotPortedError, match="no counterpart") as err:
        call(At, torch.from_numpy(b))
    assert "gradients through" in str(err.value) and err.value.reason
    with torch.no_grad():
        call(At, torch.from_numpy(b))


def _mesh_refusals(cols, rows, At, bt):
    """The mesh routes that refuse a matrix autograd follows, each with the
    JAX package's error that its reason quotes."""
    from dhqr_tpu_torch import armor

    def armed(call):
        def run():
            with armor.armored():
                return call()
        return run

    return [
        (lambda: dt.lstsq(At, bt, mesh=cols, block_size=8, refine=1),
         "incompatible devices"),
        (lambda: dt.lstsq(At, bt, mesh=cols, block_size=8, comms="bf16"),
         "incompatible devices"),
        (lambda: dt.qr(At, mesh=cols, block_size=8,
                       policy="balanced").solve(bt),
         "incompatible devices"),
        (lambda: dt.guarded_lstsq(At, bt, mesh=cols, block_size=8,
                                  guards="full"),
         "TracerArrayConversionError"),
        (lambda: dt.guarded_qr(At, mesh=cols, block_size=8, guards="full"),
         "ConcretizationTypeError"),
        (armed(lambda: dt.qr(At, mesh=cols, block_size=8)),
         "ConcretizationTypeError"),
        (armed(lambda: dt.lstsq(At, bt, mesh=cols, block_size=8)),
         "ConcretizationTypeError"),
        (armed(lambda: dt.lstsq(At, bt, mesh=rows, engine="tsqr")),
         "ConcretizationTypeError")]


def test_mesh_engines_refuse_a_matrix_that_requires_grad():
    """The mesh routes where the JAX package's jax.grad fails refuse before
    any collective, cite ROADMAP item 29 and quote JAX's error: the column
    mesh with refine (a compressed comms= forces its floor of CSNE
    sweeps), guards="full" and the armed armor seam. With grad off they
    run; the other mesh routes differentiate, the guarded ones with the
    other modes too (here on one rank, against the single-device gradient
    to 1e-9)."""
    from dhqr_tpu_torch.analysis.jaxpr_pass import solo_meshes

    A, b = random_problem(48, 16, np.float64, seed=58)
    At = torch.tensor(A, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    w = torch.from_numpy(_weights((16,), np.float64, seed=59))

    def grads(fn):
        At.grad = bt.grad = None
        torch.sum(fn() * w).backward()
        return At.grad.numpy().copy(), bt.grad.numpy().copy()

    ref = grads(lambda: dt.lstsq_diff(At, bt, 8, device="cpu"))
    with solo_meshes(torch.device("cpu")) as (meshes, _):
        cols, rows = meshes["cols"], meshes["rows"]
        for call, jax_error in _mesh_refusals(cols, rows, At, bt):
            with pytest.raises(dt.NotPortedError, match="item 29") as err:
                call()
            assert jax_error in str(err.value) and err.value.reason
        for fn in (lambda: dt.lstsq(At, bt, mesh=cols, block_size=8),
                   lambda: dt.lstsq(At, bt, mesh=cols, blocked=False),
                   lambda: dt.lstsq(At, bt, mesh=rows, engine="tsqr"),
                   lambda: dt.lstsq(At, bt, mesh=rows, engine="cholqr2"),
                   lambda: dt.qr(At, mesh=cols, block_size=8).solve(bt),
                   lambda: dt.guarded_lstsq(At, bt, mesh=cols, block_size=8,
                                            guards="fallback").x,
                   lambda: dt.guarded_qr(At, mesh=cols, block_size=8,
                                         guards="screen")
                   .factorization.solve(bt)):
            for got, want in zip(grads(fn), ref):
                assert _rel(got, want) <= 1e-9
        with torch.no_grad():
            x = dt.lstsq(At, bt, mesh=cols, block_size=8, refine=1)
    assert _rel(x.numpy(), dt.lstsq(A, b, block_size=8, device="cpu")) <= 1e-9


_JAX_MESH_FAILURES = {  # the JAX package's route and the error it raises
    "refine": (lambda A, b, mesh: dhqr_tpu.lstsq(
        A, b, mesh=mesh, block_size=8, refine=1), "incompatible devices"),
    "bf16": (lambda A, b, mesh: dhqr_tpu.lstsq(
        A, b, mesh=mesh, block_size=8, comms="bf16"),
        "incompatible devices"),
    "guards_full": (lambda A, b, mesh: dhqr_tpu.guarded_lstsq(
        A, b, mesh=mesh, block_size=8, guards="full").x,
        "TracerArrayConversion"),
    "armed": (lambda A, b, mesh: _jax_armed(
        lambda: dhqr_tpu.lstsq(A, b, mesh=mesh, block_size=8)),
        "Abstract tracer value"),
}


def _jax_armed(call):
    from dhqr_tpu import armor as jarmor

    with jarmor.armored():
        return call()


@pytest.mark.parametrize("name", sorted(_JAX_MESH_FAILURES))
def test_jax_grad_fails_where_the_mesh_refuses(name):
    """The refusals above are by design: the JAX package's jax.grad fails
    on the same calls, on the conftest's CPU mesh."""
    from dhqr_tpu.parallel import column_mesh

    A, b = random_problem(64, 32, np.float64, seed=58)
    b = jnp.asarray(b)
    fn, error = _JAX_MESH_FAILURES[name]
    with pytest.raises(Exception, match=error):
        jax.grad(lambda A: jnp.sum(fn(A, b, column_mesh(2)) ** 2))(
            jnp.asarray(A))


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
    port = _FACTORING_CALLS[name][0]
    assert _rel(grad_b(lambda A, b: port(A, b)[0]), ref) <= 1e-12
