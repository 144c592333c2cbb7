"""PyTorch port: the lookahead and aggregated schedules against the JAX
package's, on the CPU.

``lookahead=True`` and ``agg_panels=k`` are held to the JAX engine's own
schedules where it runs them (``_scan_panels_lookahead`` and
``_scan_panels_grouped`` on its scanned path, n / nb > MAX_UNROLLED_PANELS:
576 x 576 at nb = 64 for real dtypes, 640 x 320 at nb = 32 for complex64,
a tall shape where the complex factors are well determined), and to the
JAX default at the unrolled sizes where the JAX engine ignores
``agg_panels``. The port runs each with the kernel's plain version
(``use_pallas="always"``) and with the plain panel loop ("never"); the JAX
side runs its XLA panel path. Tolerances, relative to the largest entry:
2e-5 for float32 / complex64 (GEMM and panel summation orders differ
over ten panels; measured 1e-6 to 1.2e-5) and 1e-12 for float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
import dhqr_tpu_torch as dt  # noqa: E402
from dhqr_tpu.ops import blocked as jbl  # noqa: E402
from dhqr_tpu.utils.testing import oracle_residual, random_problem  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tbl  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402
from dhqr_tpu_torch.utils.testing import normal_equations_residual  # noqa: E402

TOL = {np.float32: 2e-5, np.complex64: 2e-5, np.float64: 1e-12}
SCANNED = {np.float32: (576, 576, 64), np.float64: (576, 576, 64),
           np.complex64: (640, 320, 32)}
SCHEDULES = {"lookahead": {"lookahead": True}, "agg2": {"agg_panels": 2},
             "agg3": {"agg_panels": 3}}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _modes(dtype):
    return ["never"] if dtype == np.float64 else ["never", "always"]


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64],
                         ids=lambda d: np.dtype(d).name)
def test_schedule_matches_jax_scanned_path(dtype, sched):
    m, n, nb = SCANNED[dtype]
    assert n // nb > jbl.MAX_UNROLLED_PANELS
    kw = SCHEDULES[sched]
    A, _ = random_problem(m, n, dtype, seed=11)
    H0, alpha0 = dhqr_tpu.blocked_householder_qr(jnp.asarray(A), nb,
                                                 use_pallas="never", **kw)
    for mode in _modes(dtype):
        H, alpha = dt.blocked_householder_qr(A, nb, use_pallas=mode,
                                             device="cpu", **kw)
        assert _rel(H.numpy(), H0) <= TOL[dtype], (mode, _rel(H.numpy(), H0))
        assert _rel(alpha.numpy(), alpha0) <= TOL[dtype], mode


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedule_matches_jax_default_when_unrolled(sched):
    """220 x 200 at nb = 64 is 4 panels: the JAX engine runs its unrolled
    path (its own lookahead there; agg_panels ignored), the port its
    schedule."""
    A, _ = random_problem(220, 200, np.float32, seed=12)
    H0, alpha0 = dhqr_tpu.blocked_householder_qr(jnp.asarray(A), 64,
                                                 use_pallas="never")
    H, alpha = dt.blocked_householder_qr(A, 64, use_pallas="always",
                                         device="cpu", **SCHEDULES[sched])
    assert _rel(H.numpy(), H0) <= TOL[np.float32]
    assert _rel(alpha.numpy(), alpha0) <= TOL[np.float32]


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
def test_schedule_keeps_default_factors_to_roundoff(sched):
    """Every column receives the same transforms in the same order, so the
    port's schedules agree with its default to roundoff (float64)."""
    A, _ = random_problem(300, 260, np.float64, seed=13)
    H0, alpha0 = dt.blocked_householder_qr(A, 32, device="cpu")
    H, alpha = dt.blocked_householder_qr(A, 32, device="cpu",
                                         **SCHEDULES[sched])
    assert _rel(H.numpy(), H0.numpy()) <= 1e-13
    assert _rel(alpha.numpy(), alpha0.numpy()) <= 1e-13


@pytest.mark.parametrize("sched", sorted(SCHEDULES))
@pytest.mark.parametrize("dtype", [np.float32, np.complex64],
                         ids=lambda d: np.dtype(d).name)
def test_schedule_lstsq_meets_reference_criterion(dtype, sched):
    """``lstsq`` (through ``lstsq_diff``) in each schedule, the kernel's
    plain version on the panels: within 8x of LAPACK."""
    A, b = random_problem(300, 200, dtype, seed=14)
    x = dt.lstsq(A, b, block_size=32, use_pallas="always", device="cpu",
                 **SCHEDULES[sched])
    res = normal_equations_residual(A, x.numpy(), b)
    assert np.isfinite(res) and res <= 8.0 * oracle_residual(A, b)


def test_lookahead_lstsq_diff_gradient_matches_default():
    A, b = random_problem(120, 80, np.float64, seed=15)

    def grads(**kw):
        At = torch.from_numpy(A).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        x = dt.lstsq_diff(At, bt, 16, device="cpu", **kw)
        x.sum().backward()
        return x.detach().numpy(), At.grad.numpy(), bt.grad.numpy()

    want = grads()
    for kw in ({"lookahead": True}, {"agg_panels": 2}):
        for got, ref in zip(grads(**kw), want):
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_schedules_launch_the_kernel_per_plan():
    """Every panel of either schedule goes through the kernel's wrapper
    (its plain version on the CPU), as many times as the plan says; the
    lookahead side-stream panels carry the CTA cap."""
    calls = []
    real = hp._panel_qr_kernel

    def spy(panel, offset, sms=None):
        calls.append(sms)
        return real(panel, offset, sms)

    A = torch.from_numpy(random_problem(700, 320, np.float32, seed=16)[0])
    plan = tbl.panel_plan(700, 320, 64, True, torch.float32, "cpu",
                          hp.LOOKAHEAD_CTAS)
    want = sum(tbl.kernel_leaves(w, leaf) for _, w, leaf in plan)
    tbl._blocked_qr_impl(A.clone(), 64, kernel=True, lookahead=True,
                         leaf=spy)
    assert len(calls) == want
    assert calls == [None] + [hp.LOOKAHEAD_CTAS] * (want - 2) + [None]
    calls.clear()
    tbl._blocked_qr_impl(A.clone(), 64, kernel=True, agg_panels=2, leaf=spy)
    assert calls == [None] * want


def _message(fn):
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("kw", [
    {"agg_panels": 1}, {"agg_panels": 2, "lookahead": True},
    {"overlap_depth": 0}, {"overlap_depth": 2},
    {"overlap_depth": 2, "lookahead": True},
    {"overlap_depth": 2, "lookahead": True, "agg_panels": 2},
], ids=["agg1", "agg+lookahead", "depth0", "depth-no-lookahead",
        "depth-single-device", "depth+agg"])
@pytest.mark.parametrize("entry", ["qr", "lstsq"])
def test_sched_knob_messages_match_jax(entry, kw):
    A, b = random_problem(40, 20, np.float32, seed=17)
    jfn = getattr(dhqr_tpu, entry)
    tfn = getattr(dt, entry)
    args = (A,) if entry == "qr" else (A, b)
    want = _message(lambda: jfn(*(jnp.asarray(a) for a in args), **kw))
    got = _message(lambda: tfn(*args, device="cpu", **kw))
    assert got == want


@pytest.mark.parametrize("kw", [
    {"agg_panels": 1}, {"agg_panels": 2, "lookahead": True},
    {"overlap_depth": 1}], ids=["agg1", "agg+lookahead", "depth"])
def test_ops_level_messages_match_jax(kw):
    A, _ = random_problem(40, 20, np.float32, seed=18)
    want = _message(lambda: dhqr_tpu.blocked_householder_qr(jnp.asarray(A),
                                                            **kw))
    got = _message(lambda: dt.blocked_householder_qr(A, device="cpu", **kw))
    assert got == want
    if "overlap_depth" not in kw:  # lstsq_diff takes no overlap_depth
        assert _message(lambda: dt.lstsq_diff(A, A[:, 0], device="cpu",
                                              **kw)) == want


def test_schedule_knob_refusals():
    A, b = random_problem(40, 20, np.float32, seed=19)
    # mesh= takes the port's ColumnMesh; on a mesh, a pipeline deeper than
    # one panel raises NotPortedError (tests/test_torch_sharded_engines.py)
    with pytest.raises(TypeError, match="ColumnMesh"):
        dt.qr(A, device="cpu", lookahead=True, overlap_depth=2,
              mesh=object())
    for kw in ({"lookahead": True}, {"agg_panels": 2}):
        with pytest.raises(ValueError, match="blocked engines only"):
            dt.qr(A, device="cpu", blocked=False, **kw)
        with pytest.raises(ValueError, match="householder engines only"):
            dt.lstsq(A, b, device="cpu", engine="cholqr2", **kw)
        with pytest.raises(ValueError, match="m < n"):
            dt.lstsq(A.T, b[:20], device="cpu", **kw)
