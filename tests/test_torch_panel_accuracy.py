"""PyTorch port: the factor quality of the CUDA kernel's schedule (the
ROADMAP Queue C item 1 question), on the CPU.

At 1100 x 1000 float32 (``random_problem``, seed 3), packed factors are
evaluated in float64 with the same code: the blocked engine with
``hopper_panel._panel_qr_grid_leaf`` as its kernel leaf (the CUDA kernel's
row slices, merges and one-round identity in eager PyTorch), the same
engine on the plain panel loop, and the JAX package's unblocked
``householder_qr``. The grid model's backward error ``||A - QR|| / ||A||``
and orthogonality ``||I - Q^T Q||_F`` stay within 1.5x of the plain
loop's (both ways), and its orthogonality within 1.5x of
``householder_qr``'s. The backward error is not held to the unblocked
reference: on the CPU it is set by the BLAS's float32 accumulation in the
blocked engine's trailing GEMMs, not by the panel's schedule (here 6.4e-7
for the port's blocked plain loop, 3.9e-7 for the same with those GEMMs in
float64, 4.3e-7 for the JAX package's blocked engine and 3.1e-7 for its
unblocked one), so a bar against the unblocked engine would measure the
BLAS.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.ops import householder as jhh  # noqa: E402
from dhqr_tpu.utils.testing import random_problem  # noqa: E402
from dhqr_tpu_torch.ops import blocked as tbl  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402
from dhqr_tpu_torch.ops import solve as tsv  # noqa: E402

M, N, NB = 1100, 1000, 128
BAR = 1.5


def _quality(H, alpha, A):
    """(backward error, orthogonality) of packed (H, alpha), in float64."""
    H = torch.as_tensor(np.array(H))
    alpha = torch.as_tensor(np.array(alpha))
    eye = torch.eye(M, N, dtype=torch.float64)
    Q = tbl._apply_q_impl(H.double(), eye, NB)
    R = tsv.r_matrix(H, alpha).double()
    A64 = torch.from_numpy(A).double()
    backward = torch.linalg.matrix_norm(A64 - Q @ R) \
        / torch.linalg.matrix_norm(A64)
    return float(backward), float(torch.linalg.matrix_norm(eye[:N] - Q.T @ Q))


@pytest.fixture(scope="module")
def qualities():
    A, _ = random_problem(M, N, np.float32, seed=3)
    At = torch.from_numpy(A)
    grid = tbl._blocked_qr_impl(At.clone(), NB, kernel=True,
                                leaf=hp._panel_qr_grid_leaf)
    loop = tbl._blocked_qr_impl(At.clone(), NB, kernel=False)
    ref = jhh.householder_qr(jnp.asarray(A))
    return {"grid_model": _quality(*grid, A), "plain_loop": _quality(*loop, A),
            "jax_householder_qr": _quality(*ref, A)}


@pytest.mark.parametrize("other,measure", [
    ("plain_loop", 0), ("plain_loop", 1), ("jax_householder_qr", 1)],
    ids=["plain_loop-backward", "plain_loop-orthogonality",
         "jax_householder_qr-orthogonality"])
def test_grid_model_factor_quality(qualities, other, measure):
    got, want = qualities["grid_model"][measure], qualities[other][measure]
    assert np.isfinite(got) and got <= BAR * want, (qualities, other)
    if other == "plain_loop":  # the same engine: neither is far better
        assert want <= BAR * got, (qualities, other)


def test_grid_leaf_follows_the_kernel_plan():
    """The leaf cuts each panel into the CTAs the kernel would launch for
    it (the H100 plan on the CPU), so it runs the kernel's own grid."""
    calls = []

    def spy(panel, offset, sms=None):
        calls.append((panel.shape[0] - offset, panel.shape[1]))
        return hp._panel_qr_grid_leaf(panel, offset, sms)

    A, _ = random_problem(300, 256, np.float32, seed=4)
    H, alpha = tbl._blocked_qr_impl(torch.from_numpy(A), 128, kernel=True,
                                    leaf=spy)
    plan = tbl.panel_plan(300, 256, 128, True, torch.float32)
    assert calls == [(300 - k, w) for k, w, _ in plan]
    H2, alpha2 = tbl._blocked_qr_impl(torch.from_numpy(A), 128, kernel=True)
    np.testing.assert_allclose(H.numpy(), H2.numpy(), atol=2e-5, rtol=2e-5)
