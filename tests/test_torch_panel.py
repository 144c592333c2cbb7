"""PyTorch port: the Hopper panel kernels' plain versions against the JAX
package's Pallas panel kernels run in interpret mode (as
tests/test_pallas_panel.py runs them on the CPU).

On a CPU tensor the kernel wrapper takes the plain version, which follows
the TPU kernel's algorithm step by step (compensated norm included), so
the tolerances are the JAX kernel tests' own: 2e-5 float32, 5e-5
complex64. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dhqr_tpu.ops import pallas_panel as jpp  # noqa: E402
from dhqr_tpu_torch.ops import hopper_panel as hp  # noqa: E402

TOL = {np.float32: 2e-5, np.complex64: 5e-5}


def _panel(m, nb, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, nb))
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal((m, nb))
    return x.astype(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.resolve_conj().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("shape", [(33, 7), (160, 32)])
def test_plain_kernel_matches_pallas_interpret(shape, dtype):
    P = _panel(*shape, dtype, seed=7)
    before = dict(hp.LAUNCHES)
    pf, alpha = hp.panel_qr_kernel(torch.from_numpy(P))
    pf0, alpha0 = jpp.panel_qr_pallas(jnp.asarray(P), interpret=True)
    _close(pf, pf0, TOL[dtype])
    _close(alpha, alpha0, TOL[dtype])
    assert hp.LAUNCHES == before  # a CPU tensor launches nothing


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_offset3_matches_pallas_interpret(dtype):
    P = _panel(96, 16, dtype, seed=13)
    pf, alpha = hp._panel_qr_kernel(torch.from_numpy(P), 3)
    pf0, alpha0 = jpp._panel_qr_pallas_impl(jnp.asarray(P), 3, interpret=True)
    _close(pf, pf0, TOL[dtype])
    _close(alpha, alpha0, TOL[dtype])
    assert np.array_equal(pf.numpy()[:3], P[:3])  # rows above kept


@pytest.mark.parametrize("m", [4096, 3967, 767])
def test_compensated_sumsq_12_decades(m):
    """|alpha_0| within 5e-7 of the f64 column norm on a 12-decade column
    (tests/test_pallas_panel.py:250-261); odd heights exercise the
    pad-to-pow2 halving tree."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((m, 8)) *
         np.logspace(-6, 6, m)[:, None]).astype(np.float32)
    _, alpha = hp.panel_qr_kernel(torch.from_numpy(x))
    s64 = np.linalg.norm(x[:, 0].astype(np.float64))
    assert abs(abs(float(alpha[0])) - s64) / s64 < 5e-7


@pytest.mark.parametrize("m", [100, 255, 256, 1000, 4097])
def test_sumsq_compensated_matches_pallas_helper(m):
    """The plain helper and the Pallas kernel's helper: same split, same
    pad, same halving tree; only the last 128-lane sum's order differs."""
    rng = np.random.default_rng(m)
    x = (rng.standard_normal(m) * np.logspace(-4, 4, m)).astype(np.float32)
    got = float(hp._sumsq_compensated(torch.from_numpy(x)))
    want = float(jpp._sumsq_compensated(jnp.asarray(x)[None, :]))
    s64 = float(np.sum(x.astype(np.float64) ** 2))
    assert abs(got - want) / s64 < 5e-7
    assert abs(got - s64) / s64 < 5e-7


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        hp.panel_qr_kernel(torch.zeros((16, 32)))  # m < nb
    with pytest.raises(ValueError):
        hp.panel_qr_kernel(torch.zeros((32, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        hp._panel_qr_kernel(torch.zeros((300, 129)), 0)  # wider than a launch
    with pytest.raises(ValueError):
        hp._panel_qr_kernel(torch.zeros((40, 8)), 33)  # offset past the rows


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Routing is by the tensor's device: only a CPU tensor runs the plain
    version; any other device launches a kernel or raises."""
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        hp._panel_qr_kernel(torch.zeros((64, 8), device="meta"), 0)


def test_supported_predicate():
    """Type, width and height; a panel whose slices do not fit shared
    memory is still taken, streamed (H100 values on the CPU)."""
    assert hp.panel_kernel_supported(16384, 128, torch.float32)
    assert hp.panel_kernel_supported(8192, 128, torch.complex64)
    assert not hp.panel_kernel_supported(8192, 128, torch.float64)
    assert not hp.panel_kernel_supported(8192, 128, torch.complex128)
    assert not hp.panel_kernel_supported(8192, 256, torch.float32)
    assert not hp.panel_kernel_supported(64, 128, torch.float32)
    assert not hp.panel_kernel_supported(2**25, 128, torch.float32)
    assert hp.panel_kernel_supported(65536, 128, torch.float32)
    assert not hp.kernel_resident(65536, 128, torch.float32)
    assert hp.kernel_resident(65536, 64, torch.float32)
    assert not hp.kernel_resident(16384, 128, torch.float32, sms=16)


def test_wrapper_leaves_its_input_alone():
    P = torch.from_numpy(_panel(64, 16, np.float32, seed=2))
    before = P.clone()
    hp._panel_qr_kernel(P, 0)
    assert torch.equal(P, before)


def test_kernel_source_carries_its_note():
    """The CUDA source names the TPU kernels it replaces, its bound and its
    launchers (built by nvcc on the card, never here)."""
    from dhqr_tpu_torch.ops import _build

    src = (_build.CSRC_DIR / "panel_qr.cu").read_text()
    for needle in ("_panel_kernel ", "_panel_kernel_c64", "3.35 TB/s",
                   "dhqr_panel_qr_f32", "dhqr_panel_qr_c64",
                   "cudaGetLastError", "fmaf(x, x, -p)",
                   "cudaLaunchCooperativeKernel",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize",
                   "memory_order_acquire", "__ldcg"):
        assert needle in src
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert set(hp.KERNELS.values()) == set(hp.LAUNCHES)
