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


@pytest.mark.parametrize("piece", [None, 64])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("shape", [(33, 7), (160, 32), (1000, 16)])
def test_plain_kernel_matches_pallas_interpret(shape, dtype, piece,
                                               monkeypatch):
    """``piece``: the plain versions work a row in pieces of that many
    elements (as they do a row of more than ``PLAIN_CHUNK`` on the card),
    which changes no element's arithmetic."""
    if piece:
        monkeypatch.setattr(hp, "PLAIN_CHUNK", piece)
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
        hp.panel_qr_kernel(torch.zeros((32, 8), dtype=torch.complex128))
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
    assert hp.panel_kernel_supported(4400, 128, torch.float64)
    assert not hp.panel_kernel_supported(8192, 128, torch.complex128)
    assert not hp.panel_kernel_supported(8192, 256, torch.float32)
    assert not hp.panel_kernel_supported(64, 128, torch.float32)
    assert hp.panel_kernel_supported(2**25, 128, torch.float32)  # 2^32 elems
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
                   "memory_order_acquire", "__ldcg", "register variant",
                   "fits_registers", "kRegisters"):
        assert needle in src
    assert "compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert set(hp.KERNELS.values()) == set(hp.LAUNCHES)


# -- the in-place entry: the blocked engine's leaf, in place in H ------------

def _in_place_case(rows, cols, off, dtype, seed, strides=None):
    """A view (rows, cols) of a larger matrix H, at row 7 and column 16,
    with its alpha a view of a longer vector, and copies of both."""
    H = torch.from_numpy(_panel(rows + 7, cols + 40, dtype, seed))
    if strides == "columns":  # a column-major H: column stride != 1
        H = H.T.contiguous().T
    alpha = torch.full((cols + 40,), 7.0, dtype=H.dtype)
    return H, alpha, H[7:, 16:16 + cols], alpha[16:16 + cols]


@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
@pytest.mark.parametrize("rows,cols,off", [(300, 32, 0), (300, 32, 5),
                                           (300, 128, 96), (129, 128, 1)])
def test_in_place_entry_is_the_wrapper_in_place(rows, cols, off, dtype):
    """On a view of H whose rows are contiguous, the in-place entry writes
    the wrapper's factors (rows ``off:``) and alpha where they lie, bit for
    bit; every other entry of H (rows above the offset, columns outside
    the view) and of the alpha vector stays bit for bit."""
    H, alpha, view, a_view = _in_place_case(rows, cols, off, dtype, seed=31)
    H0, alpha0 = H.clone(), alpha.clone()
    pf, a = hp._panel_qr_kernel(view, off)
    assert torch.equal(H, H0)  # the wrapper leaves its input alone
    assert hp._panel_qr_kernel_in_place(view, off, a_view) == "in_place"
    assert torch.equal(view[off:], pf[off:]) and torch.equal(a_view, a)
    outside = torch.ones(H.shape, dtype=torch.bool)
    outside[7 + off:, 16:16 + cols] = False
    assert torch.equal(H[outside], H0[outside])
    kept = torch.ones(alpha.shape, dtype=torch.bool)
    kept[16:16 + cols] = False
    assert torch.equal(alpha[kept], alpha0[kept])


def test_layout_rule_is_the_variant_and_the_strides():
    """In place where the slices stay on chip and the rows are contiguous;
    a streamed slice, or a panel whose column stride is not 1, takes the
    wrapper's transposed copy."""
    assert hp.LAYOUTS == ("in_place", "transposed")
    for variant in ("registers", "shared"):
        assert hp.kernel_layout(variant, (512, 1)) == "in_place"
        assert hp.kernel_layout(variant, (1, 4096)) == "transposed"
        assert hp.kernel_layout(variant, (1024, 2)) == "transposed"
    for strides in ((512, 1), (1, 4096)):
        assert hp.kernel_layout("streamed", strides) == "transposed"


@pytest.mark.parametrize("rows,cols,off,strides", [
    (2**19, 16, 3, None),          # streamed on the H100 (524288 x 16)
    (300, 32, 5, "columns"),       # a column-major H
])
def test_in_place_entry_takes_the_transposed_copy(rows, cols, off, strides,
                                                  monkeypatch):
    """A streamed plan, or a view whose column stride is not 1, goes
    through the wrapper's transposed copy (one wrapper call), whose rows
    ``off:`` and alpha are written back: the same bits as the wrapper, and
    rows above the offset kept."""
    H, alpha, view, a_view = _in_place_case(rows, cols, off, np.float32,
                                            seed=32, strides=strides)
    assert hp._plan(rows, cols, off, torch.float32, "cpu")[2] == (
        "streamed" if strides is None else "registers")
    H0 = H.clone()
    pf, a = hp._panel_qr_kernel(view, off)
    calls = []
    real = hp._panel_qr_kernel

    def spy(panel, offset, sms=None):
        calls.append(tuple(panel.shape))
        return real(panel, offset, sms)

    monkeypatch.setattr(hp, "_panel_qr_kernel", spy)
    assert hp._panel_qr_kernel_in_place(view, off, a_view) == "transposed"
    assert calls == [(rows, cols)]
    assert torch.equal(view[off:], pf[off:]) and torch.equal(a_view, a)
    assert torch.equal(view[:off], H0[7:7 + off, 16:16 + cols])


def test_in_place_entry_refuses_what_the_wrapper_refuses():
    alpha = torch.zeros(8)
    with pytest.raises(ValueError):
        hp._panel_qr_kernel_in_place(torch.zeros((40, 8)), 33, alpha)
    with pytest.raises(ValueError):
        hp._panel_qr_kernel_in_place(torch.zeros((64, 8), device="meta"), 0,
                                     alpha)
    with pytest.raises(NotImplementedError, match="raw pointer"):
        hp._panel_qr_kernel_in_place(
            torch.zeros((64, 8), requires_grad=True), 0, alpha)
