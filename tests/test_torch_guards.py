"""PyTorch port: the rules the port keeps — it imports neither JAX nor the
JAX package, it runs on the card unless told otherwise, it never falls
back, and its main path calls no library factorization."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dhqr_tpu_torch as dt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dhqr_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_importing_the_port_loads_no_jax():
    """Importing the port loads no JAX module and builds or loads no kernel
    library."""
    code = ("import sys, dhqr_tpu_torch, dhqr_tpu_torch.interop; "
            "from dhqr_tpu_torch.ops import _build; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'dhqr_tpu' or "
            "m.startswith('dhqr_tpu.')] + list(_build._LIBS); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_sources_import_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "dhqr_tpu"), (path, mod)


def test_main_path_calls_no_library_factorization():
    """No torch.geqrf / torch.linalg.qr / torch.linalg.lstsq /
    torch.compile in the package (chip_smoke.py times some of them as
    yardsticks; the package never calls them)."""
    banned = {"geqrf", "qr", "lstsq", "compile", "householder_product",
              "orgqr", "ormqr"}
    for path in _port_sources():
        if path.endswith("chip_smoke.py"):
            continue
        for node in ast.walk(ast.parse(open(path, encoding="utf-8").read())):
            if isinstance(node, ast.Attribute) and node.attr in banned:
                base = ast.unparse(node.value)
                assert not base.startswith("torch"), (path, ast.unparse(node))


def test_no_cuda_means_asking_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = np.random.default_rng(0).random((20, 10)).astype(np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dt.qr(A)
    with pytest.raises(RuntimeError):
        dt.lstsq(A, A[:, 0])
    with pytest.raises(RuntimeError):
        dt.householder_qr(A, device="cuda")
    assert dt.qr(A, device="cpu").H.device.type == "cpu"


def test_tf32_is_refused(monkeypatch):
    monkeypatch.setattr(torch, "get_float32_matmul_precision", lambda: "high")
    A = np.eye(8, dtype=np.float32)
    with pytest.raises(RuntimeError, match="FP32"):
        dt.qr(A, device="cpu")


def test_facade_exports():
    import dhqr_tpu

    for name in dt.__all__:
        assert hasattr(dt, name), name
    wanted = {"qr", "lstsq", "solve", "QRFactorization", "householder_qr",
              "blocked_householder_qr", "apply_qt", "apply_q",
              "back_substitute", "solve_least_squares", "alphafactor",
              "DHQRConfig", "__version__"}
    assert wanted <= set(dt.__all__)
    assert (wanted - {"DHQRConfig"}) <= set(dhqr_tpu.__all__) | {"__version__"}

