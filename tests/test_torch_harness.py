"""PyTorch port: the runtests.jl harness CLI (``dhqr_tpu_torch.harness``),
the twin of ``tests/test_harness.py``, on the CPU (``--device cpu``).

The sweep's rows are held to the reference's 8x LAPACK criterion, which
the harness itself applies; a row's x is held to ``dhqr_tpu.lstsq`` on the
same numpy problem at 1e-10 relative (float64); the multi-rank cases run
two gloo ranks on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dhqr_tpu  # noqa: E402
from dhqr_tpu.utils.testing import random_problem as jax_problem  # noqa: E402

from dhqr_tpu_torch import harness  # noqa: E402
from dhqr_tpu_torch.utils.config import DHQRConfig  # noqa: E402
from dhqr_tpu_torch.utils.testing import random_problem  # noqa: E402

REPO_ROOT = str(Path(__file__).resolve().parent.parent)


def _run(capsys, *argv):
    rc = harness.main([*argv, "--device", "cpu"])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_harness_cli_runs_and_passes(tmp_path):
    """The CLI itself, two gloo ranks spawned from ``python -m``."""
    proc = subprocess.run(
        [sys.executable, "-m", "dhqr_tpu_torch.harness", "2",
         "--sizes", "44x40", "--dtypes", "float64", "--bench",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin",
             "PYTHONPATH": REPO_ROOT, "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "backend: gloo, ranks per card: 1" in proc.stdout
    assert "ok  44x40" in proc.stdout
    assert "slowdown vs LAPACK" in proc.stdout


def test_harness_env_layout_with_row_engine_warns_not_aborts(capsys,
                                                             monkeypatch):
    """An ambient DHQR_LAYOUT=cyclic (read by the port's from_env since
    this slice) must not abort a tsqr run: it warns and falls back to
    'block'; an explicit --layout conflict still hard-fails."""
    monkeypatch.setenv("DHQR_LAYOUT", "cyclic")
    rc, out, err = _run(capsys, "1", "--sizes", "24x20", "--dtypes",
                        "float64", "--engine", "tsqr")
    assert rc == 0, out + err
    assert "ok  24x20" in out
    assert "DHQR_LAYOUT=cyclic ignored" in err

    monkeypatch.delenv("DHQR_LAYOUT")
    with pytest.raises(SystemExit) as exc:
        _run(capsys, "1", "--sizes", "24x20", "--dtypes", "float64",
             "--engine", "tsqr", "--layout", "cyclic")
    assert exc.value.code != 0
    assert "householder engines only" in capsys.readouterr().err


def test_harness_agg_panels_on_mesh(capsys):
    """--agg-panels with two ranks runs the sharded aggregated engine; the
    row engines still refuse it."""
    rc, out, err = _run(capsys, "2", "--sizes", "44x40", "--dtypes",
                        "float64", "--agg-panels", "2")
    assert rc == 0, out + err
    assert "ok  44x40" in out

    with pytest.raises(SystemExit) as exc:
        _run(capsys, "1", "--sizes", "24x20", "--dtypes", "float64",
             "--engine", "cholqr2", "--agg-panels", "2")
    assert exc.value.code != 0
    assert "blocked householder engines only" in capsys.readouterr().err


def test_harness_without_cuda_exits_with_the_device_rule(capsys,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["1", "--sizes", "24x20", "--dtypes", "float64"])
    assert rc != 0
    assert "device='cpu'" in capsys.readouterr().err


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_sweep_row_matches_the_reference_lstsq(dtype):
    """The x of a 110x100 sweep row against ``dhqr_tpu.lstsq`` on the
    same problem; the harness's problem is the JAX harness's bit for
    bit."""
    A, b = random_problem(110, 100, np.dtype(dtype), seed=0)
    Aj, bj = jax_problem(110, 100, np.dtype(dtype), seed=0)
    assert A.tobytes() == Aj.tobytes() and b.tobytes() == bj.tobytes()
    [row] = harness._sweep([(dtype, 110, 100, False, None)], DHQRConfig(),
                           False, None, "cpu")
    x_ref = np.asarray(dhqr_tpu.lstsq(jnp.asarray(Aj), jnp.asarray(bj)))
    assert np.linalg.norm(row["x"] - x_ref) <= 1e-10 * np.linalg.norm(x_ref)


def test_sweep_profile_dir_writes_a_trace(tmp_path, capsys):
    rc, out, _ = _run(capsys, "1", "--sizes", "24x20", "--dtypes", "float32",
                      "--profile-dir", str(tmp_path))
    assert rc == 0 and "profiler trace written" in out
    assert len(list(tmp_path.glob("dhqr_trace_*.json"))) == 1
