"""Graft entry points of the port — the twin of the root
``__graft_entry__.py``: a one-call forward step and the multi-rank dry run.

``entry()`` returns the flagship step (blocked compact-WY QR + least-squares
solve at block size 32) with a small example problem on the device.

``dryrun_multichip(n)`` runs ``python -m dhqr_tpu_torch._dryrun n`` in a
child process (every distributed path of the port on n ranks, then the
single-process tiers) and raises with the child's output if it fails: the
reference's local fake-cluster proof (reference test/runtests.jl:9,71-82,
``addprocs(np)``). The child needs no environment of its own: the port
picks its device per call.
"""

from __future__ import annotations

import os
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device=None):
    """``(fn, (A, b))``: ``fn(A, b)`` is the blocked QR of a copy of A at
    block size 32 with its panels on the kernel that ``use_pallas="auto"``
    resolves to on A's device (the Hopper panel kernel for float32 on the
    card, the plain panel loop on the CPU), Q^H b and back-substitution;
    ``(A, b)`` is a 256 x 128 float32 problem made from a numpy seed on
    ``device`` (None: the card)."""
    import numpy as np

    from dhqr_tpu_torch.ops.blocked import (
        _apply_qt_impl,
        _blocked_qr_impl,
        _resolve_kernel,
    )
    from dhqr_tpu_torch.ops.solve import back_substitute
    from dhqr_tpu_torch.utils.device import as_tensor

    block_size = 32

    def lstsq_step(A, b):
        kernel = _resolve_kernel("auto", A.shape[0], A.dtype, A.device)
        H, alpha = _blocked_qr_impl(A.clone(), block_size, kernel)
        c = _apply_qt_impl(H, b, block_size)
        return back_substitute(H, alpha, c, device=A.device)

    rng = np.random.default_rng(0)
    A = as_tensor(rng.random((256, 128), dtype=np.float32), device)
    b = as_tensor(rng.random(256, dtype=np.float32), A.device)
    return lstsq_step, (A, b)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run the dry run on ``n_devices`` ranks in a child process
    (``device="cpu"``: gloo ranks on the CPU; None: the card) with a time
    limit of ``DHQR_DRYRUN_TIMEOUT`` seconds (default 540). Writes the
    child's output; raises ``RuntimeError`` with its output and the tail
    of its errors if it fails."""
    timeout = int(os.environ.get("DHQR_DRYRUN_TIMEOUT", "540"))
    cmd = [sys.executable, "-m", "dhqr_tpu_torch._dryrun", str(n_devices)]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.run(cmd, cwd=_REPO, capture_output=True, text=True,
                          timeout=timeout)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) failed (rc={proc.returncode})\n"
            f"--- stdout ---\n{proc.stdout}\n--- stderr ---\n"
            f"{proc.stderr[-4000:]}")
