"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``dhqr_tpu_torch/csrc/<name>.cu`` holds extern-"C" launchers that take
raw device pointers and the stream and return ``cudaGetLastError()``. It
is compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``build/<name>-<hash>.so`` at the repo root (the hash covers the
source and the flags, so an edited source is never served a stale
library), with nvcc's output (the ``-Xptxas -v`` register and shared-memory
report) beside it as ``.log``. All sources build in parallel, one nvcc
each. A failed build raises with nvcc's stderr. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: "dict[str, ctypes.CDLL]" = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's Hopper kernels are built from source at first use")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> "dict[str, Path]":
    """Compile every ``csrc/*.cu`` whose library is missing, all at once.

    Returns ``{name: path to the .so}``.
    """
    sources = sorted(CSRC_DIR.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = targets[src.stem]
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} (exit "
                            f"{proc.returncode}):\n{stderr}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return targets


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            _LIBS[name] = ctypes.CDLL(str(paths[name]))
        return _LIBS[name]


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` (empty if it was not built in
    this checkout)."""
    log = _target(CSRC_DIR / f"{name}.cu").with_suffix(".log")
    return log.read_text() if log.exists() else ""
