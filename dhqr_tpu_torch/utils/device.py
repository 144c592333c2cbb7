"""The port's device rule.

Public entry points take numpy arrays or tensors plus ``device=None``.
``None`` means ``"cuda"``: inputs are moved to the card. Without CUDA the
caller must ask for the CPU (``device="cpu"``) — the port never carries on
quietly on the CPU when the card was meant.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` if CUDA is asked for
    (explicitly or by default) and this process has none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dhqr_tpu_torch runs on the CUDA card by default and "
            "torch.cuda.is_available() is False here: pass device='cpu' to "
            "run the port's plain PyTorch path on the CPU")
    return dev


def dtype_name(dtype) -> str:
    """The canonical numpy name (``"float32"``) of a numpy, torch or string
    dtype: the spelling of the serve cache key's and the plan key's dtype
    field in both packages."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` (numpy array or tensor) as a tensor on the resolved device.

    A tensor already on that device with that dtype is returned as is (no
    copy), which is what lets ``donate=True`` factor in the caller's storage.
    """
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(device=dev, dtype=dtype)


def check_fp32_matmul(device: torch.device) -> None:
    """precision="highest" means full FP32 matmuls. The port never flips
    PyTorch's process-wide TF32 switches; it refuses to run under them."""
    tf32 = (torch.get_float32_matmul_precision() != "highest"
            or (device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32))
    if tf32:
        raise RuntimeError(
            "precision='highest' needs full FP32 matmuls, but this process "
            "allows TF32/bf16 float32 matmuls (torch.backends.cuda.matmul."
            "allow_tf32 / torch.set_float32_matmul_precision): restore the "
            "PyTorch defaults")
