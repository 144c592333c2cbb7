"""The card's published peaks — the part of ``dhqr_tpu/utils/platform.py``
that the port's pulse profiler reads (``device_peak_tflops``,
``device_hbm_gbps``, ``device_ici_gbps``, ``device_dcn_gbps``).

The table is keyed by ``torch.cuda.get_device_name()``. Its one row is
the NVIDIA H100 SXM5 80GB, figures from NVIDIA's H100 Tensor Core GPU
datasheet (SXM column, dense rates): 989 TFLOP/s in bf16 tensor cores,
3.35 TB/s of HBM3, 900 GB/s of NVLink per card. The datasheet gives no
network figure for a host, so the cross-host row is None, with the
reason; a rate taken on or for a TPU never appears here. A card or host
not in the table (the CPU included) has no row: a made-up figure would
turn every DHQR306 verdict into fiction.
"""

from __future__ import annotations

#: name -> figures; None where the datasheet gives none (the reason
#: stands beside it).
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "peak_tflops": 989.0,   # bf16 dense, tensor cores (datasheet, SXM)
        "hbm_gbps": 3350.0,     # HBM3, 3.35 TB/s (datasheet, SXM)
        "ici_gbps": 900.0,      # NVLink 4, 900 GB/s per card (datasheet)
        "dcn_gbps": None,
        "dcn_reason": ("the H100 datasheet gives no network bandwidth: it "
                       "depends on the host's network cards"),
    },
}


def _row(device_kind: str):
    return _DEVICE_PEAKS.get(str(device_kind))


def device_peak_tflops(device_kind: str, dtype: str = "float32"):
    """The card's dense bf16 tensor-core peak in TFLOP/s (the one basis,
    whatever ``dtype`` names, as in the JAX package), or None."""
    del dtype  # one published basis per card
    entry = _row(device_kind)
    return entry["peak_tflops"] if entry else None


def device_hbm_gbps(device_kind: str):
    """The card's HBM bandwidth in GB/s, or None when unknown."""
    entry = _row(device_kind)
    return entry["hbm_gbps"] if entry else None


def device_ici_gbps(device_kind: str):
    """The card's bandwidth to the other cards of its host (NVLink) in
    GB/s, or None when unknown (the CPU and every card not in the
    table)."""
    entry = _row(device_kind)
    return entry.get("ici_gbps") if entry else None


def device_dcn_gbps(device_kind: str):
    """The host's network bandwidth in GB/s between hosts, or None: the
    H100 row has none (``_DEVICE_PEAKS``'s ``dcn_reason``), so a two-tier
    DHQR306 bound skips with that reason instead of guessing."""
    entry = _row(device_kind)
    return entry.get("dcn_gbps") if entry else None
