"""The analytic network-cost model — port of ``dhqr_tpu/obs/netmodel.py``:
how long a collective of a family and payload should take on a known
interconnect, what bandwidth a measured collective achieved, and where a
dispatch sits on the comms-vs-compute roofline. It is the model behind
pulse's DHQR306 check (:mod:`dhqr_tpu_torch.obs.pulse`): a measured
collective time must be explainable by its volume over the interconnect
bandwidth, times a slack.

Algorithm factors follow the ring accounting of the JAX package, with its
volume convention (a collective's payload is its output on one rank): an
all-reduce of N bytes moves ``2 (P-1)/P N`` over the slowest link, an
all-gather of an N-byte gathered result ``(P-1)/P N``, a broadcast of N
bytes ``(P-1)/P N`` (the port's one-hot sums are broadcasts; a pipelined
ring broadcast moves each byte across each of the P-1 links once).

The event vocabulary is the port's: NCCL kernel names on the card
(``ncclDevKernel_AllReduce_Sum_f32_RING_LL``, ``..._Broadcast_...``,
``..._AllGather_...``) and the c10d operators on the host
(``c10d::allreduce_``, ``c10d::broadcast_``, ``c10d::allgather_``).

Standard library only.
"""

from __future__ import annotations

__all__ = [
    "ALGO_FACTORS",
    "FAMILY_TOKENS",
    "WIRE_ITEMSIZE",
    "classify_event",
    "collective_time_s",
    "comms_roofline",
    "effective_gbps",
    "explain_measured",
    "wire_bytes",
]

#: Wire bytes per f32 word under each comms mode (the precision module's
#: table, kept here so this module needs nothing else).
WIRE_ITEMSIZE = {None: None, "bf16": 2, "int8": 1,
                 "dcn:bf16": 2, "dcn:int8": 1}

#: Event-name tokens (matched on the lower-cased name with ``_`` and
#: ``-`` removed) -> collective family. ``reducescatter`` first: it holds
#: no other token, and nothing else holds it.
FAMILY_TOKENS = (
    ("reducescatter", "reduce_scatter"),
    ("allreduce", "psum"),
    ("allgather", "all_gather"),
    ("alltoall", "all_to_all"),
    ("sendrecv", "ppermute"),
    ("broadcast", "broadcast"),
)


def classify_event(name: str) -> "str | None":
    """Collective family of one profiler event (an NCCL kernel or a c10d
    operator), or None for any other event (``record_param_comms``, the
    profiler's annotation of a collective, names none)."""
    low = str(name).lower().replace("_", "").replace("-", "")
    for token, family in FAMILY_TOKENS:
        if token in low:
            return family
    return None


#: Per-family wire multipliers f(P): ``wire_bytes = f(P) * payload``. A
#: family not listed uses 1.0.
ALGO_FACTORS = {
    "psum": lambda P: 2.0 * (P - 1) / P,
    "all_gather": lambda P: (P - 1) / P,
    "reduce_scatter": lambda P: (P - 1) / P,
    "all_to_all": lambda P: (P - 1) / P,
    "ppermute": lambda P: 1.0,
    "pbroadcast": lambda P: (P - 1) / P,
    "broadcast": lambda P: (P - 1) / P,
}


def wire_bytes(family: str, payload_bytes: float, P: int) -> float:
    """Bytes a ``family`` collective of ``payload_bytes`` puts on the
    slowest link of a P-rank ring (0 at P <= 1: nothing leaves the
    card)."""
    if P <= 1:
        return 0.0
    factor = ALGO_FACTORS.get(family, lambda _p: 1.0)
    return factor(int(P)) * float(payload_bytes)


def collective_time_s(family: str, payload_bytes: float, P: int,
                      link_gbps: float) -> "float | None":
    """Lower-bound time of one collective on a ``link_gbps`` GB/s link
    (bandwidth only: latency is absorbed by the DHQR306 slack), or None
    without a known link speed."""
    if not link_gbps:
        return None
    return wire_bytes(family, payload_bytes, P) / (link_gbps * 1e9)


def effective_gbps(wire_bytes_moved: float,
                   seconds: float) -> "float | None":
    """Achieved wire bandwidth (GB/s), or None for a degenerate time."""
    if not seconds or seconds <= 0:
        return None
    return wire_bytes_moved / seconds / 1e9


def explain_measured(family: str, measured_s: float,
                     volume_bytes: float, P: int, link_gbps: float,
                     slack: float,
                     wire_format: "str | None" = None,
                     dcn_volume_bytes: float = 0.0,
                     dcn_gbps: "float | None" = None) -> dict:
    """The DHQR306 check of one family: is ``measured_s`` explainable by
    ``volume / bandwidth x slack``?

    ``volume_bytes`` is what the wire carried (compressed, under a
    compressed ``wire_format``: the census counts the wire's bytes), so
    the bound is the compressed wire's; the f32-equivalent volume is
    reported beside it. ``dcn_volume_bytes`` is the share that crossed
    between hosts, bounded by ``dcn_gbps``; with a share and no
    ``dcn_gbps`` the check skips with that reason. Returns ``{"status":
    "ok" | "fail" | "skip", "reason", "bound_s", "effective_gbps",
    "bandwidth_pct", ...}``: ``skip`` (with the reason) when no link speed
    is known or the volume is zero; faster than the bound is fine."""
    out: dict = {"family": family, "measured_s": round(measured_s, 6),
                 "volume_bytes": int(volume_bytes)}
    if wire_format is not None:
        out["wire_format"] = wire_format
        itemsize = WIRE_ITEMSIZE.get(wire_format)
        if itemsize:
            out["f32_equivalent_bytes"] = int(volume_bytes * 4 / itemsize)
    dcn_share = max(0.0, min(float(dcn_volume_bytes or 0.0),
                             float(volume_bytes)))
    if dcn_share > 0:
        out["dcn_volume_bytes"] = int(dcn_share)
    ici_share = float(volume_bytes) - dcn_share
    moved = wire_bytes(family, volume_bytes, P)
    eff = effective_gbps(moved, measured_s)
    if eff is not None:
        out["effective_gbps"] = round(eff, 3)
    if not link_gbps:
        out["status"] = "skip"
        out["reason"] = ("no known interconnect bandwidth for this wire "
                         "(gloo, ranks sharing one card, or the CPU move "
                         "words through host memory)")
        return out
    if volume_bytes <= 0 or moved <= 0:
        out["status"] = "skip"
        out["reason"] = "no wire volume for this family"
        return out
    if dcn_share > 0 and not dcn_gbps:
        out["status"] = "skip"
        out["reason"] = (
            "collectives cross between hosts but no network bandwidth is "
            "known for this card (utils/platform.device_dcn_gbps returned "
            "None): a single-tier bound would be wrong either way")
        return out
    bound = wire_bytes(family, ici_share, P) / (link_gbps * 1e9)
    if dcn_share > 0:
        bound += wire_bytes(family, dcn_share, P) / (dcn_gbps * 1e9)
        out["dcn_gbps"] = round(float(dcn_gbps), 3)
    out["bound_s"] = round(bound, 6)
    out["bandwidth_pct"] = round(100.0 * (eff or 0.0) / link_gbps, 2)
    if measured_s <= bound * slack:
        out["status"] = "ok"
    else:
        out["status"] = "fail"
        out["reason"] = (
            f"measured {measured_s:.6f}s exceeds the wire explanation "
            f"{bound:.6f}s x slack {slack:g} — the collective is slower "
            "than volume / bandwidth accounts for (serialization, "
            "congestion, or a schedule regression)")
    return out


def comms_roofline(comms_s: "float | None", compute_s: "float | None",
                   link_gbps: "float | None" = None,
                   wire_bytes_moved: "float | None" = None) -> dict:
    """The comms side of the roofline of one dispatch: which side
    dominates, the comms fraction, and the overlap headroom (how much of
    the collective time a perfect schedule could hide under compute).
    Null with a reason where a side is missing."""
    out: dict = {}
    if comms_s is None or compute_s is None:
        out["comms_bound"] = None
        out["comms_reason"] = ("no measured comms/compute split for this "
                               "program")
        return out
    total = comms_s + compute_s
    out["comms_s"] = round(comms_s, 6)
    out["compute_s"] = round(compute_s, 6)
    out["comms_fraction"] = round(comms_s / total, 4) if total else 0.0
    out["comms_bound"] = "comms" if comms_s > compute_s else "compute"
    hideable = min(comms_s, compute_s)
    out["overlap_headroom_s"] = round(hideable, 6)
    out["exposed_floor_s"] = round(max(comms_s - compute_s, 0.0), 6)
    if link_gbps and wire_bytes_moved:
        eff = effective_gbps(wire_bytes_moved, comms_s)
        if eff is not None:
            out["effective_gbps"] = round(eff, 3)
            out["bandwidth_pct"] = round(100.0 * eff / link_gbps, 2)
    return out
