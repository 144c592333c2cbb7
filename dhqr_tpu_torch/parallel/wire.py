"""The collective seam of the port's sharded tier — the twin of
``dhqr_tpu/parallel/wire.py``.

Every collective in ``dhqr_tpu_torch/parallel/`` goes through this module
(``tests/test_torch_guards.py`` scans for any other call), and it is the
one place a collective's **wire format** is chosen. Three collectives:

* :func:`wire_broadcast` — the owner's payload to every rank, the twin of
  the JAX engines' one-hot ``wire_psum(jnp.where(mine, x, 0))``
  (``sharded_qr.py:234-236``): ``dist.broadcast`` from the owner;
* :func:`wire_psum` — ``all_reduce(SUM)``: dense reductions (the
  CholeskyQR Gram, ``onehot=False``) and one-hot group gathers with
  several owners;
* :func:`wire_all_gather` — ``all_gather``, concatenated in rank order.

Wire formats (``comms``; :data:`COMMS_MODES`):

* ``None`` — the uncompressed passthrough: the raw collective on the
  payload, results bit-identical to the uncompressed tier;
* ``"bf16"`` — each real floating payload crosses as bfloat16 and is
  widened back on arrival; every rank, the sender too, holds the rounded
  value (JAX's ``psum`` returns the same decompressed sum to every
  device, the owner included);
* ``"int8"`` — symmetric int8 with a scale per block of
  :data:`INT8_BLOCK_ROWS` rows of each column (one scalar scale for a
  1-D payload), the scales riding beside the payload. Dense sums refuse
  int8 (per-rank scales cannot be added) and carry bf16. Complex payloads
  never compress;
* ``"dcn:bf16"`` / ``"dcn:int8"`` — on a :class:`~dhqr_tpu_torch.parallel.
  topology.TierAxes` axis, only the hierarchical schedule's cross-host
  leg compresses; on a 1-D axis (or the flat schedule) they are the exact
  passthrough.

A call takes one tensor or a list of them (its **parts**: the logical
payloads the JAX package sends in separate ``psum`` calls, such as a
panel and its alpha); each part is quantized on its own, and all parts
ride one collective per wire dtype. A broadcast packs them into one byte
buffer.

On a :class:`TierAxes` axis the collectives run the JAX package's
two-tier schedules: reduce (or broadcast) inside each host first, cross
between hosts once per collective in ``1/ici_size``-row chunks, each
member of a host carrying its own chunk, and gather the chunks back
inside the host, uncompressed.

**Fault sites.** The ``parallel.collective.{corrupt,nan,drop}`` sites of
:mod:`dhqr_tpu_torch.faults` mutate each rank's contribution before it is
compressed, one visit per part of each collective leg, in site order
corrupt -> nan -> drop, as ``_inject_collective`` does. While a wire site
is armed a broadcast runs as the JAX package's one-hot sum (every rank
contributes: the owner its payload, the others zeros), so a fault on the
zero contributors adds what it adds in JAX. The JAX package consults a
site once per traced collective; the port, once per executed one: the
two agree where the JAX engines unroll their panel loop
(``n / nb <= MAX_UNROLLED_PANELS``).

**Integrity tags.** While the armor seam is armed with its wire tags
(:func:`dhqr_tpu_torch.armor.wire_tags_armed`), every COMPRESSED part
travels with one f32 ``(sum, sum|.|, 1)`` triple computed by its sender
before the fault sites mutate the payload, in the same collective (a
broadcast's or gather's byte buffer; a sum's f32 buffer). On arrival the
received payload's sum is held to the tag's within the format's rounding
bound (:func:`_int8_sum_bound`; :data:`_TAG_EPS_BF16`, plus
:data:`_TAG_EPS_BF16_PER_RANK` per rank for a dense bf16 sum); a mismatch
poisons the whole part NaN (:func:`_check_tag`), so the armor checksum
cannot miss it. Uncompressed parts carry no tag, and a disarmed seam
sends exactly what it sent before.

**The census.** Every collective is recorded — its family
(``broadcast`` / ``psum`` / ``all_gather``), leg (``flat``, ``ici`` or
``dcn``), wire format and dtype, payload bytes on the wire and the bytes
the same payload carries uncompressed — in every :func:`census` scope
open on the calling thread (pulse opens one around the dispatch it
measures). Bytes follow the JAX package's convention: a collective's
output on one rank (a gather: all ranks' shares). Since this module is
the only caller of collectives, the census is complete by construction.
"""

from __future__ import annotations

import contextlib
import math
import socket
import threading
from typing import Iterator

import torch
import torch.distributed as dist

from dhqr_tpu_torch.analysis import oplog as _oplog
from dhqr_tpu_torch.faults import harness as _faults
from dhqr_tpu_torch.parallel.topology import TierAxes
from dhqr_tpu_torch.precision import COMMS_MODES, WIRE_ITEMSIZE, resolve_comms

__all__ = [
    "COMMS_MODES",
    "CSNE_SWEEPS",
    "INT8_BLOCK_ROWS",
    "Pending",
    "WIRE_ITEMSIZE",
    "WireCensus",
    "census",
    "resolve_comms",
    "wire_all_gather",
    "wire_broadcast",
    "wire_psum",
]

#: Corrected-semi-normal sweeps the row-sharded engines run when (and only
#: when) their combine exchange is compressed:
#: ``x += (R^H R)^{-1} A^H (b - A x)``, the residual exact on the local
#: rows and the (n, nrhs) correction summed on the uncompressed wire.
CSNE_SWEEPS = 2

#: The model tier's floor of CSNE sweeps per wire format on a compressed
#: column-mesh solve (``qr_model.lstsq``): int8's coarser step needs two
#: more contractions than bf16 (the JAX package's measurement).
CSNE_MODEL_SWEEPS = {"bf16": 2, "int8": 4, "dcn:bf16": 2, "dcn:int8": 2}

#: The tiered formats: exact inside a host, compressed across hosts.
_DCN_TIERED = {"dcn:bf16": "bf16", "dcn:int8": "int8"}

#: Rows per int8 scale block: a factored panel mixes R rows of norm
#: ~sqrt(m) with reflector rows of norm ~1 in one column, so one scale
#: per column would quantize the reflectors against R's magnitude.
INT8_BLOCK_ROWS = 32


def seam_token(comms: "str | None" = None):
    """The armor seam's build-cache key material, re-exported at the JAX
    package's path (:func:`dhqr_tpu_torch.armor.seam_token`)."""
    from dhqr_tpu_torch import armor as _armor

    return _armor.seam_token(comms)


def _leg_comms(comms):
    """The wire formats ``(ici leg, dcn leg)`` of one collective: the flat
    formats compress both legs, the ``dcn:*`` ones only the crossing."""
    if comms in _DCN_TIERED:
        return None, _DCN_TIERED[comms]
    return comms, comms


def _compressible(x: torch.Tensor) -> bool:
    """Only real floating payloads compress (no bf16 complex format)."""
    return x.is_floating_point()


# -- the quantizer ------------------------------------------------------------

def _block_rows(rows: int) -> int:
    # Clamped to the row count: a short payload is one block of its rows.
    return min(INT8_BLOCK_ROWS, max(rows, 1))


def _scale_shape(shape) -> tuple:
    if len(shape) == 2:
        r, c = shape
        return (-(-r // _block_rows(r)), c)
    return tuple(shape[-1:]) if len(shape) > 2 else ()


def _safe_scale(scale: torch.Tensor) -> torch.Tensor:
    """Divide-safe scale: a zero block divides by 1 (and round-trips
    exactly); a NaN scale is kept, so the block dequantizes to NaN (an inf
    block likewise: q = 0, 0 * inf = NaN) — a poisoned payload never
    quantizes itself respectable."""
    return torch.where(scale > 0, scale,
                       torch.where(torch.isnan(scale), scale,
                                   torch.ones_like(scale)))


def _to_int8(t: torch.Tensor) -> torch.Tensor:
    # Round half to even, clamp to +-127; NaN converts to 0, as XLA's
    # float-to-integer conversion does.
    return torch.nan_to_num(torch.round(t).clamp(-127, 127),
                            nan=0.0).to(torch.int8)


def _quant_int8(x: torch.Tensor):
    """``(q int8, scale in x's dtype)``: absmax / 127 per
    (:data:`INT8_BLOCK_ROWS`-row block, column) of a matrix, over all but
    the last axis otherwise (one scalar for a vector). ``scale`` has shape
    ``(ceil(rows / block), cols)`` for a matrix."""
    if x.ndim == 2:
        r, c = x.shape
        block = _block_rows(r)
        blocks = -(-r // block)
        xb = x.new_zeros((blocks * block, c))
        xb[:r] = x
        xb = xb.reshape(blocks, block, c)
        scale = xb.abs().amax(dim=1) / 127.0
        q = _to_int8(xb / _safe_scale(scale)[:, None, :])
        return q.reshape(blocks * block, c)[:r], scale
    absmax = x.abs().amax() if x.ndim <= 1 else x.abs().amax(
        dim=tuple(range(x.ndim - 1)))
    scale = absmax / 127.0
    return _to_int8(x / _safe_scale(scale)), scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor, dtype):
    if q.ndim == 2 and scale.ndim == 2:
        r, c = q.shape
        block = _block_rows(r)
        blocks = scale.shape[0]
        qb = torch.zeros((blocks * block, c), dtype=dtype, device=q.device)
        qb[:r] = q.to(dtype)
        out = qb.reshape(blocks, block, c) * scale.to(dtype)[:, None, :]
        return out.reshape(blocks * block, c)[:r]
    return q.to(dtype) * scale.to(dtype)


# -- the fault sites ----------------------------------------------------------

def _wire_faults() -> bool:
    """The seam's one-read guard: an armed harness with a wire site."""
    return _faults.wire_sites_armed() and _faults.active() is not None


def _inject_collective(x: torch.Tensor) -> torch.Tensor:
    """One visit of the ``parallel.collective.*`` sites to this rank's
    contribution ``x`` (a new tensor when a site fires): ``corrupt`` adds
    ``1e4 (1 + max|x|)`` to element 0 (a high exponent bit flipped: a
    plausible dtype, a wildly wrong value), ``nan`` poisons element 0,
    ``drop`` zeroes the payload (the words never arrive)."""
    harness = _faults.active()
    if harness is None or x.numel() == 0:
        return x
    first = (0,) * x.ndim  # element 0 whatever the payload's strides
    if harness.should_fire("parallel.collective.corrupt"):
        hit = torch.zeros_like(x)
        hit[first] = 1
        x = x + hit * (1e4 * (1.0 + x.abs().max())).to(x.dtype)
    if harness.should_fire("parallel.collective.nan"):
        x = x.clone()
        x[first] = float("nan")
    if harness.should_fire("parallel.collective.drop"):
        x = torch.zeros_like(x)
    return x


# -- the integrity tags -------------------------------------------------------

#: Relative sum-tag slack of the bf16 wire: payload rounding is <= 2^-8
#: per element (x4 margin). Dense bf16 sums also accumulate up to P - 1
#: partial-sum roundings of ~2^-9 each, so their bound carries a
#: ``2^-9 * P`` term, P read from the tag's own count lane.
_TAG_EPS_BF16 = 4.0 * 2.0 ** -8
_TAG_EPS_BF16_PER_RANK = 2.0 ** -9


def _tags_armed() -> bool:
    from dhqr_tpu_torch import armor as _armor

    return _armor.wire_tags_armed()


def _pack_tags(x: torch.Tensor) -> torch.Tensor:
    """The integrity tag of one payload: ``(sum, sum|.|, 1)`` in f32 (the
    count lane sums to the number of contributing ranks)."""
    return torch.stack([x.sum(), x.abs().sum(),
                        torch.ones((), dtype=x.dtype, device=x.device)]
                       ).to(torch.float32)


def _int8_sum_bound(scale: torch.Tensor, elems_per_scale: int):
    """Worst-case |sum error| of an int8 block-scaled payload: at most
    scale / 2 per element, ``elems_per_scale`` elements per scale entry
    (the row block of a matrix, every element of a vector's one scale)."""
    return (0.5 * max(int(elems_per_scale), 1)
            * scale.sum().to(torch.float32) + 1e-30)


def _int8_elems_per_scale(shape) -> int:
    return (_block_rows(shape[0]) if len(shape) == 2
            else max(math.prod(shape), 1))


def _check_tag(rx: torch.Tensor, tag_sum, bound) -> torch.Tensor:
    """``rx``, or all NaN when its sum disagrees with the sender's tag by
    more than ``bound`` (a device-side select: no host read)."""
    ok = (rx.sum().to(torch.float32) - tag_sum).abs() <= bound
    return torch.where(ok, rx, torch.full_like(rx, float("nan")))


def _tags_of(parts, modes, sender: bool = True):
    """The (k, 3) tag rows of ``parts`` (zeros for an uncompressed part,
    and on a broadcast's receivers), or None when nothing is tagged."""
    if all(m is None for m in modes) or not _tags_armed():
        return None
    device = parts[0].device
    zero = torch.zeros(3, dtype=torch.float32, device=device)
    return torch.stack([_pack_tags(p) if m is not None and sender else zero
                        for p, m in zip(parts, modes)])


def _tagged_layout(parts, modes, tags):
    """The parts with the tag rows appended (raw f32) when there are any,
    and the layout they travel in."""
    if tags is None:
        return parts, _Layout(parts, modes)
    return parts + [tags], _Layout(parts + [tags], modes + [None])


def _tag_bound(mode, shape, tag, scale, onehot: bool):
    if mode == "int8":
        return _int8_sum_bound(scale, _int8_elems_per_scale(shape))
    eps = _TAG_EPS_BF16 if onehot else (
        _TAG_EPS_BF16 + _TAG_EPS_BF16_PER_RANK * tag[2])
    return eps * tag[1] + 1e-30


def _checked(outs, segs, tags, modes, onehot: bool) -> list:
    """Each compressed part of a received sum or broadcast held to its
    summed tag."""
    outs = list(outs)
    for j, mode in enumerate(modes):
        if mode is not None:
            bound = _tag_bound(mode, outs[j].shape, tags[j],
                               segs.get((j, "scale")), onehot)
            outs[j] = _check_tag(outs[j], tags[j][0], bound)
    return outs


def _checked_shares(shares, seg_list, modes) -> list:
    """A gather's shares (each ending in its sender's tag rows), each
    compressed part held over every share, as one gathered payload, to
    the sum of the shares' tags; a mismatch poisons that part in every
    share."""
    k = len(modes)
    tags = torch.stack([share[k] for share in shares])       # (P, k, 3)
    shares = [list(share[:k]) for share in shares]
    for j, mode in enumerate(modes):
        if mode is None:
            continue
        total = sum(share[j].sum().to(torch.float32) for share in shares)
        if mode == "int8":
            bound = _int8_sum_bound(
                torch.cat([segs[(j, "scale")].reshape(-1)
                           for segs in seg_list]),
                _int8_elems_per_scale(shares[0][j].shape))
        else:
            bound = _TAG_EPS_BF16 * tags[:, j, 1].sum() + 1e-30
        ok = (total - tags[:, j, 0].sum()).abs() <= bound
        for share in shares:
            share[j] = torch.where(ok, share[j],
                                   torch.full_like(share[j], float("nan")))
    return shares


# -- the census ---------------------------------------------------------------

class WireCensus:
    """The collectives of the wire seam while a :func:`census` scope is
    open: one entry per collective leg, with ``family``, ``leg``,
    ``comms`` (the leg's wire format), ``onehot`` (False for a dense
    sum), ``dtype`` (the payload's),
    ``wire`` (the dtypes on the wire), ``shapes`` (the parts), ``ranks``
    (of the leg), ``crosses_dcn``, ``launches`` (``torch.distributed``
    calls), ``bytes`` (on the wire) and ``raw_bytes`` (the same payload
    uncompressed)."""

    def __init__(self) -> None:
        self.entries: "list[dict]" = []

    def record(self, entry: dict) -> None:
        self.entries.append(entry)

    def families(self) -> "dict[str, dict]":
        """Per family: ``launches``, ``collectives``, ``volume_bytes``,
        ``dcn_volume_bytes`` (of legs that cross hosts) and
        ``raw_bytes`` — pulse's analytic side."""
        out: "dict[str, dict]" = {}
        for e in self.entries:
            row = out.setdefault(e["family"], {
                "launches": 0, "collectives": 0, "volume_bytes": 0,
                "dcn_volume_bytes": 0, "raw_bytes": 0})
            row["launches"] += e["launches"]
            row["collectives"] += 1
            row["volume_bytes"] += e["bytes"]
            row["raw_bytes"] += e["raw_bytes"]
            if e["crosses_dcn"]:
                row["dcn_volume_bytes"] += e["bytes"]
        return out


_SCOPES = threading.local()


@contextlib.contextmanager
def census() -> Iterator[WireCensus]:
    """Record every collective of the calling thread while the scope is
    open (scopes nest; each open scope sees every collective)."""
    stack = getattr(_SCOPES, "stack", None)
    if stack is None:
        stack = _SCOPES.stack = []
    scope = WireCensus()
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.remove(scope)


def _record(family, leg, mesh, comms, parts, wire, nbytes, raw, launches,
            crosses_dcn, onehot=True):
    stack = getattr(_SCOPES, "stack", None)
    if not stack:
        return
    entry = {"family": family, "leg": leg, "comms": comms, "onehot": onehot,
             "dtype": str(parts[0].dtype).replace("torch.", ""),
             "wire": wire, "shapes": [list(p.shape) for p in parts],
             "ranks": mesh.size, "crosses_dcn": bool(crosses_dcn),
             "launches": launches, "bytes": int(nbytes),
             "raw_bytes": int(raw)}
    for scope in stack:
        scope.record(entry)


def _nbytes(parts) -> int:
    return sum(p.numel() * p.element_size() for p in parts)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# -- packing parts ------------------------------------------------------------

def _mode(x: torch.Tensor, comms, onehot: bool):
    """How one part crosses: None (as it is), "bf16" or "int8"."""
    if comms is None or not _compressible(x):
        return None
    comms = _DCN_TIERED.get(comms, comms)
    return "int8" if comms == "int8" and onehot else "bf16"


class _Layout:
    """The wire segments of a list of parts: per part its scale and int8
    values, its bf16 values, or its raw values. Segments are ordered by
    element size, largest first, so each starts aligned in a byte buffer."""

    def __init__(self, parts, modes):
        self.parts = [(tuple(p.shape), p.dtype, m)
                      for p, m in zip(parts, modes)]
        segs = []
        for j, (shape, dtype, mode) in enumerate(self.parts):
            n = math.prod(shape)
            if mode == "int8":
                segs.append((j, "scale", dtype, math.prod(_scale_shape(shape))))
                segs.append((j, "q", torch.int8, n))
            elif mode == "bf16":
                segs.append((j, "v", torch.bfloat16, n))
            else:
                segs.append((j, "v", dtype, n))
        segs.sort(key=lambda s: -_itemsize(s[2]))
        self.segs = segs
        self.nbytes = sum(n * _itemsize(dt) for _, _, dt, n in segs)

    def wire(self) -> str:
        return "+".join(dict.fromkeys(_dtype_name(dt)
                                      for _, _, dt, _ in self.segs))

    def encode_parts(self, parts) -> "dict[tuple, torch.Tensor]":
        out = {}
        for j, (p, (_, _, mode)) in enumerate(zip(parts, self.parts)):
            if mode == "int8":
                out[(j, "q")], out[(j, "scale")] = _quant_int8(p)
            elif mode == "bf16":
                out[(j, "v")] = p.to(torch.bfloat16)
            else:
                out[(j, "v")] = p
        return out

    def decode_parts(self, segs: "dict[tuple, torch.Tensor]") -> list:
        out = []
        for j, (shape, dtype, mode) in enumerate(self.parts):
            if mode == "int8":
                out.append(_dequant_int8(
                    segs[(j, "q")].reshape(shape),
                    segs[(j, "scale")].reshape(_scale_shape(shape)), dtype))
            elif mode == "bf16":
                out.append(segs[(j, "v")].reshape(shape).to(dtype))
            else:
                out.append(segs[(j, "v")].reshape(shape))
        return out

    def to_bytes(self, parts, device) -> torch.Tensor:
        tensors = self.encode_parts(parts)
        buf = torch.empty(self.nbytes, dtype=torch.uint8, device=device)
        off = 0
        for j, role, dt, n in self.segs:
            size = n * _itemsize(dt)
            if size:
                buf[off:off + size] = _as_bytes(tensors[(j, role)])
            off += size
        return buf

    def segments(self, buf: torch.Tensor) -> "dict[tuple, torch.Tensor]":
        segs, off = {}, 0
        for j, role, dt, n in self.segs:
            size = n * _itemsize(dt)
            segs[(j, role)] = buf[off:off + size].view(dt)
            off += size
        return segs

    def from_bytes(self, buf: torch.Tensor) -> list:
        return self.decode_parts(self.segments(buf))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous().reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    return t.view(torch.uint8)


# -- pending collectives ------------------------------------------------------

class Pending:
    """A collective in flight: ``wait()`` blocks (on the card: makes the
    current stream wait) until it is done and returns its result."""

    def __init__(self, works, finish):
        self._works = works
        self._finish = finish

    def wait(self):
        for work in self._works:
            work.wait()
        return self._finish()


def _done(works, async_op: bool, finish):
    if async_op:
        return Pending(works, finish)
    return finish()


def _ready(value, async_op: bool):
    return Pending([], lambda: value) if async_op else value


def _then(out, fn):
    """``fn`` of a leg's result, or of a pending leg's once it is done."""
    if isinstance(out, Pending):
        return Pending([], lambda: fn(out.wait()))
    return fn(out)


def _as_parts(x):
    if isinstance(x, torch.Tensor):
        return [x], True
    return list(x), False


def _result(parts, single: bool):
    return parts[0] if single else parts


# -- the legs -----------------------------------------------------------------

def _bcast_leg(parts, src, mesh, comms, leg, crosses, async_op=False):
    """One broadcast of ``parts`` from mesh rank ``src`` at ``comms``; a
    compressed part carries its sender's integrity tag while the tags are
    armed."""
    sender = mesh.rank == src
    modes = [_mode(p, comms, onehot=True) for p in parts]
    raw = _nbytes(parts)
    tags = _tags_of(parts, modes, sender)
    if all(m is None for m in modes) and len({p.dtype for p in parts}) == 1:
        if len(parts) == 1 and parts[0].is_contiguous():
            buf = parts[0]  # in place on every rank
            finish = lambda: [buf]  # noqa: E731
        else:
            sizes = [p.numel() for p in parts]
            buf = torch.cat([p.reshape(-1) for p in parts]) if sender else \
                parts[0].new_empty(sum(sizes))
            shapes = [p.shape for p in parts]
            finish = lambda: [v.reshape(s) for v, s in  # noqa: E731
                              zip(buf.split(sizes), shapes)]
        wire, nbytes = _dtype_name(parts[0].dtype), raw
    else:
        sent, layout = _tagged_layout(parts, modes, tags)
        buf = layout.to_bytes(sent, mesh.device) if sender else \
            torch.empty(layout.nbytes, dtype=torch.uint8, device=mesh.device)

        def finish():
            segs = layout.segments(buf)
            out = layout.decode_parts(segs)
            if tags is None:
                return out
            return _checked(out[:-1], segs, out[-1], modes, onehot=True)

        wire, nbytes = layout.wire(), layout.nbytes
    work = dist.broadcast(buf, mesh.global_rank(src), group=mesh.group,
                          async_op=async_op)
    _record("broadcast", leg, mesh, comms, parts, wire, nbytes, raw, 1,
            crosses)
    return _done([work] if async_op else [], async_op, finish)


def _psum_leg(parts, mesh, comms, onehot, leg, crosses, async_op=False):
    """One sum over ``mesh`` of each rank's ``parts`` at ``comms`` (one
    ``all_reduce`` per wire dtype; the integrity tags, when armed, ride
    the f32 one)."""
    modes = [_mode(p, comms, onehot) for p in parts]
    tags = _tags_of(parts, modes)
    if _wire_faults():
        parts = [_inject_collective(p) for p in parts]
    raw = _nbytes(parts)
    if len(parts) == 1 and modes[0] is None and parts[0].is_contiguous():
        buf = parts[0]
        works = [dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group,
                                 async_op=async_op)]
        _record("psum", leg, mesh, comms, parts, _dtype_name(buf.dtype), raw,
                raw, 1, crosses, onehot)
        return _done(works if async_op else [], async_op, lambda: [buf])
    sent, layout = _tagged_layout(parts, modes, tags)
    tensors = layout.encode_parts(sent)
    groups: "dict[object, list]" = {}
    for j, role, dt, n in layout.segs:
        groups.setdefault(dt, []).append((j, role, n))
    bufs = {dt: torch.cat([tensors[(j, role)].reshape(-1)
                           for j, role, _ in segs])
            for dt, segs in groups.items()}
    works = [dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group,
                             async_op=async_op) for buf in bufs.values()]
    _record("psum", leg, mesh, comms, parts, layout.wire(), layout.nbytes,
            raw, len(bufs), crosses, onehot)

    def finish():
        segs = {}
        for dt, members in groups.items():
            for (j, role, _), v in zip(members, bufs[dt].split(
                    [n for _, _, n in members])):
                segs[(j, role)] = v
        out = layout.decode_parts(segs)
        if tags is None:
            return out
        return _checked(out[:-1], segs, out[-1], modes, onehot)

    return _done(works if async_op else [], async_op, finish)


def _gather_leg(parts, mesh, comms, leg, crosses, faults=True,
                async_op=False):
    """One all-gather over ``mesh`` of each rank's ``parts`` at ``comms``;
    the result is, per rank in mesh order, its parts. Compressed parts
    carry their integrity tags while the tags are armed."""
    modes = [_mode(p, comms, onehot=True) for p in parts]
    tags = _tags_of(parts, modes)
    if faults and _wire_faults():
        parts = [_inject_collective(p) for p in parts]
    P = mesh.size
    raw = P * _nbytes(parts)
    if len(parts) == 1 and modes[0] is None:
        x = parts[0].contiguous()
        outs = [torch.empty_like(x) for _ in range(P)]
        work = dist.all_gather(outs, x, group=mesh.group, async_op=async_op)
        _record("all_gather", leg, mesh, comms, parts, _dtype_name(x.dtype),
                raw, raw, 1, crosses)
        return _done([work] if async_op else [], async_op,
                     lambda: [[o] for o in outs])
    sent, layout = _tagged_layout(parts, modes, tags)
    buf = layout.to_bytes(sent, mesh.device)
    outs = [torch.empty_like(buf) for _ in range(P)]
    work = dist.all_gather(outs, buf, group=mesh.group, async_op=async_op)
    _record("all_gather", leg, mesh, comms, parts, layout.wire(),
            P * layout.nbytes, raw, 1, crosses)

    def finish():
        if tags is None:
            return [layout.from_bytes(o) for o in outs]
        seg_list = [layout.segments(o) for o in outs]
        shares = [layout.decode_parts(segs) for segs in seg_list]
        return _checked_shares(shares, seg_list, modes)

    return _done([work] if async_op else [], async_op, finish)


# -- the two-tier schedules ---------------------------------------------------

def _chunk(p: torch.Tensor, ici: int, i: int) -> torch.Tensor:
    """Member i's share of ``p``'s rows, padded to a multiple of ``ici``
    (a scalar part rides whole)."""
    if p.ndim == 0:
        return p
    rows = p.shape[0]
    crows = -(-rows // ici)
    if crows * ici != rows:
        padded = p.new_zeros((crows * ici,) + tuple(p.shape[1:]))
        padded[:rows] = p
        p = padded
    return p[i * crows:(i + 1) * crows]


def _ici_assemble(chunks, like, mesh):
    """Gather the members' chunks over the host (uncompressed, no fault
    site: the JAX schedule's raw tiled gather) and put each part's rows
    back in member order."""
    members = _gather_leg(chunks, mesh.ici_mesh, None, "ici", False,
                          faults=False)
    out = []
    for j, p in enumerate(like):
        if p.ndim == 0:
            out.append(members[0][j])
        else:
            out.append(torch.cat([m[j] for m in members])[:p.shape[0]])
    return out


def _tier_bcast(parts, src, mesh, t: TierAxes, comms):
    """The two-tier broadcast: inside the owner's host, then each of its
    members sends its chunk across the hosts once, then every host
    gathers the chunks back."""
    ici_c, dcn_c = _leg_comms(comms)
    if not t.hierarchical:  # one flat collective over both tiers
        return _bcast_leg(parts, src, mesh, ici_c, "flat", t.dcn_size > 1)
    d0, i0 = divmod(src, t.ici_size)
    d, i = divmod(mesh.rank, t.ici_size)
    if d == d0:
        parts = _bcast_leg(parts, i0, mesh.ici_mesh, ici_c, "ici", False)
    if t.dcn_size == 1:
        return parts
    chunks = _bcast_leg([_chunk(p, t.ici_size, i) for p in parts], d0,
                        mesh.dcn_mesh, dcn_c, "dcn", True)
    return _ici_assemble(chunks, parts, mesh)


def _tier_psum(parts, mesh, t: TierAxes, comms, onehot):
    """The two-tier sum: inside each host, then across the hosts once in
    ``1/ici_size``-row chunks, then the chunks gathered back in each
    host (``_tier_psum`` of the JAX seam)."""
    ici_c, dcn_c = _leg_comms(comms)
    if not t.hierarchical:
        return _psum_leg(parts, mesh, ici_c, onehot, "flat", t.dcn_size > 1)
    r = _psum_leg(parts, mesh.ici_mesh, ici_c, onehot, "ici", False)
    if t.dcn_size == 1:
        return r
    i = mesh.ici_mesh.rank
    chunks = _psum_leg([_chunk(p, t.ici_size, i) for p in r], mesh.dcn_mesh,
                       dcn_c, onehot, "dcn", True)
    return _ici_assemble(chunks, r, mesh)


def _tier_gather(parts, mesh, t: TierAxes, comms):
    """The two-tier gather: across the hosts first (the only compressed
    leg, ``dcn_size`` shares), then the stacks over the host,
    uncompressed; per rank in flat order ``d * ici_size + i``."""
    ici_c, dcn_c = _leg_comms(comms)
    if not t.hierarchical:
        return _gather_leg(parts, mesh, ici_c, "flat", t.dcn_size > 1)
    if t.dcn_size == 1:
        return _gather_leg(parts, mesh.ici_mesh, ici_c, "ici", False)
    g = _gather_leg(parts, mesh.dcn_mesh, dcn_c, "dcn", True)
    if t.ici_size == 1:
        return g
    stacks = [torch.stack([share[j] for share in g])
              for j in range(len(parts))]
    gg = _gather_leg(stacks, mesh.ici_mesh, None, "ici", False)
    return [[gg[i][j][d] for j in range(len(parts))]
            for d in range(t.dcn_size) for i in range(t.ici_size)]


# -- the seam -----------------------------------------------------------------

def _flat_comms(comms, axis):
    comms = resolve_comms(comms)
    if not isinstance(axis, TierAxes) and comms in _DCN_TIERED:
        return None  # no cross-host leg to compress on a 1-D axis
    return comms


def exact(comms, axis=None) -> bool:
    """Whether payloads arrive exactly as sent: no compressing format on
    this axis and no armed wire fault site (else a sender keeps what the
    wire delivered, as every JAX device keeps its ``psum``'s result)."""
    return _flat_comms(comms, axis) is None and not _wire_faults()


def wire_broadcast(x, src: int, mesh, comms=None, *, axis=None,
                   async_op: bool = False):
    """``x`` (a tensor, or a list of parts) of mesh rank ``src`` to every
    rank, at the ``comms`` wire format; receivers pass tensors of the
    same shapes and dtypes (their values are not read). Returns the
    payload as every rank holds it (rounded, on the sender too, when it
    compresses); uncompressed, a single contiguous tensor is filled in
    place. ``axis`` a :class:`TierAxes` (on a pod mesh) runs the two-tier
    schedule, synchronously. While a wire fault site is armed, the call
    is the JAX package's one-hot sum (module docstring)."""
    parts, single = _as_parts(x)
    comms = _flat_comms(comms, axis)
    if _wire_faults():
        mine = mesh.rank == src
        contrib = [p if mine else torch.zeros_like(p) for p in parts]
        return wire_psum(contrib if not single else contrib[0], mesh, comms,
                         axis=axis, async_op=async_op)
    if isinstance(axis, TierAxes):
        return _ready(_result(_tier_bcast(parts, src, mesh, axis, comms),
                              single), async_op)
    out = _bcast_leg(parts, src, mesh, comms, "flat", False, async_op)
    return _then(out, lambda v: _result(v, single))


def wire_psum(x, mesh, comms=None, *, onehot: bool = True, axis=None,
              async_op: bool = False):
    """The sum of every rank's ``x`` (a tensor, or a list of parts) at the
    ``comms`` wire format. ``onehot=True`` declares that at most one rank
    contributes each non-zero value, so int8 scales can be summed too;
    a dense sum (``onehot=False``) carries int8 as bf16. Uncompressed, a
    single contiguous tensor is reduced in place."""
    parts, single = _as_parts(x)
    comms = _flat_comms(comms, axis)
    if isinstance(axis, TierAxes):
        return _ready(_result(_tier_psum(parts, mesh, axis, comms, onehot),
                              single), async_op)
    out = _psum_leg(parts, mesh, comms, onehot, "flat", False, async_op)
    return _then(out, lambda v: _result(v, single))


def wire_all_gather(x: torch.Tensor, mesh, comms=None, *, dim: int = 0,
                    axis=None, async_op: bool = False,
                    relayout: bool = False):
    """Every rank's ``x`` (the same shape on every rank) at the ``comms``
    wire format, concatenated along ``dim`` in rank order. ``relayout``
    marks the engines' own relayout of a result (the JAX package's output
    sharding, done outside its shard body): exact, and not a fault site."""
    comms = None if relayout else _flat_comms(comms, axis)
    if isinstance(axis, TierAxes) and not relayout:
        shares = _tier_gather([x], mesh, axis, comms)
        return _ready(torch.cat([s[0] for s in shares], dim), async_op)
    # the op log files the relayout apart: the JAX package's output
    # sharding, done outside its program
    with _oplog.scope("relayout") if relayout else contextlib.nullcontext():
        out = _gather_leg([x], mesh, comms, "flat", False,
                          faults=not relayout, async_op=async_op)
    return _then(out, lambda shares: torch.cat([s[0] for s in shares], dim))


def host_keys(group=None) -> list:
    """Each rank's hostname, in rank order (every rank of ``group`` must
    call it): the host keys of :func:`~dhqr_tpu_torch.parallel.topology.
    detect_topology`. Mesh construction, not a dispatch: not in the
    census."""
    keys = [None] * dist.get_world_size(group)
    dist.all_gather_object(keys, socket.gethostname(), group=group)
    return keys
