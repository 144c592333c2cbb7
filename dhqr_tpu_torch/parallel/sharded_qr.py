"""Column-sharded QR over ``torch.distributed`` — port of
``dhqr_tpu/parallel/sharded_qr.py``.

The JAX package runs a sharded factorization as one SPMD program over a
1-D column mesh: the owner's column or panel reaches every device by a
one-hot ``psum``, every device factors redundantly, and the trailing
update is masked by global column index. The port runs one process per
rank (:mod:`dhqr_tpu_torch.parallel.mesh`), each holding its columns of
A in **store order** (contiguous blocks, or block-cyclic after
``layout.cyclic_store_columns``):

* the panel is factored on its **owner rank alone** — by the Hopper panel
  kernel on the card (``ops.blocked._panel_factor_kernel``, resolved
  against ``mesh.device`` as the JAX entry resolves against the mesh's
  device), or the plain panel engine — and the factored panel with its
  alpha goes to every rank in ONE broadcast
  (:func:`~dhqr_tpu_torch.parallel.wire.wire_broadcast`). So the kernel
  launches summed over the ranks equal the single-device plan;
* **live columns by slicing, not masking.** In both layouts a rank's local
  columns are stored in ascending global order, so the columns still to
  update — global index >= the panel's end — are a suffix of the local
  block: in the block layout those at global index >= k + nb, in the
  cyclic layout the stored blocks l with l P + p > kb (block l of rank p
  holds panel l P + p). The compact-WY update (``apply_block_reflector_h``,
  in place, ``trailing_precision`` kept) runs on that suffix only; each
  column receives the same arithmetic as under the JAX mask;
* one shrinking-slice loop at every size: the JAX engine's unrolled /
  scanned split bounds its program size, which eager PyTorch has none of.

Schedules (``sharded_blocked_qr``): the default; ``lookahead=True``, where
panel k+1's broadcast is put in flight before panel k's wide local GEMM
and waited for after it (the collective hides behind the GEMM, as the
JAX order lets XLA's scheduler do); ``agg_panels=k``, where each group of
k panels is gathered in ONE collective and factored redundantly on every
rank (launches: P times the plan's), and with ``lookahead=True`` the
grouped-lookahead composition; ``overlap_depth=k`` with ``lookahead``, the
depth-k pipeline: the broadcasts of the k panels after panel q are in
flight before panel q's wide GEMM.

``comms`` (the wire format, :mod:`~dhqr_tpu_torch.parallel.wire`) applies
to every broadcast of a factorization; under a compressed format the owner
keeps the panel as the wire delivered it, as every JAX device keeps the
``psum``'s result. ``axis_name`` a :class:`~dhqr_tpu_torch.parallel.
topology.TierAxes` (or any string on a pod mesh) runs each collective as
the two-tier schedule. The owner's broadcast carries the panel from its
diagonal row down (the JAX engines' scanned and lookahead frames also
carry R rows above it): under a compressed format the two packages round
the same reflectors, and the JAX package also rounds those R rows.
"""

from __future__ import annotations

import bisect
import warnings

import numpy as np
import torch

from dhqr_tpu_torch import armor as _armor
from dhqr_tpu_torch.obs import pulse as _pulse
from dhqr_tpu_torch.ops import gemm
from dhqr_tpu_torch.ops.blocked import (
    _panel_factor,
    _panel_factor_kernel,
    _resolve_kernel,
    apply_block_reflector_h,
    panel_plan,
)
from dhqr_tpu_torch.ops.householder import DEFAULT_PRECISION, householder_reflector
from dhqr_tpu_torch.parallel import wire
from dhqr_tpu_torch.parallel.layout import (
    cyclic_store_columns,
    natural_store_positions,
    plan_padding,
)
from dhqr_tpu_torch.parallel.mesh import DEFAULT_AXIS, check_mesh
from dhqr_tpu_torch.parallel.topology import (
    axis_label,
    axis_size,
    resolve_axis,
)
from dhqr_tpu_torch.precision import (
    apply_policy_to_comms_arg,
    apply_policy_to_factor_args,
    resolve_comms,
)
from dhqr_tpu_torch.utils.config import (
    DHQRConfig,
    refuse_grad,
    refuse_unported,
)
from dhqr_tpu_torch.utils.device import as_tensor, check_fp32_matmul

LAYOUTS = ("block", "cyclic")


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(
            f"layout must be 'block' or 'cyclic', got {layout!r}")


def _local_gidx(p: int, n: int, nloc: int, nb: int, layout: str) -> list:
    """Global (natural) column index of each of rank p's local columns, in
    store order — ascending in both layouts.

    "block": rank p holds the contiguous columns [p nloc, (p+1) nloc).
    "cyclic": rank p holds the nb-wide column blocks {kb : kb % P == p},
    stored consecutively (the order ``cyclic_store_columns`` gives)."""
    _check_layout(layout)
    P = n // nloc
    c = np.arange(nloc)
    if layout == "block":
        return (p * nloc + c).tolist()
    return (((c // nb) * P + p) * nb + c % nb).tolist()


def _panel_owner(k: int, n: int, nloc: int, nb: int, layout: str):
    """(owner rank, local column offset) of the nb-wide panel at column k."""
    P = n // nloc
    if layout == "block":
        owner = k // nloc
        return owner, k - owner * nloc
    kb = k // nb
    return kb % P, (kb // P) * nb


def _col_owner(col: int, n: int, nproc: int, nb: int, layout: str) -> int:
    """Owner rank of global column ``col`` (``nb``: the cyclic store's
    block width)."""
    nloc = n // nproc
    if layout == "cyclic":
        return (int(col) // max(nb, 1)) % nproc
    return int(col) // nloc


def _col_local(col: int, n: int, nproc: int, nb: int, layout: str) -> int:
    """Local (store) index of global column ``col`` on its owner."""
    nloc = n // nproc
    if layout == "cyclic":
        kb = col // nb
        return (kb // nproc) * nb + col % nb
    return col % nloc


def _check_divisibility(m, n, nproc, nb, layout="block"):
    if m < n:
        raise ValueError(f"requires m >= n, got {(m, n)}")
    if n % nproc != 0:
        raise ValueError(f"n={n} must be divisible by mesh size {nproc}")
    nloc = n // nproc
    if nb is not None and nloc % nb != 0 and nb < nloc:
        raise ValueError(
            f"panel width {nb} must divide local block width {nloc} "
            f"(or exceed it; pad n or choose block_size accordingly)"
        )
    if nb is not None and nb > nloc:
        raise ValueError(
            f"panel width {nb} wider than local block {nloc}: lower block_size "
            f"to <= {nloc} so each panel has a single owner"
        )


def _pad_cols_orthogonal(A: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Extend A (m, n) to (m + k, n_pad), k = n_pad - n, as [[A, 0], [0, I_k]].

    The padded columns live in the padded rows only, so the factorization
    of the padded matrix holds A's as its leading [:m, :n] block: a
    right-looking QR's column j depends on columns <= j only, A's
    reflectors vanish on the padded rows, and R's coupling block
    R[:n, n:] is exactly zero — a solve of the padded system with b padded
    by zero rows gives A's x in its first n entries. The sharded engines
    hold even blocks, so this replaces the reference's uneven worker
    blocks (``columnblocks``, src:18-19)."""
    m, n = A.shape
    k = n_pad - n
    if k == 0:
        return A
    out = A.new_zeros((m + k, n_pad))
    out[:m, :n] = A
    out[m:, n:] = torch.eye(k, dtype=A.dtype, device=A.device)
    return out


def _pad_rows(x, k: int):
    """x ((r,) or (r, c)) with k zero rows appended; None stays None."""
    if x is None or k == 0:
        return x
    out = x.new_zeros((x.shape[0] + k,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def _chain_refusal(n: int, divisor: str) -> ValueError:
    """A store-order input or output cannot be padded."""
    return ValueError(
        f"internal store-layout chaining requires n divisible by "
        f"{divisor}, got n={n}: pad the input before chaining")


def _pad_problem(A, nproc: int, block_size: int, b=None, *,
                 chained: bool = False, fixed_nb: bool = False):
    """``(Ap, bp, nb, n_pad)``, the one padding of every mesh entry point:
    the panel width and padded width for A's n on ``nproc`` ranks, A
    extended to n_pad columns (``_pad_cols_orthogonal``) and b (None stays
    None) by as many zero rows, so the padded system's x holds A's in its
    first n entries. ``plan_padding`` picks nb, unless ``fixed_nb``: then
    nb is ``block_size`` (the unblocked engine's cyclic store blocks) and
    n is padded to a multiple of nb P. ``chained`` (a store-order output)
    cannot be padded: an indivisible n raises."""
    n = A.shape[1]
    if fixed_nb:
        nb, step = block_size, block_size * nproc
        n_pad, divisor = -(-n // step) * step, str(step)
    else:
        nb, n_pad = plan_padding(n, nproc, block_size)
        divisor = f"nb*P = {nb * nproc}"
    if chained and n_pad != n:
        raise _chain_refusal(n, divisor)
    return _pad_cols_orthogonal(A, n_pad), _pad_rows(b, n_pad - n), nb, n_pad


def _local_block(A: torch.Tensor, mesh, n: int, nb: int, layout: str
                 ) -> torch.Tensor:
    """This rank's (m, n / P) columns of the global A, in store order (a
    new tensor)."""
    P, p = mesh.size, mesh.rank
    nloc = n // P
    if layout == "block":
        return A[:, p * nloc:(p + 1) * nloc].clone()
    cols = cyclic_store_columns(n, P, nb)[p * nloc:(p + 1) * nloc]
    return A.index_select(1, torch.as_tensor(cols, device=A.device))


def _gather_natural(Hl: torch.Tensor, mesh, n: int, nb: int, layout: str
                    ) -> torch.Tensor:
    """Every rank's block, all-gathered, in natural column order (m, n):
    the result's relayout (exact, whatever the wire format)."""
    H = wire.wire_all_gather(Hl, mesh, dim=1, relayout=True)
    if layout == "block":
        return H
    pos = natural_store_positions(n, mesh.size, nb)
    return H.index_select(1, torch.as_tensor(pos, device=H.device))


def _prepare(A, mesh, axis_name, layout):
    """(A on the mesh's device, resolved axis, rank count) with the checks
    every rank makes before any collective."""
    check_mesh(mesh)
    _check_layout(layout)
    A = as_tensor(A, mesh.device)
    check_fp32_matmul(A.device)
    refuse_grad(A, "the mesh engines")
    axis_name = resolve_axis(mesh, axis_name)
    return A, axis_name, axis_size(mesh, axis_name)


def _factor_result(label, dispatch, comms, Ap, mesh, n_pad, nb, layout,
                   nproc, shape, dtype, store_output: bool, verify: bool,
                   verify_nb: int):
    """Run a column-sharded factorization: ``dispatch(wire)`` returns this
    rank's store-order block and alpha. Returns that block with alpha
    (``store_output``), else the natural H cut to ``shape`` and alpha cut
    to n. With the armor seam armed and ``verify``, the JAX package's
    ``checked_dispatch`` over ``qr_gap`` wraps it: the weighted checksum
    is computed on the natural H every rank all-gathers (the exact
    relayout), against the padded ``Ap``, and localizes to the worst
    column's owner."""
    m, n = shape
    armed = verify and _armor.active() is not None

    def attempt(wire_comms):
        Hl, alpha = dispatch(wire_comms)
        H = _gather_natural(Hl, mesh, n_pad, nb, layout) \
            if armed or not store_output else None
        return Hl, alpha, H

    if not armed:
        Hl, alpha, H = attempt(comms)
    else:
        Hl, alpha, H = _armor.checked_dispatch(
            label, lambda: attempt(comms),
            lambda out: _armor.checks.qr_gap(out[2], out[1], Ap, verify_nb),
            engine="householder", comms=comms,
            degrade=(lambda: attempt(None)) if comms else None,
            shard_of=lambda col: _col_owner(col, n_pad, nproc, nb, layout),
            plan_shape=("qr", m, n, dtype, nproc))
    if store_output:
        return Hl, alpha
    return H[:m, :n], alpha[:n]


# -- unblocked --------------------------------------------------------------

def _unblocked_shard(Al, n, mesh, precision, layout, store_nb, norm,
                     comms=None, axis=None):
    """Factor the local block Al (m, nloc) in place; returns (Al, alpha).

    Per column j: the owner broadcasts rows j: of it (the reference's
    per-column reflector broadcast, src:141-143; the JAX engine sends the
    whole column), every rank forms the reflector (the full-length masked
    norm, as on one device) and updates its local columns right of j."""
    m, nloc = Al.shape
    p, P = mesh.rank, mesh.size
    gidx = _local_gidx(p, n, nloc, store_nb, layout)
    alpha = Al.new_zeros(n)
    for j in range(n):
        owner = _col_owner(j, n, P, store_nb, layout)
        jl = _col_local(j, n, P, store_nb, layout)
        buf = Al[j:, jl].contiguous() if p == owner \
            else Al.new_empty(m - j)
        buf = wire.wire_broadcast(buf, owner, mesh, comms, axis=axis)
        col = Al.new_zeros(m)
        col[j:] = buf
        v, alpha[j] = householder_reflector(col, j, norm)
        vj = v[j:]
        if p == owner:
            Al[j:, jl] = vj
        c0 = bisect.bisect_right(gidx, j)  # local columns right of j
        if c0 < nloc:
            w = gemm.matmul(vj.conj(), Al[j:, c0:], precision)
            Al[j:, c0:] -= torch.outer(vj, w)
    return Al, alpha


def sharded_householder_qr(A, mesh, axis_name=DEFAULT_AXIS,
                           precision: str = DEFAULT_PRECISION,
                           layout: str = "block", store_nb: int = 1,
                           _store_layout_output: bool = False,
                           norm: str = "accurate", comms=None,
                           _verify_store: bool = False):
    """Unblocked distributed QR: ``(H, alpha)``, one broadcast per column.

    Every rank of ``mesh`` calls it with the same global A (m x n, m >= n).
    Returns H (m, n) in natural column order on every rank (all-gathered)
    and alpha (n,), unless ``_store_layout_output``: then this rank's
    (m, n / P) block in store order and alpha (for chaining into
    :func:`~dhqr_tpu_torch.parallel.sharded_solve.sharded_solve`; n must
    then divide by ``store_nb * P``). ``layout="cyclic"`` stores
    ``store_nb``-wide blocks round-robin. ``comms``: the wire format of
    the column broadcasts. With the armor seam armed the factorization is
    verified (:func:`_factor_result`), unless it is a store-order link
    of a chain that verifies at its end (``_store_layout_output``
    without ``_verify_store``)."""
    comms = resolve_comms(comms)
    A, axis_name, nproc = _prepare(A, mesh, axis_name, layout)
    m, n = A.shape
    refuse_unported(DHQRConfig(precision=precision, norm=norm,
                               layout=layout), mesh)
    if layout == "block":
        store_nb = 1
    Ap, _, _, n_pad = _pad_problem(A, nproc, store_nb, fixed_nb=True,
                                   chained=_store_layout_output)
    if n_pad > 512:
        warnings.warn(
            f"unblocked sharded engine runs one m-vector collective per "
            f"column (n={n}): this is the reference-faithful slow tier (its "
            "author's own 'this is most expensive', src:141) — use the "
            "blocked compact-WY engine (blocked=True, the default) at scale",
            stacklevel=2,
        )
    _check_divisibility(Ap.shape[0], n_pad, nproc, None, layout)
    m_pad = Ap.shape[0]
    base_label = (f"unblocked_qr[P={axis_label(axis_name, nproc)},{m_pad}x"
                  f"{n_pad},{layout}]")
    comms = _armor.effective_comms(base_label, comms)

    def dispatch(wire_comms):
        return _pulse.observed_dispatch(
            base_label[:-1] + (f",w{wire_comms}" if wire_comms else "")
            + "]",
            lambda: _unblocked_shard(
                _local_block(Ap, mesh, n_pad, store_nb, layout), n_pad,
                mesh, precision, layout, store_nb, norm, wire_comms,
                axis_name),
            mesh=mesh, n_devices=nproc, wire_format=wire_comms)

    return _factor_result(
        base_label, dispatch, comms, Ap, mesh, n_pad, store_nb, layout,
        nproc, (m, n), A.dtype, _store_layout_output,
        _verify_store or not _store_layout_output, min(32, n_pad))


# -- blocked ----------------------------------------------------------------

class _Shard:
    """One rank's local block and what the blocked schedules share."""

    def __init__(self, Al, n, nb, mesh, layout, plan, precision, tprec,
                 norm, panel_impl, comms=None, axis=None):
        self.Al, self.n, self.nb, self.mesh = Al, n, nb, mesh
        self.layout, self.precision, self.tprec = layout, precision, tprec
        self.norm, self.panel_impl = norm, panel_impl
        self.comms, self.axis = comms, axis
        # Owners keep a panel as the wire delivered it unless it arrives
        # exactly as sent.
        self.keep_wire = not wire.exact(comms, axis)
        self.plan = plan
        self.p, self.P = mesh.rank, mesh.size
        self.nloc = Al.shape[1]
        self.gidx = _local_gidx(self.p, n, self.nloc, nb, layout)
        self.alpha = Al.new_zeros(n)

    def owner(self, k):
        return _panel_owner(k, self.n, self.nloc, self.nb, self.layout)

    def live(self, t: int) -> int:
        """First local column whose global index is >= t: the columns
        from there on are the live suffix."""
        return bisect.bisect_left(self.gidx, t)

    def factor(self, panel, leaf):
        """(pf, alpha) of a panel whose reflectors start at its row 0: the
        kernel when the plan gave a leaf width, else the panel engine."""
        if leaf:
            return _panel_factor_kernel(panel, 0, leaf, self.precision)
        return _panel_factor(panel, 0, self.precision, self.norm,
                             self.panel_impl)

    def update(self, Y, r0: int, t: int) -> None:
        """Apply the compact-WY transform of Y (reflectors from row r0) to
        rows r0: of the live local columns at global index >= t."""
        c0 = self.live(t)
        if c0 < self.nloc:
            apply_block_reflector_h(Y, self.Al[r0:, c0:], self.precision,
                                    self.tprec, inplace=True)

    def broadcast(self, parts, src, async_op=False):
        return wire.wire_broadcast(parts, src, self.mesh, self.comms,
                                   axis=self.axis, async_op=async_op)

    def share_panel(self, k: int, leaf: int, async_op: bool = False):
        """Factor panel k on its owner (in place) and broadcast the factored
        panel (rows k:) and its alpha to every rank, in one collective."""
        owner, kl = self.owner(k)
        m, nb = self.Al.shape[0], self.nb
        if self.p == owner:
            panel = self.Al[k:, kl:kl + nb]
            pf, alpha_k = self.factor(panel, leaf)
            panel.copy_(pf)
            parts = [pf, alpha_k]
        else:
            parts = [self.Al.new_empty((m - k, nb)), self.Al.new_empty(nb)]
        return self.broadcast(parts, owner, async_op)

    def take_panel(self, k: int, parts) -> torch.Tensor:
        """Record the shared panel's alpha (and on its owner, under a lossy
        wire, the panel as delivered); returns its Y (rows k:)."""
        pf, alpha_k = parts
        self.alpha[k:k + self.nb] = alpha_k
        owner, kl = self.owner(k)
        if self.keep_wire and self.p == owner:
            self.Al[k:, kl:kl + self.nb] = pf
        return torch.tril(pf)

    def gather_group(self, group, r0: int, async_op: bool = False):
        """The group's columns, rows r0:, on every rank in ONE collective:
        a broadcast when one rank owns the whole group, else the sum of
        the owners' one-hot contributions (exact: the rest add zeros)."""
        m, nb = self.Al.shape[0], self.nb
        owners = [self.owner(k) for k, _, _ in group]
        cols = [self.Al[r0:, kl:kl + nb] for _, kl in owners]
        ranks = {o for o, _ in owners}
        if len(ranks) == 1:
            (src,) = ranks
            buf = torch.cat(cols, 1) if self.p == src else \
                self.Al.new_empty((m - r0, nb * len(group)))
            return self.broadcast(buf, src, async_op)
        buf = self.Al.new_zeros((m - r0, nb * len(group)))
        for j, (o, _) in enumerate(owners):
            if o == self.p:
                buf[:, j * nb:(j + 1) * nb] = cols[j]
        return wire.wire_psum(buf, self.mesh, self.comms, axis=self.axis,
                              async_op=async_op)

    def factor_group(self, G, c0: int, group) -> None:
        """Factor the gathered group G in place (its diagonal at row c0),
        left to right, each panel's transform applied to the group's
        remaining columns only (``_factor_group`` of the JAX engines), and
        record alpha."""
        nb = self.nb
        for j, (k, _, leaf) in enumerate(group):
            c, r = j * nb, c0 + j * nb
            pf, alpha_k = self.factor(G[r:, c:c + nb], leaf)
            G[r:, c:c + nb] = pf
            self.alpha[k:k + nb] = alpha_k
            if j < len(group) - 1:
                apply_block_reflector_h(torch.tril(pf), G[r:, c + nb:],
                                        self.precision, self.tprec,
                                        inplace=True)

    def scatter_group(self, G, group, r0: int) -> None:
        """Owners write their factored panels (rows r0:) back."""
        nb = self.nb
        for j, (k, _, _) in enumerate(group):
            owner, kl = self.owner(k)
            if owner == self.p:
                self.Al[r0:, kl:kl + nb] = G[:, j * nb:(j + 1) * nb]


def _default_schedule(s: _Shard) -> None:
    for k, _, leaf in s.plan:
        Y = s.take_panel(k, s.share_panel(k, leaf))
        s.update(Y, k, k + s.nb)


def _lookahead_schedule(s: _Shard) -> None:
    """Panel k+1 factored on its owner (after panel k's transform reached
    its columns) and its broadcast put in flight BEFORE panel k's wide
    local GEMM, whose columns it neither reads nor writes; the handle is
    waited for after the GEMM (``_blocked_shard_lookahead``'s order)."""
    k0, _, leaf0 = s.plan[0]
    Yp, kp = s.take_panel(k0, s.share_panel(k0, leaf0)), k0
    for k1, _, leaf1 in s.plan[1:]:
        owner1, kl1 = s.owner(k1)
        if s.p == owner1:  # the lookahead update: panel kp -> panel k1
            apply_block_reflector_h(Yp, s.Al[kp:, kl1:kl1 + s.nb],
                                    s.precision, s.tprec, inplace=True)
        pending = s.share_panel(k1, leaf1, async_op=True)
        s.update(Yp, kp, k1 + s.nb)  # the wide GEMM, beside the broadcast
        Yp, kp = s.take_panel(k1, pending.wait()), k1


class _InFlight:
    """A shared panel of the pipeline: its broadcast, waited for (and the
    panel taken) the first time its Y is needed."""

    def __init__(self, s: _Shard, k: int, pending):
        self.s, self.k, self.pending, self.Y = s, k, pending, None

    def y(self) -> torch.Tensor:
        if self.Y is None:
            self.Y = self.s.take_panel(self.k, self.pending.wait())
        return self.Y


def _pipeline_schedule(s: _Shard, depth: int) -> None:
    """The depth-k pipeline (``_blocked_shard_pipeline``): up to ``depth``
    shared panels in flight. Panel q's owner first applies the pending
    panels' transforms to its columns, oldest first (the narrow updates),
    factors it and puts its broadcast in flight; then, once ``depth``
    panels are pending, the oldest one's wide GEMM runs on the live
    columns past panel q, and leaves the ring. A column of panel j thus
    receives panels < j - depth through wide GEMMs and the rest through
    narrow ones, in ascending order, as in the lookahead order (depth 1).
    Every panel's transform has reached every column when the last panel
    factors; the drain only takes the panels still in flight."""
    ring: "list[_InFlight]" = []
    for k1, _, leaf1 in s.plan:
        owner1, kl1 = s.owner(k1)
        if s.p == owner1:
            for entry in ring:
                apply_block_reflector_h(
                    entry.y(), s.Al[entry.k:, kl1:kl1 + s.nb],
                    s.precision, s.tprec, inplace=True)
        pending = s.share_panel(k1, leaf1, async_op=True)
        if len(ring) == depth:
            oldest = ring.pop(0)
            s.update(oldest.y(), oldest.k, k1 + s.nb)  # beside the flight
        ring.append(_InFlight(s, k1, pending))
    for entry in ring:
        entry.y()


def _grouped_schedule(s: _Shard, k: int, lookahead: bool) -> None:
    """``agg_panels=k``: groups of k consecutive panels from column 0 (the
    last may be smaller). Each group is gathered in one collective,
    factored redundantly on every rank, written back by its owners, and
    applied to the live columns past it in one aggregated update. With
    ``lookahead``: group g's gather (rows from group g-1's start) is put
    in flight before group g-1's wide GEMM on the columns past group g;
    then group g-1's transform reaches the gathered copy, and group g
    factors (``_blocked_shard_agg``'s grouped-lookahead order)."""
    groups = [s.plan[g:g + k] for g in range(0, len(s.plan), k)]
    k0 = groups[0][0][0]
    G = s.gather_group(groups[0], k0)
    s.factor_group(G, 0, groups[0])
    s.scatter_group(G, groups[0], k0)
    Yp, kp = torch.tril(G), k0
    for group in groups[1:]:
        k1 = group[0][0]
        end = group[-1][0] + s.nb
        if not lookahead:
            s.update(Yp, kp, k1)
            G = s.gather_group(group, k1)
            s.factor_group(G, 0, group)
            s.scatter_group(G, group, k1)
            Yp, kp = torch.tril(G), k1
            continue
        pending = s.gather_group(group, kp, async_op=True)
        s.update(Yp, kp, end)  # the wide GEMM, beside the gather
        G = pending.wait()
        apply_block_reflector_h(Yp, G, s.precision, s.tprec, inplace=True)
        s.factor_group(G, k1 - kp, group)
        s.scatter_group(G, group, kp)
        Yp, kp = torch.tril(G[k1 - kp:]), k1


def _blocked_shard(Al, n, nb, mesh, layout, plan, precision, tprec, norm,
                   panel_impl, lookahead, agg_panels, depth=None, comms=None,
                   axis=None):
    """Factor the local block Al (m, n / P) in place; returns (Al, alpha).
    ``depth`` (>= 2, resolved by the caller) picks the pipeline."""
    s = _Shard(Al, n, nb, mesh, layout, plan, precision, tprec, norm,
               panel_impl, comms, axis)
    if agg_panels and len(plan) > 1:
        _grouped_schedule(s, agg_panels, lookahead)
    elif depth:
        _pipeline_schedule(s, depth)
    elif lookahead and len(plan) > 1:
        _lookahead_schedule(s)
    else:
        _default_schedule(s)
    return s.Al, s.alpha


def sharded_blocked_qr(A, mesh, block_size: int = 128,
                       axis_name=DEFAULT_AXIS,
                       precision: str = DEFAULT_PRECISION,
                       layout: str = "block",
                       _store_layout_output: bool = False,
                       norm: str = "accurate", use_pallas: str = "auto",
                       panel_impl: str = "loop",
                       trailing_precision: "str | None" = None,
                       lookahead: bool = False,
                       agg_panels: "int | None" = None,
                       overlap_depth: "int | None" = None, comms=None,
                       policy=None, _verify_store: bool = False):
    """Compact-WY distributed QR: one broadcast per panel, GEMM trailing
    updates on each rank's live columns.

    Every rank of ``mesh`` calls it with the same global A (m x n,
    m >= n; an n that does not divide into nb-wide panels over the ranks
    is padded, ``_pad_cols_orthogonal``). Returns H (m, n) in natural
    column order on every rank (all-gathered) and alpha (n,), unless
    ``_store_layout_output``: then this rank's block in store order
    (n must divide by nb * P). ``use_pallas`` routes the owner's panels
    through the Hopper panel kernel (resolved against ``mesh.device``).
    ``lookahead`` and ``agg_panels`` pick the schedule (module docstring);
    ``overlap_depth=k`` (with ``lookahead``) the depth-k pipeline, its
    depth clamped to the panels after the first (depth 1 is the lookahead
    order); it is exclusive with ``agg_panels``. ``comms`` names the wire
    format of every broadcast (``"bf16"`` / ``"int8"`` / ``"dcn:*"``;
    None keeps the uncompressed tier's results bit for bit). ``policy``
    sets ``precision`` / ``trailing_precision`` / ``comms`` together.
    With the armor seam armed the factorization is verified by its
    weighted checksum (:func:`_factor_result`; re-dispatch, then the f32
    wire, then typed), unless it is a store-order link of a chain that
    verifies at its end (``_store_layout_output`` without
    ``_verify_store``, as ``sharded_lstsq`` calls it).
    """
    comms = apply_policy_to_comms_arg(policy, comms)
    precision, trailing_precision = apply_policy_to_factor_args(
        policy, precision, trailing_precision,
        default_precision=DEFAULT_PRECISION)
    A, axis_name, nproc = _prepare(A, mesh, axis_name, layout)
    m, n = A.shape
    if agg_panels is not None and agg_panels < 2:
        raise ValueError(f"agg_panels must be >= 2 (got {agg_panels}); "
                         "use None to disable aggregation")
    if overlap_depth is not None:
        if overlap_depth < 1:
            raise ValueError(
                f"overlap_depth must be >= 1 (got {overlap_depth}); "
                "use None for the default schedule")
        if not lookahead:
            raise ValueError(
                "overlap_depth generalizes the lookahead order and "
                "requires lookahead=True (depth 1 IS the one-panel "
                "lookahead)")
        if agg_panels:
            raise ValueError(
                "overlap_depth composes with the per-panel lookahead "
                "order only; it is mutually exclusive with agg_panels "
                "(the grouped-lookahead composition already overlaps "
                "one full group per collective)")
    if agg_panels and lookahead and nproc == 1:
        warnings.warn(
            "agg_panels + lookahead on a 1-device mesh: no collective to "
            "hide, the composition only adds flops (the harness rejects "
            "this pair at ndev == 1); proceeding as the mesh tier",
            stacklevel=2,
        )
    refuse_unported(DHQRConfig(
        precision=precision, use_pallas=use_pallas, norm=norm,
        panel_impl=panel_impl, trailing_precision=trailing_precision,
        layout=layout, lookahead=lookahead, agg_panels=agg_panels,
        overlap_depth=overlap_depth), mesh)
    Ap, _, nb, n_pad = _pad_problem(A, nproc, block_size,
                                    chained=_store_layout_output)
    m_pad = Ap.shape[0]
    _check_divisibility(m_pad, n_pad, nproc, nb, layout)
    depth = None
    if overlap_depth is not None:
        # Clamped to the deepest pipeline the panel count supports; depth
        # 1 IS the one-panel lookahead order.
        depth = min(overlap_depth, max(n_pad // nb - 1, 1))
        if depth <= 1:
            depth = None
    kernel = _resolve_kernel(use_pallas, m_pad, A.dtype, mesh.device)
    plan = panel_plan(m_pad, n_pad, nb, kernel, A.dtype, mesh.device)
    sched = (((f"la{depth}" if depth else "la") if lookahead else "")
             + (f"agg{agg_panels}" if agg_panels else ""))
    base_label = (f"blocked_qr[P={axis_label(axis_name, nproc)},{m_pad}x"
                  f"{n_pad},nb={nb},{layout}"
                  + (f",{sched}" if sched else "") + "]")
    comms = _armor.effective_comms(base_label, comms)

    def dispatch(wire_comms):
        return _pulse.observed_dispatch(
            base_label[:-1] + (f",w{wire_comms}" if wire_comms else "")
            + "]",
            lambda: _blocked_shard(
                _local_block(Ap, mesh, n_pad, nb, layout), n_pad, nb, mesh,
                layout, plan, precision, trailing_precision, norm,
                panel_impl, lookahead, agg_panels, depth, wire_comms,
                axis_name),
            mesh=mesh, n_devices=nproc, wire_format=wire_comms)

    return _factor_result(
        base_label, dispatch, comms, Ap, mesh, n_pad, nb, layout, nproc,
        (m, n), A.dtype, _store_layout_output,
        _verify_store or not _store_layout_output, nb)
