"""Analytic communication budgets for the mesh engines — the port's own
copy of ``dhqr_tpu/analysis/cost_model.py`` (that module imports no JAX,
but the port imports nothing of the JAX package). Every function returns
the JAX module's integer for the same arguments
(``tests/test_torch_comms_pass.py`` holds them equal over a grid).

Each model returns the engine's *intended* per-rank collective payload
in words, parameterized exactly like the engines themselves (m, n, nb,
P, nrhs). The formulas are the schedule volumes the comms pass
(:mod:`dhqr_tpu_torch.analysis.comms_pass`) reads from the op log, so at
the pass's own shapes the logged volume matches the budget to the word
for the exact engines, and the contract's slack factor only has to
absorb the deliberate schedule variations (super-block row frames,
lookahead's one-panel-taller frame, the aggregated gather's packed
group). Anything past slack is a regression: an accidental all-gather of
the trailing matrix at P=2 is ~P·m·n/2 words per panel, orders of
magnitude over any of these.

The arguments mirror the papers' cost accounting: arXiv:2112.09017
(distributed dense linear algebra: collective volume, not flops, sets
the scaling) and arXiv:2112.01075 (collective *choice* decides
redistribution cost) — which is why the budget is a static contract and
not a benchmark.

Volume convention: a collective's payload is the byte size of its
tensors on one rank — for a sum or a broadcast the buffer, for a gather
the gathered (P·local) result: the JAX census's output-aval convention.
"""

from __future__ import annotations


def unblocked_qr_words(m: int, n: int, nb: int, P: int, nrhs: int = 1) -> int:
    """One m-word column psum per column (the reference's per-column
    reflector broadcast, src:141-143): n·m words."""
    return n * m


def blocked_qr_words(m: int, n: int, nb: int, P: int, nrhs: int = 1) -> int:
    """One psum per nb-wide panel of the shrinking (m-k, nb) factored
    panel plus its nb-word alpha block (sharded_qr._blocked_shard_body,
    unrolled schedule). The round-23 depth-k pipeline keeps this SAME
    budget: launch count is unchanged (two one-hot psums per panel) and
    the only volume delta is the delayed trailing update's frame — each
    pf psum ships up to ``depth * nb`` extra rows of already-finished R
    (the lookahead schedule already ships ``nb``), which the pipeline
    contracts' slack absorbs rather than a new model pricing in
    (analysis/comms_contracts.json, 'blocked_qr_pipeline*')."""
    return sum((m - k) * nb + nb for k in range(0, n, nb))


def sharded_solve_words(m: int, n: int, nb: int, P: int, nrhs: int = 1) -> int:
    """Q^H apply: one shrinking (m-k, nb) panel psum per panel; panel
    back-substitution: one packed (n, nrhs) psum per panel
    (sharded_solve._apply_qt_shard_body / _backsub_shard_body)."""
    apply_qt = sum((m - k) * nb for k in range(0, n, nb))
    backsub = (n // nb) * n * nrhs
    return apply_qt + backsub


def tsqr_lstsq_words(m: int, n: int, nb: int, P: int, nrhs: int = 1) -> int:
    """Exactly one all_gather of the (n, n) R heads and the (n, nrhs)
    reduced rhs: P·n·(n + nrhs) words gathered per device
    (sharded_tsqr._tsqr_shard_body)."""
    return P * n * (n + nrhs)


def cholqr_lstsq_words(m: int, n: int, nb: int, P: int, nrhs: int = 1) -> int:
    """One (n, n) Gram psum per CholeskyQR2 pass plus one (n, nrhs) psum
    for Q^H b (sharded_cholqr._cholqr_shard_body, shift=False)."""
    return 2 * n * n + n * nrhs


def no_comms_words(m: int, n: int, nb: int, P: int, nrhs: int = 1) -> int:
    """Engines contracted to run collective-free (the batched serving
    dispatch): any traced collective volume at all is a regression."""
    return 0


#: CSNE correction sweeps the row engines run per COMPRESSED solve
#: (``parallel/wire.CSNE_SWEEPS`` — kept in sync by test): each sweep adds
#: one (n, nrhs) correction psum on top of the combine exchange.
CSNE_SWEEPS = 2


def tsqr_lstsq_wire_words(m: int, n: int, nb: int, P: int,
                          nrhs: int = 1) -> int:
    """Compressed TSQR (dhqr-wire): the one all_gather pair of
    :func:`tsqr_lstsq_words` plus :data:`CSNE_SWEEPS` corrected-semi-
    normal (n, nrhs) psums (sharded_tsqr._tsqr_shard_body, comms set).
    The correction psums stay on the F32 wire by design, so their words
    are counted DOUBLE here: ``budget_bytes`` prices every word of a
    bf16 contract at 2 bytes, and 2 x 2 B = the 4 B the f32 correction
    actually moves (int8 contracts under-price them 2x — absorbed by
    their slack). They are O(1/(P*n)) of the gather at real shapes;
    the model carries them so audit-scale shapes stay exact."""
    return (tsqr_lstsq_words(m, n, nb, P, nrhs=nrhs)
            + 2 * CSNE_SWEEPS * n * nrhs)


def cholqr_lstsq_wire_words(m: int, n: int, nb: int, P: int,
                            nrhs: int = 1) -> int:
    """Compressed CholeskyQR2 (dhqr-wire): the Gram/Q^Hb psums of
    :func:`cholqr_lstsq_words` plus :data:`CSNE_SWEEPS` corrected-semi-
    normal (n, nrhs) psums — f32-wire, double-counted exactly as in
    :func:`tsqr_lstsq_wire_words` (sharded_cholqr._cholqr_shard_body)."""
    return (cholqr_lstsq_words(m, n, nb, P, nrhs=nrhs)
            + 2 * CSNE_SWEEPS * n * nrhs)


MODELS = {
    "unblocked_qr": unblocked_qr_words,
    "blocked_qr": blocked_qr_words,
    "sharded_solve": sharded_solve_words,
    "tsqr_lstsq": tsqr_lstsq_words,
    "cholqr_lstsq": cholqr_lstsq_words,
    "tsqr_lstsq_wire": tsqr_lstsq_wire_words,
    "cholqr_lstsq_wire": cholqr_lstsq_wire_words,
    "none": no_comms_words,
}


#: Wire bytes per word under each wire format: a literal copy of
#: ``dhqr_tpu_torch.precision.WIRE_ITEMSIZE`` (this module stays
#: stdlib-only, like its JAX twin; the test file pins the copies).
#: The dcn:* rungs price the DCN LEG of the hierarchical
#: schedule; their ICI legs are f32 (see tiered_budget_bytes below —
#: flat budget_bytes with a dcn:* mode prices the whole volume at the
#: DCN itemsize, which is only meaningful per-tier).
WIRE_ITEMSIZE = {"bf16": 2, "int8": 1, "dcn:bf16": 2, "dcn:int8": 1}


def budget_bytes(model: str, m: int, n: int, nb: int, P: int,
                 itemsize: int, nrhs: int = 1,
                 comms: "str | None" = None) -> int:
    """Analytic per-device collective budget in bytes for ``model``
    (a key of :data:`MODELS`) at the given engine parameters.

    ``comms`` (a dhqr-wire mode, round 18) prices the budget at the
    COMPRESSED wire itemsize instead of the array itemsize — words are
    schedule-invariant, so the same volume formula covers every wire
    format. The int8 rung's per-column f32 scale sidecars and the
    bf16 1-D fallbacks are deliberately NOT modeled (they are O(1/rows)
    relative); the compressed contracts' slack absorbs them, and a
    tightened slack on the bf16 entries is exactly what machine-checks
    the >= 1.8x traced-volume reduction (4 / (2 x 1.1) > 1.8)."""
    try:
        fn = MODELS[model]
    except KeyError:
        raise KeyError(
            f"unknown comms cost model {model!r} (have {sorted(MODELS)}); "
            "comms_contracts.json names a model this version does not ship"
        ) from None
    if comms is not None:
        try:
            itemsize = WIRE_ITEMSIZE[comms]
        except KeyError:
            raise KeyError(
                f"unknown comms wire format {comms!r} (have "
                f"{sorted(WIRE_ITEMSIZE)}); comms_contracts.json names a "
                "wire format this version does not ship"
            ) from None
    return fn(m, n, nb, P, nrhs=nrhs) * itemsize


# ---------------------------------------------------------------------------
# Two-tier (DCN x ICI) budgets — dhqr-pod, round 20.
#
# The word models above are schedule-invariant totals; a two-tier
# contract needs the per-TIER split, which depends on the collective
# SCHEDULE (hierarchical vs flat) and on the per-leg wire format (the
# dcn:* rungs compress only the DCN crossing). The split is derived
# from the same per-collective payload sequence the engines trace, so
# at the pass's own shapes the per-tier traced volume matches the
# budget to the byte for the exact engines.

#: Literal copy of ``parallel/wire._DCN_TIERED`` (same stdlib-only
#: reasoning as WIRE_ITEMSIZE above; pinned by the test file).
DCN_TIERED = {"dcn:bf16": "bf16", "dcn:int8": "int8"}


def payload_schedule(model: str, m: int, n: int, nb: int, P: int,
                     nrhs: int = 1):
    """The engine's per-collective payload sequence:
    ``(kind, rows, cols, f32_wire, onehot)`` tuples where ``kind`` is
    ``"psum"`` or ``"gather"``, ``(rows, cols)`` the payload shape on
    one device, ``f32_wire`` marks the CSNE correction reductions that
    stay on the exact f32 wire at every rung, and ``onehot`` the
    one-hot-broadcast invariant (dense reductions refuse int8 at the
    seam — the tiered pricing mirrors that refusal). Summing
    ``rows * cols`` over the sequence reproduces the word models above
    exactly."""
    if model == "unblocked_qr":
        return [("psum", m, 1, False, True)] * n
    if model == "blocked_qr":
        out = []
        for k in range(0, n, nb):
            out.append(("psum", m - k, nb, False, True))
            out.append(("psum", nb, 1, False, True))
        return out
    if model == "sharded_solve":
        out = [("psum", m - k, nb, False, True) for k in range(0, n, nb)]
        out += [("psum", n, nrhs, False, True)] * (n // nb)
        return out
    if model in ("tsqr_lstsq", "tsqr_lstsq_wire"):
        out = [("gather", n, n, False, True),
               ("gather", n, nrhs, False, True)]
        if model == "tsqr_lstsq_wire":
            out += [("psum", n, nrhs, True, False)] * CSNE_SWEEPS
        return out
    if model in ("cholqr_lstsq", "cholqr_lstsq_wire"):
        out = [("psum", n, n, False, False)] * 2
        out.append(("psum", n, nrhs, False, False))
        if model == "cholqr_lstsq_wire":
            out += [("psum", n, nrhs, True, False)] * CSNE_SWEEPS
        return out
    if model == "none":
        return []
    raise KeyError(
        f"unknown comms cost model {model!r} (have {sorted(MODELS)}); "
        "comms_contracts.json names a model this version does not ship")


def _leg_itemsize(mode: "str | None", itemsize: int, onehot: bool) -> int:
    """Wire bytes/word for one leg: f32 passthrough at ``itemsize``,
    int8 dense reductions degrade to bf16 exactly as at the seam."""
    if mode is None:
        return itemsize
    if mode == "int8" and not onehot:
        return WIRE_ITEMSIZE["bf16"]
    return WIRE_ITEMSIZE[mode]


def tiered_budget_bytes(model: str, m: int, n: int, nb: int, P: int,
                        itemsize: int, nrhs: int = 1,
                        comms: "str | None" = None,
                        topology: "tuple[int, int] | None" = None,
                        hierarchical: bool = True) -> "dict[str, int]":
    """Per-tier analytic collective budget ``{"ici": B, "dcn": B,
    "total": B}`` for ``model`` on a ``topology = (dcn_size,
    ici_size)`` mesh (dhqr-pod, round 20).

    Pricing mirrors the traced census byte-for-byte (output-aval
    convention, module docstring): a hierarchical ``psum`` is an ICI
    reduce (wire itemsize), a DCN chunk exchange of ``ceil(rows /
    ici_size)`` rows (DCN-leg itemsize — the ici_size-fold cross-DCN
    cut this round exists for), and an f32 ICI broadcast-back gather of
    the row-padded payload; a hierarchical ``gather`` exchanges only
    the local share across DCN then gathers the stacks over ICI in
    f32. The flat baseline (``hierarchical=False``) runs ONE joint-axis
    collective whose full payload crosses DCN — counted entirely on
    the DCN tier, which is exactly the comparison the serving_pod
    benchmark publishes. ``topology=None`` (a 1-D mesh) has no DCN
    tier at all; the ``dcn:*`` rungs degrade to f32 wherever no
    isolated DCN leg exists, mirroring the seam."""
    sched = payload_schedule(model, m, n, nb, P, nrhs=nrhs)
    if topology is None:
        total = budget_bytes(
            model, m, n, nb, P, itemsize, nrhs=nrhs,
            comms=None if comms in DCN_TIERED else comms)
        return {"ici": total, "dcn": 0, "total": total}
    dcn_size, ici_size = topology
    if dcn_size * ici_size != P:
        raise ValueError(
            f"topology {topology} does not factor P={P}")
    if comms in DCN_TIERED:
        ici_mode, dcn_mode = None, DCN_TIERED[comms]
    else:
        ici_mode = dcn_mode = comms
    ici = dcn = 0
    for kind, rows, cols, f32_wire, onehot in sched:
        im = None if f32_wire else ici_mode
        dm = None if f32_wire else dcn_mode
        if not hierarchical:
            # One joint-axis collective: the full payload crosses DCN.
            # dcn:* has no isolated DCN leg on the flat schedule -> f32.
            fm = None if comms in DCN_TIERED or f32_wire else comms
            isz = _leg_itemsize(fm, itemsize, onehot)
            words = P * rows * cols if kind == "gather" else rows * cols
            dcn += words * isz
            continue
        if kind == "psum":
            ici += rows * cols * _leg_itemsize(im, itemsize, onehot)
            if dcn_size > 1:
                rp = -(-rows // ici_size) * ici_size
                dcn += (rp // ici_size) * cols * _leg_itemsize(
                    dm, itemsize, onehot)
                ici += rp * cols * itemsize     # f32 broadcast-back
        else:  # gather
            if dcn_size > 1:
                dcn += (dcn_size * rows * cols
                        * _leg_itemsize(dm, itemsize, onehot))
                if ici_size > 1:
                    ici += P * rows * cols * itemsize
            else:
                ici += P * rows * cols * _leg_itemsize(
                    im, itemsize, onehot)
    return {"ici": ici, "dcn": dcn, "total": ici + dcn}
