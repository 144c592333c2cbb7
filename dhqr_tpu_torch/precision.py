"""Precision policy — port of ``dhqr_tpu/precision.py``: one object naming
every matmul-precision knob at once.

The accuracy/throughput trade lives in four places that must be chosen
together to mean anything:

* the PANEL precision — the dependent chains (reflector norms/dots, the
  compact-WY T-factor recurrence) whose rounding every later column
  inherits;
* the TRAILING precision — the wide trailing-update GEMMs holding ~all the
  flops, whose rounding is NOT amplified (each output element is touched
  once);
* the APPLY precision — the Q/Q^H applies of the solve stage;
* the REFINEMENT count — iterative-refinement sweeps that reuse the stored
  factorization (``r = b - A x; x += solve(r)``, residual matvec at full
  precision) and buy back the backward error a cheaper factor gave up.

The names keep the JAX package's meaning, which is the TPU MXU's: a float32
product at ``"highest"`` (or ``"float32"``) is full FP32, at ``"high"`` it is
three bf16 x bf16 products with f32 accumulation (a = a_hi + a_lo, b = b_hi
+ b_lo, and a_lo b_lo dropped), at ``"default"`` one such product. The port
computes them so on every device (:mod:`dhqr_tpu_torch.ops.gemm`); float64
and complex128 run at full precision whatever the name.

Every engine accepts ``policy=``: the factor-only entry points
(``blocked_householder_qr``, ``tsqr_r``, ``cholesky_qr2``) consume the
precision fields and ignore the solve-stage fields (``apply``, ``refine``);
the solve surfaces (``qr``/``lstsq``, ``tsqr_lstsq``, ``cholesky_qr_lstsq``)
consume all four.

This module imports nothing but the standard library.
"""

from __future__ import annotations

import dataclasses

# Matmul precisions in order of cost (float32 inputs): highest = full FP32,
# high = 3 bf16 passes, default = 1 bf16 pass.
TRAILING_PRECISIONS = ("highest", "high", "default")

# Passes per float32 GEMM at each name, as the TPU's MXU counts them
# (full FP32 is 6 bf16 passes there); the JAX package's cost model.
MXU_PASSES = {"highest": 6, "high": 3, "default": 1, "float32": 6}

# Collective wire formats of the sharded tier (parallel/wire.py), parsed as
# the JAX package parses them.
COMMS_MODES = ("bf16", "int8", "dcn:bf16", "dcn:int8")
WIRE_ITEMSIZE = {None: None, "bf16": 2, "int8": 1,
                 "dcn:bf16": 2, "dcn:int8": 1}


def resolve_comms(comms) -> "str | None":
    """Validate/normalize a collective wire format: None (also the
    explicit "none"/"f32" spellings) keeps the uncompressed wire."""
    if comms is None or comms in ("none", "f32"):
        return None
    if comms not in COMMS_MODES:
        raise ValueError(
            f"comms must be one of {COMMS_MODES} or None (uncompressed), "
            f"got {comms!r}"
        )
    return comms


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One named point in the precision/refinement trade space.

    Attributes:
      panel: precision of the accuracy-critical dependent chains — panel
        factorization (reflector norms/dots) and the compact-WY T-factor.
        The presets never lower this field.
      trailing: precision of the trailing-update GEMMs only (and, for the
        row engines, the bulk GEMM analogue: TSQR leaf trailing updates,
        the CholeskyQR Gram product). ``None`` means "same as panel".
      apply: precision of the solve stage's Q/Q^H applies. ``None`` means
        "same as panel".
      refine: iterative-refinement sweeps for the solve surfaces; the
        factor-only entry points ignore it.
      comms: wire format of the sharded tier's collectives (None = the
        uncompressed wire); see :data:`COMMS_MODES`.
    """

    panel: str = "highest"
    trailing: "str | None" = None
    apply: "str | None" = None
    refine: int = 0
    comms: "str | None" = None

    def __post_init__(self):
        for field, value in (("panel", self.panel),
                             ("trailing", self.trailing),
                             ("apply", self.apply)):
            if value is not None and value not in MXU_PASSES:
                raise ValueError(
                    f"PrecisionPolicy.{field} must be one of "
                    f"{sorted(MXU_PASSES)} or None, got {value!r}"
                )
        if self.refine < 0:
            raise ValueError(f"refine must be >= 0, got {self.refine}")
        object.__setattr__(self, "comms", resolve_comms(self.comms))

    def resolved_trailing(self) -> str:
        return self.panel if self.trailing is None else self.trailing

    def resolved_apply(self) -> str:
        return self.panel if self.apply is None else self.apply

    def split_trailing(self) -> "str | None":
        """The ``trailing_precision`` engine argument: None when the policy
        does not actually split."""
        t = self.resolved_trailing()
        return None if t == self.panel else t


# The named grid. "accurate" is the default (full precision everywhere, no
# refinement). The split presets pair a cheaper trailing precision with ONE
# refinement sweep.
PRECISION_POLICIES = {
    "accurate": PrecisionPolicy(),
    "balanced": PrecisionPolicy(trailing="high", refine=1),
    "fast": PrecisionPolicy(trailing="default", refine=1),
}

# The A/B ladder: every trailing precision, with and without one
# refinement sweep (6 cells).
POLICY_LADDER = tuple(
    PrecisionPolicy(trailing=None if t == "highest" else t, refine=r)
    for t in TRAILING_PRECISIONS
    for r in (0, 1)
)


def resolve_policy(policy) -> PrecisionPolicy:
    """Accept a policy name, a :class:`PrecisionPolicy`, or a spec string.

    Spec strings name the fields positionally, slash-separated:
    ``"panel"``, ``"panel/trailing"``, ``"panel/trailing/rN"``, and a
    fourth comms-wire segment ``"panel/trailing/rN/bf16"`` (a
    :data:`COMMS_MODES` member; ``"highest/dcn:bf16"`` — the ``:`` is not a
    separator). This is the ``DHQR_POLICY`` environment spelling.
    """
    if isinstance(policy, PrecisionPolicy):
        return policy
    if not isinstance(policy, str):
        raise TypeError(
            f"policy must be a PrecisionPolicy, a preset name "
            f"{sorted(PRECISION_POLICIES)}, or a spec string, got "
            f"{type(policy).__name__}"
        )
    if policy in PRECISION_POLICIES:
        return PRECISION_POLICIES[policy]
    parts = policy.split("/")
    # The comms segment is popped first (it is the last segment when
    # present); its names never collide with the precision names or rN.
    comms = None
    if parts and parts[-1] in COMMS_MODES:
        comms = parts.pop()
    refine = 0
    if parts and parts[-1][:1] == "r" and parts[-1][1:].isdigit():
        refine = int(parts.pop()[1:])
    if not parts or len(parts) > 2 or not all(parts):
        raise ValueError(
            f"unknown policy {policy!r}: expected a preset name "
            f"{sorted(PRECISION_POLICIES)} or 'panel[/trailing][/rN][/comms]'"
        )
    panel = parts[0]
    trailing = parts[1] if len(parts) == 2 else None
    if trailing == panel:
        trailing = None
    return PrecisionPolicy(panel=panel, trailing=trailing, refine=refine,
                           comms=comms)


def escalation_policies(policy=None, *, base_refine: int = 0,
                        cheap: "bool | None" = None):
    """The accuracy-escalation tail of a numeric fallback ladder: try
    ``accurate`` (when the caller ran anything cheaper without
    refinement), then ``accurate`` with one more refinement sweep than
    anything tried so far.

    ``cheap`` overrides the is-this-policy-cheaper-than-accurate derivation
    for callers who spelled their precision via the classic knobs.
    Returns a tuple of :class:`PrecisionPolicy`.
    """
    pol = resolve_policy(policy) if policy is not None else None
    refine = pol.refine if pol is not None else int(base_refine)
    if cheap is None:
        cheap = pol is not None and bool(
            pol.trailing or pol.apply or pol.comms
            or pol.panel != "highest")
    out = []
    if cheap and refine == 0:
        out.append(PRECISION_POLICIES["accurate"])
    out.append(PrecisionPolicy(refine=refine + 1))
    return tuple(out)


def apply_policy_to_factor_args(policy, precision, trailing_precision,
                                default_precision: str = "highest"):
    """Map ``policy`` onto the classic ``(precision, trailing_precision)``
    argument pair.

    ``policy=None`` passes the classic arguments through untouched. With a
    policy, the classic knobs must keep their defaults — a call naming both
    spellings is ambiguous and raises rather than letting one win.
    """
    if policy is None:
        return precision, trailing_precision
    pol = resolve_policy(policy)
    if trailing_precision is not None:
        raise ValueError(
            "pass either policy= or trailing_precision=, not both "
            f"(policy resolves trailing to {pol.resolved_trailing()!r})"
        )
    if precision != default_precision:
        raise ValueError(
            "pass either policy= or precision=, not both "
            f"(policy sets the panel precision to {pol.panel!r})"
        )
    return pol.panel, pol.split_trailing()


def apply_policy_to_comms_arg(policy, comms):
    """Map ``policy`` onto the classic ``comms`` wire-format argument (a
    call naming both spellings raises). ``policy=None`` validates and
    passes ``comms`` through."""
    if policy is None:
        return resolve_comms(comms)
    pol = resolve_policy(policy)
    if comms is not None:
        raise ValueError(
            "pass either policy= or comms=, not both "
            f"(policy sets the wire format to {pol.comms!r})"
        )
    return pol.comms
