"""dhqr_tpu_torch — the PyTorch/CUDA port of ``dhqr_tpu`` for NVIDIA Hopper.

Same packed Householder storage as the JAX package (reflectors with
||v||^2 = 2 below the diagonal, R's strict upper triangle in ``H``, R's
diagonal in ``alpha``), same public names. GEMMs and triangular solves go
to PyTorch (cuBLAS on the card; the lower precision names as bf16 passes,
``ops/gemm.py``); the fused panel factorization — a Pallas kernel in the
JAX package — is a CUDA C++ kernel written for ``sm_90a``
(``csrc/panel_qr.cu``), built with nvcc at first use.

    >>> fact = dhqr_tpu_torch.qr(A)          # on the CUDA card by default
    >>> x = fact.solve(b)
    >>> x = dhqr_tpu_torch.lstsq(A, b)       # differentiable (autograd)
    >>> x = dhqr_tpu_torch.lstsq(A, b, engine="tsqr")
    >>> x = dhqr_tpu_torch.lstsq(A, b, policy="balanced")
    >>> x = dhqr_tpu_torch.lstsq(A, b, engine="sketch")  # tall: m >> n
    >>> fact = dhqr_tpu_torch.qr(A, lookahead=True)      # two CUDA streams
    >>> x = dhqr_tpu_torch.lstsq(A, b, device="cpu")   # plain PyTorch path
    >>> fact = dhqr_tpu_torch.qr(A, mesh=parallel.column_mesh())  # per rank
    >>> x = dhqr_tpu_torch.lstsq(A, b, mesh=mesh, comms="bf16")  # wire
    >>> mesh, tier = dhqr_tpu_torch.pod_mesh(topo="2x2")  # hosts x ranks
    >>> x = dhqr_tpu_torch.lstsq(A, b, guards="full")  # screen, ladder, gate
    >>> res = dhqr_tpu_torch.guarded_lstsq(A, b, engine="cholqr2")
    >>> live = dhqr_tpu_torch.UpdatableQR(A); live.update(u, v)
    >>> xs = dhqr_tpu_torch.batched_lstsq(As, bs)  # buckets, CUDA graphs
    >>> fut = dhqr_tpu_torch.AsyncScheduler().submit("lstsq", A, b)
    >>> fut = dhqr_tpu_torch.Router(replicas=3).submit("lstsq", A, b)
    >>> x = dhqr_tpu_torch.lstsq(A, b, plan="auto")  # tuned, DB-backed
    >>> with dhqr_tpu_torch.armor.armored():          # ABFT on the mesh
    ...     fact = dhqr_tpu_torch.qr(A, mesh=mesh)

The distributed tier is :mod:`dhqr_tpu_torch.parallel` (one process per
rank over a ``torch.distributed`` process group); the serving tier (the
batched entry points, the async scheduler, the fleet router and the key
store) is :mod:`dhqr_tpu_torch.serve`; the tuner is
:mod:`dhqr_tpu_torch.tune` and the mesh tier's verification seam
:mod:`dhqr_tpu_torch.armor`. This package imports neither ``jax`` nor
``dhqr_tpu``.
"""

from dhqr_tpu_torch.models.qr_model import (
    QRFactorization,
    lstsq,
    qr,
    qr_explicit,
    solve,
)
from dhqr_tpu_torch.numeric.errors import (
    Breakdown,
    IllConditioned,
    NonFiniteInput,
    NumericalError,
    ResidualGateFailed,
)
from dhqr_tpu_torch.numeric.ladder import guarded_lstsq, guarded_qr
from dhqr_tpu_torch.armor.errors import CorruptionDetected, ShardFailure
from dhqr_tpu_torch import parallel
from dhqr_tpu_torch.obs.metrics import MetricsRegistry
from dhqr_tpu_torch.obs.pulse import PulseReport
from dhqr_tpu_torch.obs.xray import XrayReport
from dhqr_tpu_torch.parallel.mesh import pod_mesh
from dhqr_tpu_torch.parallel.multihost import global_pod_mesh
from dhqr_tpu_torch.parallel.topology import TierAxes
from dhqr_tpu_torch.ops.blocked import blocked_householder_qr
from dhqr_tpu_torch.ops.cholqr import cholesky_qr2, cholesky_qr_lstsq
from dhqr_tpu_torch.ops.differentiable import lstsq_diff
from dhqr_tpu_torch.ops.householder import alphafactor, householder_qr
from dhqr_tpu_torch.ops.solve import (
    apply_q,
    apply_qt,
    back_substitute,
    solve_least_squares,
)
from dhqr_tpu_torch.ops.tsqr import tsqr_lstsq, tsqr_r
from dhqr_tpu_torch.precision import (
    POLICY_LADDER,
    PRECISION_POLICIES,
    PrecisionPolicy,
    resolve_policy,
)
from dhqr_tpu_torch.serve import (
    AsyncScheduler,
    BackpressureError,
    CompileFailed,
    DeadlineExceeded,
    DispatchFailed,
    ExecutableStore,
    Quarantined,
    ReplicaLost,
    Router,
    ServeError,
    batched_lstsq,
    batched_qr,
    batched_sketched_lstsq,
)
from dhqr_tpu_torch.solvers.sketch import sketched_lstsq
from dhqr_tpu_torch.tune import Plan, PlanDB, resolve_plan
from dhqr_tpu_torch.solvers.update import UpdatableQR
from dhqr_tpu_torch.utils.config import (
    ArmorConfig,
    DHQRConfig,
    FaultConfig,
    FleetConfig,
    NotPortedError,
    ObsConfig,
    SchedulerConfig,
    ServeConfig,
    SketchConfig,
    TuneConfig,
)

__version__ = "0.1.0"

__all__ = [
    "ArmorConfig",
    "AsyncScheduler",
    "BackpressureError",
    "Breakdown",
    "CompileFailed",
    "CorruptionDetected",
    "DHQRConfig",
    "DeadlineExceeded",
    "DispatchFailed",
    "ExecutableStore",
    "FaultConfig",
    "FleetConfig",
    "IllConditioned",
    "MetricsRegistry",
    "NonFiniteInput",
    "NotPortedError",
    "NumericalError",
    "ObsConfig",
    "POLICY_LADDER",
    "PRECISION_POLICIES",
    "Plan",
    "PlanDB",
    "PrecisionPolicy",
    "PulseReport",
    "QRFactorization",
    "Quarantined",
    "ReplicaLost",
    "ResidualGateFailed",
    "Router",
    "SchedulerConfig",
    "ServeConfig",
    "ServeError",
    "ShardFailure",
    "SketchConfig",
    "TierAxes",
    "TuneConfig",
    "UpdatableQR",
    "XrayReport",
    "alphafactor",
    "apply_q",
    "apply_qt",
    "back_substitute",
    "batched_lstsq",
    "batched_qr",
    "batched_sketched_lstsq",
    "blocked_householder_qr",
    "cholesky_qr2",
    "cholesky_qr_lstsq",
    "global_pod_mesh",
    "guarded_lstsq",
    "guarded_qr",
    "householder_qr",
    "lstsq",
    "lstsq_diff",
    "pod_mesh",
    "qr",
    "qr_explicit",
    "resolve_plan",
    "resolve_policy",
    "solve",
    "solve_least_squares",
    "sketched_lstsq",
    "tsqr_lstsq",
    "tsqr_r",
    "__version__",
]
