"""dhqr-lint for the port — static analysis enforcing the port's own
rules over ``dhqr_tpu_torch/``: the twin of ``dhqr_tpu/analysis/``.

The source passes are ported (ROADMAP item 18a):

* **Pass 1 (AST)** — :mod:`dhqr_tpu_torch.analysis.ast_rules` walks the
  source tree with rule classes DHQR001-DHQR010 in their torch form:
  private-torch and any jax/dhqr_tpu imports, contractions outside
  ``ops/gemm`` at a named precision, config/env and torch-switch mutation
  containment, host syncs in CUDA-graph-captured bodies, explicit
  ``group=`` on every collective, swallowed-exception bans, Cholesky
  containment, raw wall-clock reads, raw collectives outside the wire
  seam, and sharded dispatch outside the armor seam.
* **The concurrency pass (dhqr-warden)** —
  :mod:`dhqr_tpu_torch.analysis.concurrency_pass` checks the serving
  tier's lock discipline (DHQR601-DHQR604) against the port's committed
  ``lock_order.json``, and a lock-witness burst validates it by
  execution, on the card where the lanes capture CUDA graphs.
* **The API check** (DHQR201/DHQR202) — everything in
  ``dhqr_tpu_torch.__all__`` imports cleanly and stands in README.md's
  port API table.

The graph passes are ported too (ROADMAP item 18b), over an **op log**
(:mod:`dhqr_tpu_torch.analysis.oplog`: a ``TorchDispatchMode`` recording
what an entry point dispatches, the panel kernels recorded as launches)
in place of a jaxpr:

* **The jaxpr pass** — :mod:`~dhqr_tpu_torch.analysis.jaxpr_pass` runs
  every registered route per preset and checks DHQR101-104 (f64
  promotions, host syncs, foreign process groups, routes that raise).
* **The comms audit** — :mod:`~dhqr_tpu_torch.analysis.comms_pass` runs
  the mesh routes on P ranks and holds each collective census to its
  contract (``comms_contracts.json``) and the analytic budgets of
  :mod:`~dhqr_tpu_torch.analysis.cost_model` (DHQR301-305).
* **The smokes** — :mod:`~dhqr_tpu_torch.analysis.xray_smoke` (DHQR401)
  and :mod:`~dhqr_tpu_torch.analysis.pulse_smoke` (DHQR402, DHQR306).
* **The atlas** — :mod:`~dhqr_tpu_torch.analysis.atlas` (DHQR501-505),
  the route registry's drift audit.

Findings support inline suppressions
(``# dhqr: ignore[DHQR002] <reason>``, the JAX package's grammar) and a
committed baseline file, empty by policy (its ``graph_suppressions``
list holds the graph findings the eager engines make by design, each
with its reason); the CLI is ``python -m dhqr_tpu_torch.analysis check
[paths] [--json] [--baseline FILE]``, and a tier-1 test
(tests/test_torch_analysis.py) self-scans the port so a new violation
fails the suite.
"""

from dhqr_tpu_torch.analysis.findings import (
    Finding,
    load_baseline,
    prune_baseline,
    write_baseline,
)
from dhqr_tpu_torch.analysis.ast_rules import (
    AST_RULES,
    scan_paths,
    scan_source,
)

__all__ = [
    "Finding",
    "AST_RULES",
    "scan_paths",
    "scan_source",
    "load_baseline",
    "prune_baseline",
    "write_baseline",
]
