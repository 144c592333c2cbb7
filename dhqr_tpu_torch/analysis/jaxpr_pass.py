"""The jaxpr sanitizer (DHQR101-DHQR104): a stub until ROADMAP item 18b.

The twin of ``dhqr_tpu/analysis/jaxpr_pass.py``. Every public name raises
``NotPortedError`` naming the item (:mod:`._pending`).
"""

from dhqr_tpu_torch.analysis._pending import by_design, pending

sub_jaxprs = pending("jaxpr_pass", "sub_jaxprs")
iter_jaxprs = pending("jaxpr_pass", "iter_jaxprs")
check_jaxpr = pending("jaxpr_pass", "check_jaxpr")
run_jaxpr_pass = pending("jaxpr_pass", "run_jaxpr_pass")

#: JAX's process-wide CPU pin before a trace; the port picks its device
#: per call (ROADMAP "Not ported by design").
_ensure_cpu_backend = by_design(
    "jaxpr_pass", "_ensure_cpu_backend",
    "it pins JAX's process-wide platform to the CPU before a trace; "
    "the port picks its device per call")
