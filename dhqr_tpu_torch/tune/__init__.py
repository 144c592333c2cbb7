"""The tuner of the port: for now only :func:`~dhqr_tpu_torch.tune.db.
policy_tag`, which the guarded ladder's attempt records spell policies
with. ``Plan``, ``PlanDB``, ``resolve_plan`` and the ``plan=`` knob wait
for ROADMAP Queue A item 14."""

from dhqr_tpu_torch.tune.db import policy_tag

__all__ = ["policy_tag"]
