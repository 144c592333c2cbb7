"""The comms audit's analytic budgets: a stub until ROADMAP item 18b.

The twin of ``dhqr_tpu/analysis/cost_model.py``. Every public name raises
``NotPortedError`` naming the item (:mod:`._pending`).
"""

from dhqr_tpu_torch.analysis._pending import pending

unblocked_qr_words = pending("cost_model", "unblocked_qr_words")
blocked_qr_words = pending("cost_model", "blocked_qr_words")
sharded_solve_words = pending("cost_model", "sharded_solve_words")
tsqr_lstsq_words = pending("cost_model", "tsqr_lstsq_words")
cholqr_lstsq_words = pending("cost_model", "cholqr_lstsq_words")
no_comms_words = pending("cost_model", "no_comms_words")
tsqr_lstsq_wire_words = pending("cost_model", "tsqr_lstsq_wire_words")
cholqr_lstsq_wire_words = pending("cost_model", "cholqr_lstsq_wire_words")
budget_bytes = pending("cost_model", "budget_bytes")
payload_schedule = pending("cost_model", "payload_schedule")
tiered_budget_bytes = pending("cost_model", "tiered_budget_bytes")
