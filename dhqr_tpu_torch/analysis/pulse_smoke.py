"""The pulse runtime-comms smoke (DHQR402): a stub until ROADMAP item 18b.

The twin of ``dhqr_tpu/analysis/pulse_smoke.py``. Every public name raises
``NotPortedError`` naming the item (:mod:`._pending`).
"""

from dhqr_tpu_torch.analysis._pending import pending

run_pulse_smoke = pending("pulse_smoke", "run_pulse_smoke")
