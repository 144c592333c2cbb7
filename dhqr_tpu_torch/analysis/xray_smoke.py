"""The xray introspection smoke (DHQR401): a stub until ROADMAP item 18b.

The twin of ``dhqr_tpu/analysis/xray_smoke.py``. Every public name raises
``NotPortedError`` naming the item (:mod:`._pending`).
"""

from dhqr_tpu_torch.analysis._pending import pending

run_xray_smoke = pending("xray_smoke", "run_xray_smoke")
