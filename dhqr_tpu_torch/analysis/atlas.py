"""The route-registry drift audit (DHQR501-DHQR505): a stub until ROADMAP item 18b.

The twin of ``dhqr_tpu/analysis/atlas.py``. Every public name raises
``NotPortedError`` naming the item (:mod:`._pending`).
"""

from dhqr_tpu_torch.analysis._pending import pending

registry_findings = pending("atlas", "registry_findings")
expected_jaxpr_labels = pending("atlas", "expected_jaxpr_labels")
check_route_coverage = pending("atlas", "check_route_coverage")
check_contract_pricing = pending("atlas", "check_contract_pricing")
check_cache_keys = pending("atlas", "check_cache_keys")
check_donation_routes = pending("atlas", "check_donation_routes")
check_grid_drift = pending("atlas", "check_grid_drift")
run_atlas_pass = pending("atlas", "run_atlas_pass")
