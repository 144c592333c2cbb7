"""The comms-contract audit (DHQR301-DHQR305): a stub until ROADMAP item 18b.

The twin of ``dhqr_tpu/analysis/comms_pass.py``. Every public name raises
``NotPortedError`` naming the item (:mod:`._pending`).
"""

from dhqr_tpu_torch.analysis._pending import pending

collect_comms = pending("comms_pass", "collect_comms")
issue_order = pending("comms_pass", "issue_order")
overlap_distance = pending("comms_pass", "overlap_distance")
load_contracts = pending("comms_pass", "load_contracts")
check_comms = pending("comms_pass", "check_comms")
input_output_aliases = pending("comms_pass", "input_output_aliases")
check_donation = pending("comms_pass", "check_donation")
trace_engine = pending("comms_pass", "trace_engine")
run_comms_pass = pending("comms_pass", "run_comms_pass")
run_comms_pass_auto = pending("comms_pass", "run_comms_pass_auto")
