"""The armor seam of the port: for now only its typed errors
(:mod:`dhqr_tpu_torch.armor.errors`). ``ArmorConfig``, the ABFT checks and
the recovery ladder wait for ROADMAP Queue A item 15."""

from dhqr_tpu_torch.armor.errors import (
    ArmorError,
    CorruptionDetected,
    ShardFailure,
)

__all__ = ["ArmorError", "CorruptionDetected", "ShardFailure"]
