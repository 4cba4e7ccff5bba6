"""Chaos: seeded, deterministic fault injection for the training loop, its
checkpoints and the serving fleet (``plan``, ``injector``), drilled end to
end by ``engine/supervisor.py``, and the fleet's adaptive attacker
(``adversary``)."""

from trustworthy_dl_tpu_torch.chaos.adversary import (
    AdaptivePoisonAttacker, AdversaryConfig, MarginSignatureMonitor,
    predict_attacker_trajectory)
from trustworthy_dl_tpu_torch.chaos.injector import FaultInjector, \
    SimulatedPreemption, corrupt_file
from trustworthy_dl_tpu_torch.chaos.plan import FLEET_KINDS, FaultEvent, \
    FaultKind, FaultPlan

__all__ = ["FLEET_KINDS", "AdaptivePoisonAttacker", "AdversaryConfig",
           "FaultEvent", "FaultInjector", "FaultKind", "FaultPlan",
           "MarginSignatureMonitor", "SimulatedPreemption", "corrupt_file",
           "predict_attacker_trajectory"]
