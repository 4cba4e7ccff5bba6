"""Chaos: seeded, deterministic fault injection for the training loop and
its checkpoints (``plan``, ``injector``), drilled end to end by
``engine/supervisor.py``."""

from trustworthy_dl_tpu_torch.chaos.injector import FaultInjector, \
    SimulatedPreemption, corrupt_file
from trustworthy_dl_tpu_torch.chaos.plan import FLEET_KINDS, FaultEvent, \
    FaultKind, FaultPlan

__all__ = ["FLEET_KINDS", "FaultEvent", "FaultInjector", "FaultKind",
           "FaultPlan", "SimulatedPreemption", "corrupt_file"]
