"""Continuous-batching serving with trust-aware output monitoring, over
the paged KV pool (default) or the legacy stripe pool, with live migration
between engines (``migrate``) and a fleet of engine replicas behind one
``submit()`` (``fleet``)."""

from trustworthy_dl_tpu_torch.serve.engine import (OutputMonitor,
                                                   ServeRequest, ServeResult,
                                                   ServingEngine)
from trustworthy_dl_tpu_torch.serve.fleet import (FleetConfig, FleetResult,
                                                  ReplicaState, ServingFleet,
                                                  backoff_ticks)
from trustworthy_dl_tpu_torch.serve.migrate import can_migrate, \
    migrate_request

__all__ = ["FleetConfig", "FleetResult", "OutputMonitor", "ReplicaState",
           "ServeRequest", "ServeResult", "ServingEngine", "ServingFleet",
           "backoff_ticks", "can_migrate", "migrate_request"]
