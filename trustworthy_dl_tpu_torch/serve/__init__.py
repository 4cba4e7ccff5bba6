"""Continuous-batching serving with trust-aware output monitoring, over
the paged KV pool (default) or the legacy stripe pool, with live migration
between engines (``migrate``), a fleet of engine replicas behind one
``submit()`` (``fleet``) and the fleet's control plane (``control``: SLO
classes, token buckets, the autoscaler)."""

from trustworthy_dl_tpu_torch.serve.control import (DEFAULT_SLO_CLASSES,
                                                    AutoscalerConfig,
                                                    PredictiveArmConfig,
                                                    SLOClass,
                                                    TenantQuotaConfig)
from trustworthy_dl_tpu_torch.serve.engine import (OutputMonitor,
                                                   ServeRequest, ServeResult,
                                                   ServingEngine)
from trustworthy_dl_tpu_torch.serve.fleet import (FleetConfig, FleetResult,
                                                  ReplicaState, ServingFleet,
                                                  backoff_ticks)
from trustworthy_dl_tpu_torch.serve.migrate import can_migrate, \
    migrate_request

__all__ = ["AutoscalerConfig", "DEFAULT_SLO_CLASSES", "FleetConfig",
           "FleetResult", "OutputMonitor", "PredictiveArmConfig",
           "ReplicaState", "SLOClass", "ServeRequest", "ServeResult",
           "ServingEngine", "ServingFleet", "TenantQuotaConfig",
           "backoff_ticks", "can_migrate", "migrate_request"]
