"""Continuous-batching serving with trust-aware output monitoring, over
the paged KV pool (default) or the legacy stripe pool, with live migration
between engines (``migrate``)."""

from trustworthy_dl_tpu_torch.serve.engine import (OutputMonitor,
                                                   ServeRequest, ServeResult,
                                                   ServingEngine)
from trustworthy_dl_tpu_torch.serve.migrate import can_migrate, \
    migrate_request

__all__ = ["OutputMonitor", "ServeRequest", "ServeResult", "ServingEngine",
           "can_migrate", "migrate_request"]
