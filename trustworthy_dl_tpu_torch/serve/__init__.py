"""Paged continuous-batching serving with trust-aware output monitoring."""

from trustworthy_dl_tpu_torch.serve.engine import (OutputMonitor,
                                                   ServeRequest, ServeResult,
                                                   ServingEngine)

__all__ = ["OutputMonitor", "ServeRequest", "ServeResult", "ServingEngine"]
