"""Host-side helpers.  The names below resolve at first access
(``_lazy``), so the host-only modules here (``compile_cache``, ``io``)
import no torch through this package."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "utils.metrics": ("MetricsCollector",),
    "utils.monitor": ("NodeMonitor",),
})
