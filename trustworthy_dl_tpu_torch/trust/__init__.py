"""Trust state (``state``) and its host reporting view (``manager``).  The
names below resolve at first access (``_lazy``)."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "trust.state": ("METRIC_NAMES", "NodeStatus", "TRUST_WEIGHTS",
                    "TrustState", "adaptive_threshold", "can_assign_task",
                    "contribution_weights", "init_trust_state",
                    "initiate_recovery", "instantaneous_trust",
                    "mark_compromised", "next_status",
                    "predict_reliability", "select_best_nodes",
                    "system_trust", "update_trust"),
    "trust.manager": ("NodeMetrics", "TrustManager", "TrustScore"),
})
