"""Continuous-batching serving with trust-aware output monitoring, over
the paged KV pool (default) or the legacy stripe pool, with live migration
between engines (``migrate``), a fleet of engine replicas behind one
``submit()`` (``fleet``) and the fleet's control plane (``control``: SLO
classes, token buckets, the autoscaler).  The names below resolve at first
access (``_lazy``), so ``serve.control`` and ``core.config`` import none
of the engine's modules through this package."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "core.config": ("ServeConfig",),
    "serve.control": ("DEFAULT_SLO_CLASSES", "AutoscalerConfig",
                      "PredictiveArmConfig", "SLOClass",
                      "TenantQuotaConfig"),
    "serve.engine": ("OutputMonitor", "ServeRequest", "ServeResult",
                     "ServingEngine"),
    "serve.fleet": ("FleetConfig", "FleetResult", "ReplicaState",
                    "ServingFleet", "backoff_ticks"),
    "serve.kv_slots": ("BlockAllocator", "PagedKV", "PrefixCache",
                       "SlotAllocator", "SlotKV", "init_paged_pool",
                       "init_slots", "kv_bytes_per_slot",
                       "kv_bytes_per_token", "paged_pool_blocks"),
    "serve.migrate": ("can_migrate", "migrate_request"),
    "serve.scheduler": ("ContinuousBatchingScheduler",
                        "PagedBatchingScheduler", "choose_bucket",
                        "default_buckets"),
    "serve.workload": ("Tenant", "WorkloadConfig", "WorkloadItem",
                       "drive_closed_loop", "generate_workload",
                       "replay_workload"),
})
