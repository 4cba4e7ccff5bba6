"""The trusted training step (``step``), its state (``state``), optimizers
(``optimizer``), the host loop (``trainer``) and its asynchronous pipeline
(``async_host``), verified checkpoints (``checkpoint``) and the
self-healing supervisor (``supervisor``).  The names below resolve at
first access (``_lazy``)."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "engine.async_host": ("AsyncHostPipeline",),
    "engine.checkpoint": ("CheckpointManager",),
    "engine.optimizer": ("build_optimizer",),
    "engine.state": ("MonitorState", "TrainState", "init_monitor_state",
                     "init_train_state", "update_monitor"),
    "engine.step": ("HostMetricsPacker", "StepMetrics", "build_eval_step",
                    "build_train_step"),
    "engine.supervisor": ("PreemptionSignal", "TrainingSupervisor"),
    "engine.trainer": ("DistributedTrainer", "TrainingState"),
})
