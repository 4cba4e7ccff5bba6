"""PyTorch/CUDA port of ``trustworthy_dl_tpu`` for NVIDIA Hopper.

The port mirrors the JAX package's module paths and public names.  It
imports ``torch`` and numpy only, never ``jax`` nor ``trustworthy_dl_tpu``.
Its entry points (``DistributedTrainer``, ``ServingEngine``,
``ExperimentRunner``, the ``cli`` commands and the
``trustworthy-dl-torch-*`` console scripts) run on the card by default and
take ``device="cpu"`` (``--device cpu``) only when the caller asks for it;
on the CPU each kernel wrapper runs its plain PyTorch version.

Every Pallas kernel of the JAX package has a hand-written Hopper kernel
here (``ops/``), and every JAX module its counterpart.  The names the port
deliberately does not serve (TPU tile geometry, XLA program analysis,
``NamedSharding`` helpers, threefry streams) are listed in ROADMAP.md,
Queue C, and pinned by ``tests/test_torch_surface.py``.

The package exports JAX's 37 top-level names lazily: ``import
trustworthy_dl_tpu_torch`` loads no torch until a name is used.
"""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__version__ = "0.2.0"

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "core.config": ("AttackConfig", "ExperimentConfig", "NodeConfig",
                    "ServeConfig", "TrainingConfig", "load_config"),
    "trust.manager": ("TrustManager",),
    "trust.state": ("NodeStatus", "TrustState"),
    "detect.detector": ("AttackDetector", "AttackType",
                        "AttackDetectionResult"),
    "detect.verifier": ("GradientVerifier",),
    "engine.trainer": ("DistributedTrainer", "TrainingState"),
    "models.factory": ("ModelFactory",),
    "data.loader": ("get_dataloader",),
    "utils.metrics": ("MetricsCollector",),
    "utils.monitor": ("NodeMonitor",),
    "attacks.adversarial": ("AdversarialAttacker",),
    "chaos.injector": ("FaultInjector", "SimulatedPreemption"),
    "chaos.plan": ("FaultKind", "FaultPlan"),
    "engine.supervisor": ("TrainingSupervisor",),
    "experiments.runner": ("ExperimentRunner",),
    "obs.session": ("ObsSession",),
    "obs.registry": ("MetricsRegistry",),
    "obs.events": ("TraceBus", "EventType"),
    "obs.recorder": ("FlightRecorder",),
    "obs.report": ("StepTimeReporter",),
    "obs.meta": ("run_metadata",),
    "models.generate": ("generate",),
    "serve.engine": ("ServingEngine", "ServeRequest", "ServeResult"),
})
