"""Configuration (``config``), the mesh over the card's positions
(``mesh``) and the sharding registry (``sharding``).  The names below
resolve at first access (``_lazy``)."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "core.config": ("AttackConfig", "ExperimentConfig", "NodeConfig",
                    "TrainingConfig", "load_config"),
    "core.mesh": ("DATA_AXIS", "MODEL_AXIS", "SEQ_AXIS", "STAGE_AXIS",
                  "build_hybrid_mesh", "build_mesh", "node_axis_for"),
})
