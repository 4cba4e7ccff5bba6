"""Experiment layer (L5): the runner that drives the real trainer, and
the BASELINE presets."""

from trustworthy_dl_tpu_torch.experiments.runner import PRESETS, \
    ExperimentRunner, main, preset_config, run_threshold_sweep

__all__ = ["ExperimentRunner", "PRESETS", "main", "preset_config",
           "run_threshold_sweep"]
