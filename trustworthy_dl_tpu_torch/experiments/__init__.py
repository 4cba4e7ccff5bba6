"""Experiment layer (L5): the runner that drives the real trainer, the
BASELINE presets and the measured detection envelope."""

from trustworthy_dl_tpu_torch.experiments.envelope import render_table, \
    run_detection_envelope
from trustworthy_dl_tpu_torch.experiments.runner import PRESETS, \
    ExperimentRunner, main, preset_config, run_threshold_sweep

__all__ = ["ExperimentRunner", "PRESETS", "main", "preset_config",
           "render_table", "run_detection_envelope", "run_threshold_sweep"]
