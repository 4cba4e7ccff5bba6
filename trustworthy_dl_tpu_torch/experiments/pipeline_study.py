"""Pipeline schedule study: GPipe step time and memory against the
microbatch count.

Counterpart of ``trustworthy_dl_tpu/experiments/pipeline_study.py``: the
whole trusted pipeline step (detection, canary, trust gating) at a fixed
global batch, one cell per (S, M), each through ``DistributedTrainer``
with ``parallelism="model"`` and ``n_layer = S`` (one layer a stage).
A cell times ``steps`` steps of one batch after a warm-up step and
reports the step time, GPipe's bubble fraction and ``temp_bytes``.

``temp_bytes`` is XLA's temporary allocation of the compiled step in
JAX; here it is the step's peak device allocation above the state it
starts from (``torch.cuda.max_memory_allocated`` after a reset, less the
memory allocated before the step), and 0 on the CPU, as JAX reports 0 on
a backend without ``memory_analysis``.

Outputs (under ``<output_dir>/``): ``pipeline_schedule_study.json`` and
``pipeline_schedule_study.md``.  ``python -m
trustworthy_dl_tpu_torch.experiments.pipeline_study`` runs the default
grid on the card.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from trustworthy_dl_tpu_torch.utils.io import atomic_write_json, \
    atomic_write_text

logger = logging.getLogger(__name__)

TINY = dict(n_embd=64, n_head=4, vocab_size=256, n_positions=64,
            seq_len=32)


def _measure_cell(num_stages: int, num_microbatches: int, batch: int,
                  steps: int, model_overrides: Dict[str, Any],
                  device: Any) -> Dict[str, Any]:
    import torch

    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.parallel.pipeline import bubble_fraction

    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext", batch_size=batch,
        num_nodes=num_stages, optimizer="adamw", learning_rate=1e-3,
        checkpoint_interval=10 ** 9, detector_warmup=10 ** 6,
        parallelism="model", num_microbatches=num_microbatches)
    overrides = dict(TINY, n_layer=num_stages, **model_overrides)
    trainer = DistributedTrainer(config, model_overrides=overrides,
                                 device=device)
    dl = get_dataloader("openwebtext", batch_size=batch,
                        seq_len=overrides["seq_len"],
                        vocab_size=overrides["vocab_size"],
                        num_examples=batch)
    trainer.initialize()
    [first] = list(dl)
    nb = trainer._node_batch(first)
    cuda = trainer.device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(trainer.device)

    state, plan, step = trainer.state, trainer.attack_plan, \
        trainer._train_step
    sync()
    if cuda:
        before = torch.cuda.memory_allocated(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
    state, metrics = step(state, nb, plan)       # warm-up
    sync()
    temp_bytes = (torch.cuda.max_memory_allocated(trainer.device) - before
                  if cuda else 0)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, nb, plan)
    sync()
    dt = (time.perf_counter() - t0) / steps
    assert np.isfinite(float(metrics.loss))
    return {
        "num_stages": num_stages,
        "num_microbatches": num_microbatches,
        "batch": batch,
        "step_time_s": dt,
        "bubble_fraction": bubble_fraction(num_stages, num_microbatches),
        "temp_bytes": int(temp_bytes),
    }


def run_pipeline_study(
    output_dir: str = "experiments/pipeline_schedule_study",
    stage_counts: Iterable[int] = (4, 8),
    microbatches: Iterable[int] = (2, 4, 8, 16, 32),
    batch: int = 64,
    steps: int = 5,
    model_overrides: Optional[Dict[str, Any]] = None,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Every (S, M) cell of the grid whose M divides ``batch``; writes the
    JSON and the Markdown table and returns the results."""
    from trustworthy_dl_tpu_torch.obs.meta import run_metadata

    t0 = time.time()
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    stage_counts, microbatches = list(stage_counts), list(microbatches)
    cells: List[Dict[str, Any]] = []
    for s in stage_counts:
        for m in microbatches:
            if batch % m:
                continue
            logger.info("study: S=%d M=%d", s, m)
            cells.append(_measure_cell(s, m, batch, steps,
                                       model_overrides or {}, device))
    results = {
        "config": {"batch": batch, "steps": steps,
                   "stage_counts": stage_counts,
                   "microbatches": microbatches,
                   "model": dict(TINY)},
        # Schedule timings mean nothing without the hardware.
        "run_metadata": run_metadata(),
        "cells": cells,
        "wall_time_s": time.time() - t0,
    }
    atomic_write_json(out / "pipeline_schedule_study.json", results)
    atomic_write_text(out / "pipeline_schedule_study.md",
                      render_study(results))
    return results


def render_study(results: Dict[str, Any]) -> str:
    lines = ["| S | M | bubble | step time | vs M=2 | temp MiB |",
             "|---|---|---|---|---|---|"]
    base: Dict[int, float] = {}
    for c in results["cells"]:
        if c["num_microbatches"] == 2:
            base[c["num_stages"]] = c["step_time_s"]
        rel = base.get(c["num_stages"])
        speed = (f"{rel / c['step_time_s']:.2f}x" if rel else "—")
        lines.append(
            f"| {c['num_stages']} | {c['num_microbatches']} "
            f"| {c['bubble_fraction']:.0%} | {c['step_time_s'] * 1e3:.0f} ms "
            f"| {speed} | {c['temp_bytes'] / 2**20:.0f} |")
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    print(json.dumps(run_pipeline_study()["cells"], indent=2))
