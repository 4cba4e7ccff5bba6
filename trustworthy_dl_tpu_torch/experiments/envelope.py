"""Measured detection envelope: attack type x intensity sweep.

Counterpart of ``trustworthy_dl_tpu/experiments/envelope.py``.  Every
cell of the (attack type x intensity) matrix is a real trusted-training
run with deterministic fault injection, and the reported detection rate,
latency, false-positive rate and attribution accuracy come from ground
truth (the injection plan knows who was attacked when).

Cells share ONE trainer: ``DistributedTrainer.reset_for_run`` gives each
cell fresh device state and host bookkeeping on the same built steps.
The sweep runs on the card (``device="cuda"``) unless given
``device="cpu"``.

Outputs (under ``<output_dir>/``):
  - ``detection_envelope.json`` - the full matrix + clean-run floor
  - ``detection_envelope.png``  - detection-rate heatmap annotated with
    median latency (where matplotlib imports; a failed figure only logs)
  - ``detection_envelope.md``   - the README-ready table
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker, \
    AttackConfig
from trustworthy_dl_tpu_torch.attacks.adversarial import ATTACK_KINDS
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.utils.io import atomic_write_json, \
    atomic_write_text

logger = logging.getLogger(__name__)

INTENSITIES = (0.1, 0.25, 0.5, 1.0)

# The attribution ladder: acceptable labels for the FIRST incident of each
# injected family.  A byzantine gradient replacement legitimately presents
# as gradient corruption on its first confirmed step, so family-level
# accuracy is the headline and strict accuracy is reported alongside.
ATTRIBUTION_FAMILIES = {
    "gradient_poisoning": {"gradient_poisoning"},
    "byzantine": {"gradient_poisoning", "byzantine"},
    "data_poisoning": {"data_poisoning", "adversarial_input",
                       "gradient_poisoning"},
    "backdoor": {"backdoor", "data_poisoning", "adversarial_input",
                 "gradient_poisoning"},
}

TINY_GPT = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128,
                n_positions=32, seq_len=16)


def _run_cell(trainer: DistributedTrainer, dl_kwargs: Dict[str, Any], *,
              seed: int, attack_type: Optional[str], intensity: float,
              targets: Sequence[int], warmup_steps: int,
              attack_steps: int) -> Dict[str, Any]:
    """One measured cell: reset, run warmup+attack steps, read ground
    truth out of the trainer's incident records.  The loader is built
    fresh per cell, so every cell is reproducible on its own."""
    dl = get_dataloader(**dl_kwargs)
    trainer.reset_for_run(seed=seed)
    n = trainer.config.num_nodes
    if attack_type is not None:
        attacker = AdversarialAttacker(AttackConfig(
            attack_types=[attack_type], target_nodes=list(targets),
            intensity=intensity, start_step=warmup_steps,
        ))
        attacker.activate_attacks()
        trainer.set_attack_plan(attacker.plan(n))
    total = warmup_steps + attack_steps
    steps_per_epoch = max(len(dl), 1)
    for epoch in range((total + steps_per_epoch - 1) // steps_per_epoch):
        trainer.train_epoch(dl, epoch)
        if trainer.global_step >= total:
            break

    records = trainer.attack_history
    target_set = set(targets) if attack_type is not None else set()
    detected: Dict[int, Dict[str, Any]] = {}
    false_positives: List[Dict[str, Any]] = []
    pre_attack_target_incidents: List[Dict[str, Any]] = []
    for rec in records:
        slim = {"node_id": rec["node_id"], "step": rec["step"],
                "attack_type": rec["attack_type"]}
        if rec["node_id"] in target_set:
            if rec["step"] > warmup_steps:
                detected.setdefault(rec["node_id"], rec)  # first incident
            else:
                # A target flagged before its attack started: a false
                # alarm of another population than fp_rate's clean nodes.
                pre_attack_target_incidents.append(slim)
        else:
            false_positives.append(slim)
    # rec["step"] is counted after the step, so warmup + 1 is latency 1.
    latencies = sorted(rec["step"] - warmup_steps
                       for rec in detected.values())
    family = ATTRIBUTION_FAMILIES.get(attack_type or "", {attack_type})
    attributed = [rec for rec in detected.values()
                  if rec["attack_type"] in family]
    strict = [rec for rec in detected.values()
              if rec["attack_type"] == attack_type]
    losses = [m["loss"] for m in trainer.metrics_collector.batch_metrics]
    return {
        "attack_type": attack_type,
        "intensity": intensity if attack_type is not None else 0.0,
        "targets": sorted(target_set),
        "steps": trainer.global_step,
        "warmup_steps": warmup_steps,
        "detection_rate": (len(detected) / len(target_set)
                           if target_set else None),
        "detected_nodes": sorted(detected),
        "median_latency_steps": (float(np.median(latencies))
                                 if latencies else None),
        "latencies": latencies,
        "false_positive_incidents": false_positives,
        "pre_attack_target_incidents": pre_attack_target_incidents,
        # Node-steps a clean node could have been falsely flagged in.
        "fp_rate": len(false_positives)
        / max((n - len(target_set)) * trainer.global_step, 1),
        "attribution_accuracy": (len(attributed) / len(detected)
                                 if detected else None),
        "strict_attribution_accuracy": (len(strict) / len(detected)
                                        if detected else None),
        "attributed_types": sorted({rec["attack_type"]
                                    for rec in detected.values()}),
        "finite": bool(np.all(np.isfinite(losses))) if losses else False,
    }


def run_detection_envelope(
    output_dir: str = "experiments/detection_envelope",
    attack_types: Iterable[str] = ATTACK_KINDS,
    intensities: Iterable[float] = INTENSITIES,
    num_nodes: int = 8,
    targets: Optional[Tuple[int, ...]] = None,
    warmup_steps: int = 8,
    # Long enough for data poisoning, caught by loss detachment after tens
    # of steps: its latency beside gradient poisoning's is part of the
    # envelope.
    attack_steps: int = 40,
    seed: int = 0,
    model_overrides: Optional[Dict[str, Any]] = None,
    make_figure: bool = True,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Measure the detection envelope and write JSON + figure + table.
    JAX's arguments and defaults (a tiny GPT-2 in data mode; the real
    widths through ``model_overrides``) plus ``device``."""
    t0 = time.time()
    attack_types = list(attack_types)
    intensities = list(intensities)
    if targets is None:
        # 2 of n attacked (1 of n on tiny fleets): (1, 5) at n = 8.
        targets = (1, num_nodes // 2 + 1) if num_nodes >= 4 else (1,)
    if any(not 0 <= t < num_nodes for t in targets):
        raise ValueError(
            f"targets {targets} out of range for num_nodes={num_nodes}; "
            "a silently-dropped target would skew every published rate"
        )
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    overrides = dict(TINY_GPT, **(model_overrides or {}))

    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext",
        batch_size=2 * num_nodes, num_nodes=num_nodes, optimizer="adamw",
        learning_rate=3e-3, checkpoint_interval=10_000,
        detector_warmup=4, parallelism="data",
        # A static topology keeps detection firing, and measurable,
        # instead of evicting the node after the first hit.
        elastic_resharding=False,
    )
    trainer = DistributedTrainer(config, model_overrides=overrides,
                                 device=device)
    total = warmup_steps + attack_steps
    dl_kwargs = dict(
        dataset_name="openwebtext", batch_size=config.batch_size,
        seq_len=overrides.get("seq_len", 16),
        vocab_size=overrides.get("vocab_size", 128),
        num_examples=config.batch_size * total,
    )

    # Clean floor first: FP rate with no attack at all.
    logger.info("envelope: clean floor run")
    clean = _run_cell(trainer, dl_kwargs, seed=seed, attack_type=None,
                      intensity=0.0, targets=(), warmup_steps=warmup_steps,
                      attack_steps=attack_steps)

    cells: List[Dict[str, Any]] = []
    for attack_type in attack_types:
        for intensity in intensities:
            logger.info("envelope: %s @ %.2f", attack_type, intensity)
            cells.append(_run_cell(
                trainer, dl_kwargs, seed=seed, attack_type=attack_type,
                intensity=float(intensity), targets=targets,
                warmup_steps=warmup_steps, attack_steps=attack_steps,
            ))

    from trustworthy_dl_tpu_torch.obs.meta import run_metadata

    results = {
        "config": {
            "num_nodes": num_nodes, "targets": list(targets),
            "warmup_steps": warmup_steps, "attack_steps": attack_steps,
            "seed": seed, "model_overrides": overrides,
            "attack_types": attack_types,
            "intensities": [float(i) for i in intensities],
        },
        # The platform stamp: an envelope measured on the CPU must never
        # be mistaken for the card's.
        "run_metadata": run_metadata(),
        "clean": clean,
        "cells": cells,
        "wall_time_s": time.time() - t0,
    }
    atomic_write_json(out / "detection_envelope.json", results)
    atomic_write_text(out / "detection_envelope.md", render_table(results))
    if make_figure:
        try:
            _figure(results, out / "detection_envelope.png")
        except Exception:  # a missing matplotlib must not lose the data
            logger.exception("envelope figure failed")
    logger.info("envelope: %d cells in %.1fs -> %s",
                len(cells) + 1, results["wall_time_s"], out)
    return results


def render_table(results: Dict[str, Any]) -> str:
    """README-ready markdown: one row per attack type, one column per
    intensity, each cell 'rate / latency'."""
    intensities = results["config"]["intensities"]
    types = results["config"]["attack_types"]
    by_key = {(c["attack_type"], c["intensity"]): c
              for c in results["cells"]}
    lines = [
        "| attack \\ intensity | "
        + " | ".join(f"{i:g}" for i in intensities) + " |",
        "|---" * (len(intensities) + 1) + "|",
    ]
    for t in types:
        row = [t.replace("_", " ")]
        for i in intensities:
            c = by_key.get((t, float(i)))
            if c is None:
                row.append("—")
                continue
            rate = c["detection_rate"]
            lat = c["median_latency_steps"]
            row.append(f"{rate:.0%}" + (f" / {lat:.0f} st" if lat else ""))
        lines.append("| " + " | ".join(row) + " |")
    clean = results["clean"]
    lines.append("")
    lines.append(
        f"Clean-run false-positive rate: "
        f"{clean['fp_rate']:.4f} per node-step "
        f"({len(clean['false_positive_incidents'])} incidents over "
        f"{clean['steps']} steps × {results['config']['num_nodes']} nodes)."
    )
    return "\n".join(lines) + "\n"


def _figure(results: Dict[str, Any], path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    intensities = results["config"]["intensities"]
    types = results["config"]["attack_types"]
    by_key = {(c["attack_type"], c["intensity"]): c
              for c in results["cells"]}
    grid = np.full((len(types), len(intensities)), np.nan)
    for r, t in enumerate(types):
        for c, i in enumerate(intensities):
            cell = by_key.get((t, float(i)))
            if cell and cell["detection_rate"] is not None:
                grid[r, c] = cell["detection_rate"]

    fig, ax = plt.subplots(figsize=(7, 4.2))
    im = ax.imshow(grid, cmap="viridis", vmin=0.0, vmax=1.0, aspect="auto")
    ax.set_xticks(range(len(intensities)), [f"{i:g}" for i in intensities])
    ax.set_yticks(range(len(types)), [t.replace("_", " ") for t in types])
    ax.set_xlabel("attack intensity")
    ax.set_title("Measured detection rate (annotation: median "
                 "steps-to-detect)")
    for r in range(len(types)):
        for c in range(len(intensities)):
            cell = by_key.get((types[r], float(intensities[c])))
            if cell is None or cell["detection_rate"] is None:
                continue
            lat = cell["median_latency_steps"]
            txt = f"{cell['detection_rate']:.0%}"
            if lat is not None:
                txt += f"\n{lat:.0f} st"
            ax.text(c, r, txt, ha="center", va="center",
                    color="white" if grid[r, c] < 0.6 else "black",
                    fontsize=9)
    fig.colorbar(im, ax=ax, label="detection rate")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


__all__ = ["ATTRIBUTION_FAMILIES", "INTENSITIES", "TINY_GPT",
           "render_table", "run_detection_envelope"]
