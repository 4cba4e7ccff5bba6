"""Serve-side detection envelope: attacker strength x monitor threshold x
vote K, measured against a real ``ServingFleet``.

Counterpart of ``trustworthy_dl_tpu/experiments/serve_envelope.py``.  Every
cell runs identical seeded traffic through a fleet with one adaptively
poisoned replica at a fixed corruption strength (``chaos.adversary`` with
its controller pinned) and records which tier caught it:

* ``ladder`` -- the monitor's flag rate crossed ``flag_rate_quarantine``,
  or every slot was quarantined;
* ``vote`` -- the flag rate stayed below it but cross-replica verdict
  voting outvoted the corrupted streams (``FleetConfig.vote_k``);
* ``none`` -- undetected: too weak to flag at this threshold and voting
  off (or never triggered: with no flags there is no suspicion and nothing
  to audit).

The sweep runs on the card (``device="cuda"``) unless given
``device="cpu"``; ``dtype`` is the model's compute dtype (JAX's f32 by
default).  The fleet takes ``seed + 1`` as its seed where JAX takes
``PRNGKey(seed + 1)``: every envelope request is greedy, so the cells do
not depend on it.

Outputs (under ``<output_dir>/``):
  - ``serve_envelope.json`` - the full matrix + per-cell counters
  - ``serve_envelope.md``   - the README-ready table (one block per vote K)
  - ``serve_envelope.png``  - the detection heatmap, one panel per vote K
    (where matplotlib imports; a failed figure only logs)
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from trustworthy_dl_tpu_torch.utils.io import atomic_write_json, \
    atomic_write_text

logger = logging.getLogger(__name__)

STRENGTHS = (0.15, 0.45, 0.9)
THRESHOLDS = (12.0, 24.0)
VOTE_KS = (0, 2)

#: JAX's tiny default geometry.
TINY_GPT = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=131,
                n_positions=64)


class _RecordingTrace:
    """Host-only trace sink: keeps the typed events the cell classifier
    reads (replica transitions, suspicion, votes)."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, type: Any, **data: Any) -> None:
        self.events.append({"type": getattr(type, "value", str(type)),
                            **data})


def _init_params(cfg: Any, seed: int, device: Any) -> Any:
    """The sweep's random weights, drawn on ``device`` from ``seed``."""
    import torch

    from trustworthy_dl_tpu_torch.models import gpt2

    generator = torch.Generator(device=device).manual_seed(seed)
    return gpt2.init_params(cfg, generator, device=device)


def _run_cell(params: Any, cfg: Any, *, seed: int, strength: float,
              threshold: float, vote_k: int, num_replicas: int,
              num_requests: int, max_slots: int, max_seq: int,
              fleet_overrides: Optional[Dict[str, Any]],
              adversary_overrides: Optional[Dict[str, Any]],
              device: Any) -> Dict[str, Any]:
    """One measured cell: a fresh fleet, one adaptively poisoned replica
    at fixed ``strength``, the monitor at ``threshold``, voting at
    ``vote_k``; identical seeded traffic across every cell."""
    from trustworthy_dl_tpu_torch.chaos import (AdaptivePoisonAttacker,
                                                AdversaryConfig, FaultEvent,
                                                FaultInjector, FaultKind,
                                                FaultPlan,
                                                MarginSignatureMonitor)
    from trustworthy_dl_tpu_torch.serve import (FleetConfig, ServeRequest,
                                                ServingFleet)

    target = num_replicas - 1
    adv_kwargs: Dict[str, Any] = dict(
        target=target, seed=seed,
        # Fixed strength (min == max == initial): the cell measures the
        # boundary at this strength; the per-request jitter makes the flag
        # probability vary smoothly with it.
        initial_strength=strength, min_strength=strength,
        max_strength=strength, step_up=0.0, backoff=1.0,
        signal_jitter=0.5, vocab_size=cfg.vocab_size)
    adv_kwargs.update(adversary_overrides or {})
    adversary = AdaptivePoisonAttacker(AdversaryConfig(**adv_kwargs))
    plan = FaultPlan.scripted([FaultEvent(
        step=1, kind=FaultKind.REPLICA_ADAPTIVE_POISON, target=target)],
        seed=seed)
    injector = FaultInjector(plan, adversary=adversary)
    trace = _RecordingTrace()
    fleet_kwargs: Dict[str, Any] = dict(
        num_replicas=num_replicas,
        # flag_min_count 4: the ladder needs sustained evidence, so a
        # mid-strength attacker's early rates cannot trip it before the
        # sub-threshold regime appears; suspicion still opens at 2 flags.
        flag_window=16, flag_min_count=4, flag_rate_quarantine=0.5,
        suspicion_threshold=0.08, suspicion_min_flags=2,
        vote_k=vote_k, vote_outvote_limit=2, max_retries=6,
        # Past the run: the envelope measures first detection, not the
        # readmission churn of an unhealed replica.
        quarantine_cooloff_ticks=10 ** 6)
    fleet_kwargs.update(fleet_overrides or {})
    fleet = ServingFleet(
        params, cfg, fleet_config=FleetConfig(**fleet_kwargs),
        chaos=injector, trace=trace, seed=seed + 1, device=device,
        max_slots=max_slots, max_seq=max_seq, queue_limit=num_requests,
        monitor=MarginSignatureMonitor(threshold))
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for _ in range(num_requests):
        plen = int(rng.integers(3, max(max_seq // 4, 4)))
        new = int(rng.integers(4, max(max_seq // 4, 5)))
        prompt = rng.integers(0, cfg.vocab_size, plen).tolist()
        fleet.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
    results = fleet.run_until_idle(max_ticks=20_000)

    quarantine_reasons = [
        (e.get("replica"), e.get("reason")) for e in trace.events
        if e["type"] == "replica_transition"
        and e.get("to_state") == "quarantined"]
    target_reasons = {r for rep, r in quarantine_reasons if rep == target}
    # "ladder" groups the two flag-driven tiers (the window's rate and
    # slot exhaustion); "vote" is the disagreement tier.
    if target_reasons & {"monitor_flag_rate", "slot_quarantine_exhausted"}:
        detected_by = "ladder"
    elif "verdict_outvoted" in target_reasons:
        detected_by = "vote"
    else:
        detected_by = "none"
    return {
        "strength": strength,
        "threshold": threshold,
        "vote_k": vote_k,
        "detected_by": detected_by,
        "clean_replica_quarantines": sum(
            1 for rep, _ in quarantine_reasons if rep != target),
        "corrupted_served": sum(
            1 for r in results.values()
            if r.status == "completed" and r.replica == target),
        "completed": sum(1 for r in results.values()
                         if r.status == "completed"),
        "requests": num_requests,
        "target_flag_rate": round(fleet.replicas[target].flag_rate, 4),
        "target_suspicion": round(fleet.replicas[target].suspicion, 4),
        "suspicions": fleet.counters["suspicions"],
        "votes": fleet.counters["votes"],
        "outvotes": fleet.counters["outvotes"],
        "drains": fleet.counters["drains"],
        "quarantines": fleet.counters["quarantines"],
        "ticks": fleet.tick,
        "wall_time_s": round(time.time() - t0, 2),
    }


def run_serve_envelope(
    output_dir: str = "experiments/serve_envelope",
    strengths: Iterable[float] = STRENGTHS,
    thresholds: Iterable[float] = THRESHOLDS,
    vote_ks: Iterable[int] = VOTE_KS,
    num_replicas: int = 3,
    num_requests: int = 24,
    # 4 slots a replica: slot exhaustion then needs 4 flags, so the vote
    # tier has room to win in the sub-threshold regime (suspicion opens
    # at 2).
    max_slots: int = 4,
    max_seq: int = 48,
    seed: int = 0,
    model_overrides: Optional[Dict[str, Any]] = None,
    fleet_overrides: Optional[Dict[str, Any]] = None,
    adversary_overrides: Optional[Dict[str, Any]] = None,
    make_figure: bool = True,
    device: Any = "cuda",
    dtype: str = "float32",
) -> Dict[str, Any]:
    """Measure the serve-side detection envelope and write JSON + figure +
    table.  JAX's arguments and defaults (a tiny GPT-2; the real widths
    through ``model_overrides``) plus ``device`` and ``dtype`` (a
    ``torch`` dtype's name)."""
    import torch

    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve.engine import resolve_device

    t0 = time.time()
    # Materialise once: a generator argument would exhaust after the
    # first vote_k pass.
    strengths = [float(s) for s in strengths]
    thresholds = [float(t) for t in thresholds]
    vote_ks = [int(k) for k in vote_ks]
    device = resolve_device(device)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    overrides = dict(TINY_GPT, **(model_overrides or {}))
    cfg = gpt2.GPT2Config(dtype=getattr(torch, dtype), **overrides)
    params = _init_params(cfg, seed, device)

    cells: List[Dict[str, Any]] = []
    for vote_k in vote_ks:
        for strength in strengths:
            for threshold in thresholds:
                logger.info("serve envelope: strength %.2f, threshold "
                            "%.1f, K=%d", strength, threshold, vote_k)
                cells.append(_run_cell(
                    params, cfg, seed=seed, strength=strength,
                    threshold=threshold, vote_k=vote_k,
                    num_replicas=num_replicas, num_requests=num_requests,
                    max_slots=max_slots, max_seq=max_seq,
                    fleet_overrides=fleet_overrides,
                    adversary_overrides=adversary_overrides,
                    device=device))

    from trustworthy_dl_tpu_torch.obs.meta import run_metadata

    results = {
        "config": {
            "strengths": strengths, "thresholds": thresholds,
            "vote_ks": vote_ks, "num_replicas": num_replicas,
            "num_requests": num_requests,
            "max_slots": max_slots, "max_seq": max_seq,
            "seed": seed, "model_overrides": overrides,
            "dtype": dtype,
        },
        # The platform stamp: an envelope measured on the CPU must never
        # be mistaken for the card's.
        "run_metadata": run_metadata(),
        "cells": cells,
        "wall_time_s": round(time.time() - t0, 2),
    }
    atomic_write_json(out / "serve_envelope.json", results)
    atomic_write_text(out / "serve_envelope.md", render_table(results))
    if make_figure:
        try:
            _figure(results, out / "serve_envelope.png")
        except Exception:  # a missing matplotlib must not lose the data
            logger.exception("serve envelope figure failed")
    logger.info("serve envelope: %d cells in %.1fs -> %s", len(cells),
                results["wall_time_s"], out)
    return results


def render_table(results: Dict[str, Any]) -> str:
    """README-ready markdown: one block per vote K; rows = strength,
    columns = monitor threshold, cell = the tier that caught it (and the
    corrupted streams that reached users before it did)."""
    config = results["config"]
    by_key = {(c["vote_k"], c["strength"], c["threshold"]): c
              for c in results["cells"]}
    marks = {"ladder": "LADDER", "vote": "VOTE", "none": "—"}
    lines: List[str] = []
    for vote_k in config["vote_ks"]:
        lines.append(f"**vote K = {vote_k}**"
                     + (" (voting off)" if vote_k == 0 else ""))
        lines.append("")
        lines.append("| strength \\ threshold | "
                     + " | ".join(f"{t:g}" for t in config["thresholds"])
                     + " |")
        lines.append("|---" * (len(config["thresholds"]) + 1) + "|")
        for s in config["strengths"]:
            row = [f"{s:g}"]
            for t in config["thresholds"]:
                c = by_key.get((vote_k, s, t))
                if c is None:
                    row.append("—")
                    continue
                row.append(f"{marks[c['detected_by']]} "
                           f"({c['corrupted_served']} corrupted served)")
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")
    clean = sum(c["clean_replica_quarantines"] for c in results["cells"])
    lines.append(f"Clean-replica quarantines across all cells: {clean} "
                 "(a lone faulty voter can never outvote a clean "
                 "replica — majority needs two agreeing dissenters).")
    return "\n".join(lines) + "\n"


def _figure(results: Dict[str, Any], path: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    config = results["config"]
    strengths = config["strengths"]
    thresholds = config["thresholds"]
    vote_ks = config["vote_ks"]
    by_key = {(c["vote_k"], c["strength"], c["threshold"]): c
              for c in results["cells"]}
    level = {"none": 0.0, "vote": 0.5, "ladder": 1.0}

    fig, axes = plt.subplots(1, len(vote_ks),
                             figsize=(4.2 * len(vote_ks), 3.6),
                             squeeze=False)
    for ax, vote_k in zip(axes[0], vote_ks):
        grid = np.full((len(strengths), len(thresholds)), np.nan)
        for r, s in enumerate(strengths):
            for c, t in enumerate(thresholds):
                cell = by_key.get((vote_k, s, t))
                if cell is not None:
                    grid[r, c] = level[cell["detected_by"]]
        im = ax.imshow(grid, cmap="viridis", vmin=0.0, vmax=1.0,
                       aspect="auto")
        ax.set_xticks(range(len(thresholds)),
                      [f"{t:g}" for t in thresholds])
        ax.set_yticks(range(len(strengths)), [f"{s:g}" for s in strengths])
        ax.set_xlabel("monitor threshold")
        ax.set_ylabel("attacker strength")
        ax.set_title(f"vote K = {vote_k}")
        for r, s in enumerate(strengths):
            for c, t in enumerate(thresholds):
                cell = by_key.get((vote_k, s, t))
                if cell is None:
                    continue
                ax.text(c, r, cell["detected_by"], ha="center",
                        va="center", fontsize=9,
                        color="white" if grid[r, c] < 0.6 else "black")
    fig.suptitle("Serve-side detection envelope (which tier caught the "
                 "adaptive poison)")
    fig.colorbar(im, ax=axes[0].tolist(), label="0 = none, 0.5 = vote, "
                 "1 = ladder")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


__all__ = ["STRENGTHS", "THRESHOLDS", "TINY_GPT", "VOTE_KS", "render_table",
           "run_serve_envelope"]
