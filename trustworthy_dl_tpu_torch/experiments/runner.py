"""ExperimentRunner: the L5 experiment layer, driving the real trainer.

Counterpart of ``trustworthy_dl_tpu/experiments/runner.py``.  Every
artifact derives from recorded state: per-step losses and trust
trajectories from the trainer's ``MetricsCollector``, detection events
from ``trainer.attack_history``, and, because the fault injection is
ground-truth controlled, real detection precision, recall and
time-to-detection.

Artifact contract: ``<output_dir>/<name>/`` gets experiment_results.json,
training_metrics.csv, four PNGs (training_loss, trust_evolution,
attack_impact, system_metrics) where ``matplotlib`` imports,
experiment_report.md, and intermediate_epoch_N.json every 5 epochs.  As in
JAX, every run carries an ``ObsSession`` under ``<name>/obs`` (trace,
metrics snapshot and Prometheus text, ``obs_report.json``), and
experiment_results.json embeds the step-time/MFU report as
``obs_report``.  The runner trains on the card
(``device="cuda"``) unless given ``device="cpu"``.  It runs the GPT-2,
ResNet and VGG presets in data mode and a pipeline ("model") config as
JAX does; JAX's ``gpt2_small_pipeline_clean`` asks for 8 stages of GPT-2
small's 12 layers and raises at ``setup_experiment``'s initialisation in
both packages ("12 layers not divisible by 8 stages").  ``main
--envelope`` runs the detection envelope (``experiments/envelope.py``),
``main --serve-envelope`` the serve-side one
(``experiments/serve_envelope.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from trustworthy_dl_tpu_torch.attacks.adversarial import \
    AdversarialAttacker, null_plan
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    ExperimentConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.obs.session import ObsSession
from trustworthy_dl_tpu_torch.serve.engine import resolve_device
from trustworthy_dl_tpu_torch.utils.io import atomic_write_json, \
    atomic_write_text

logger = logging.getLogger(__name__)


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion for json.dump(default=...)."""
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)


class ExperimentRunner:
    """Orchestrates a full experiment: real training under controlled fault
    injection, metric recording, artifact generation."""

    def __init__(self, config: ExperimentConfig,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 data_overrides: Optional[Dict[str, Any]] = None,
                 device: Any = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.output_dir = Path(config.output_dir) / config.experiment_name
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.training_config = config.to_training_config()
        self.model_overrides = dict(model_overrides or {})
        self.data_overrides = dict(data_overrides or {})

        self.trainer: Optional[DistributedTrainer] = None
        self.attacker: Optional[AdversarialAttacker] = None
        self.train_loader = None
        self.val_loader = None
        self.epoch_records: List[Dict[str, Any]] = []
        self._step_records_cache: Optional[List[Dict[str, Any]]] = None
        self.obs: Optional[ObsSession] = None
        logger.info("ExperimentRunner initialized: %s", config.experiment_name)

    # ------------------------------------------------------------------
    # Setup / run
    # ------------------------------------------------------------------

    def setup_experiment(self) -> None:
        self.trainer = DistributedTrainer(
            self.training_config, model_overrides=self.model_overrides,
            device=self.device,
        )
        # Telemetry: a trace, a metrics snapshot and the step-time/MFU
        # report of this run under <output_dir>/obs.
        self.obs = ObsSession(str(self.output_dir / "obs"))
        self.trainer.attach_obs(self.obs)
        if self.config.attack_enabled:
            attack_config = AttackConfig(
                attack_types=list(self.config.attack_types),
                target_nodes=[
                    n for n in self.config.target_nodes
                    if n < self.config.num_nodes
                ],
                intensity=self.config.attack_intensity,
                start_step=self.config.attack_start_epoch
                * self.config.steps_per_epoch,
            )
            self.attacker = AdversarialAttacker(attack_config)

        # steps_per_epoch governs the epoch length (it also anchors the
        # attack start step above), unless the caller pins num_examples.
        loader_kwargs = dict(self.data_overrides)
        train_kwargs = dict(loader_kwargs)
        train_kwargs.setdefault(
            "num_examples",
            self.config.batch_size * self.config.steps_per_epoch,
        )
        val_kwargs = dict(loader_kwargs)
        val_kwargs.setdefault(
            "num_examples",
            max(self.config.batch_size,
                train_kwargs["num_examples"] // 10),
        )
        self.train_loader = get_dataloader(
            self.config.dataset_name, split="train",
            batch_size=self.config.batch_size, **train_kwargs,
        )
        self.val_loader = get_dataloader(
            self.config.dataset_name, split="validation",
            batch_size=self.config.batch_size, **val_kwargs,
        )
        self.trainer.initialize()
        logger.info("Experiment setup completed")

    def run_experiment(self) -> Dict[str, Any]:
        logger.info("Starting experiment: %s", self.config.experiment_name)
        start_time = time.time()
        try:
            if self.trainer is None:
                self.setup_experiment()
            self._run_training_with_monitoring()
            final_results = self._collect_final_results()
            final_results["experiment_time_s"] = time.time() - start_time
            self._save_results(final_results)
            self._generate_visualizations()
            self._generate_experiment_report(final_results)
            logger.info("Experiment completed in %.2f seconds",
                        final_results["experiment_time_s"])
            return final_results
        except Exception:
            logger.exception("Experiment failed")
            raise
        finally:
            self._cleanup()

    def _run_training_with_monitoring(self) -> None:
        for epoch in range(self.config.num_epochs):
            epoch_start = time.time()
            if (self.config.attack_enabled and self.attacker
                    and epoch >= self.config.attack_start_epoch
                    and (self.config.attack_end_epoch is None
                         or epoch < self.config.attack_end_epoch)
                    and not self.attacker.is_active()):
                self.attacker.activate_attacks()
                # plan_for: targets are ORIGINAL identities; a
                # pre-activation eviction means coordinate != identity.
                # target_ids carries identities that are currently
                # off-mesh so a readmission during the attack window
                # re-attacks them.
                self.trainer.set_attack_plan(
                    self.attacker.plan_for(self.trainer.node_map),
                    target_ids=self.attacker.config.target_nodes,
                )
            if (self.attacker and self.attacker.is_active()
                    and self.config.attack_end_epoch is not None
                    and epoch >= self.config.attack_end_epoch):
                # Transient attack over: the recovery/readmission story
                # (probation + elastic readmission) plays out from here.
                self.attacker.deactivate_attacks()
                self.trainer.set_attack_plan(
                    null_plan(self.trainer.config.num_nodes)
                )
            epoch_loss = self.trainer.train_epoch(self.train_loader, epoch)
            val_loss = (self.trainer.validate(self.val_loader)
                        if self.val_loader is not None else None)
            self.epoch_records.append(
                self._epoch_snapshot(epoch, epoch_loss, val_loss,
                                     time.time() - epoch_start)
            )
            logger.info("Epoch %d/%d - loss %.4f - %.2fs", epoch + 1,
                        self.config.num_epochs, epoch_loss,
                        time.time() - epoch_start)
            if (epoch + 1) % 5 == 0:
                path = self.output_dir / f"intermediate_epoch_{epoch}.json"
                atomic_write_json(path, self.epoch_records,
                                  default=_jsonable)

    def _epoch_snapshot(self, epoch: int, train_loss: float,
                        val_loss: Optional[float], epoch_time: float
                        ) -> Dict[str, Any]:
        """Real per-epoch state — every value observed, none simulated."""
        tm = self.trainer.trust_manager
        n = self.config.num_nodes
        snapshot = {
            "epoch": epoch,
            "timestamp": time.time(),
            "training_loss": train_loss,
            "epoch_time_s": epoch_time,
            "trust_scores": {i: tm.get_trust_score(i) for i in range(n)},
            "node_statuses": {
                i: tm.get_node_status(i).name.lower() for i in range(n)
            },
            "system_trust": tm.calculate_system_trust(),
            "attacks_detected_so_far": len(self.trainer.attack_history),
            "reassignments_so_far": len(self.trainer.reassignment_history),
            # Elastic topology timeline: live coordinate count and the
            # identities they carry (evictions shrink it, readmissions
            # grow it back).
            "live_nodes": self.trainer.config.num_nodes,
            "node_map": list(self.trainer.node_map),
            "readmissions_so_far": self._count_records("readmitted_nodes"),
            "system_metrics": self._system_metrics(),
        }
        if val_loss is not None:
            snapshot["validation_loss"] = val_loss
        if self.attacker is not None:
            snapshot["attack_metrics"] = self.attacker.get_attack_statistics()
        return snapshot

    def _count_records(self, key: str) -> int:
        """Reassignment-history records of one kind (eviction records
        carry 'evicted_nodes', readmissions 'readmitted_nodes')."""
        return sum(
            1 for r in self.trainer.reassignment_history if key in r
        )

    def _system_metrics(self) -> Dict[str, Any]:
        """Measured system metrics (the reference simulated these,
        experiment_runner.py:262-274)."""
        out: Dict[str, Any] = {}
        stats = self.trainer.metrics_collector.step_time_stats()
        if stats:
            out["step_time"] = stats
            per_step = stats["mean_s"]
            if per_step > 0:
                out["samples_per_sec"] = self.config.batch_size / per_step
        device = self.trainer.device
        if device.type == "cuda":
            import torch

            out["device_memory_bytes_in_use"] = int(
                torch.cuda.memory_allocated(device))
            _, total = torch.cuda.mem_get_info(device)
            if total:
                out["device_memory_utilization"] = (
                    out["device_memory_bytes_in_use"] / total)
        return out

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------

    def _detection_quality(self) -> Dict[str, Any]:
        """Ground-truth detection quality — possible because the fault
        injection is ours: configured targets vs detected nodes."""
        detected = {rec["node_id"] for rec in self.trainer.attack_history}
        if not self.config.attack_enabled:
            return {
                "attack_enabled": False,
                "false_positive_nodes": sorted(detected),
                "false_positive_rate": len(detected)
                / max(self.config.num_nodes, 1),
            }
        targets = {n for n in self.config.target_nodes
                   if n < self.config.num_nodes}
        tp = detected & targets
        fp = detected - targets
        start_step = (self.config.attack_start_epoch
                      * self.config.steps_per_epoch)
        detection_steps = {
            rec["node_id"]: rec["step"] - start_step
            for rec in reversed(self.trainer.attack_history)
            if rec["node_id"] in tp
        }
        return {
            "attack_enabled": True,
            "target_nodes": sorted(targets),
            "detected_nodes": sorted(detected),
            "true_positives": sorted(tp),
            "false_positives": sorted(fp),
            "missed": sorted(targets - detected),
            "precision": len(tp) / len(detected) if detected else None,
            "recall": len(tp) / len(targets) if targets else None,
            "steps_to_detection": detection_steps,
        }

    def _collect_final_results(self) -> Dict[str, Any]:
        trust_stats = self.trainer.trust_manager.get_trust_statistics()
        attack_stats = (self.attacker.get_final_statistics()
                        if self.attacker else {})
        losses = [r["training_loss"] for r in self.epoch_records]
        summary = {
            "total_epochs": len(self.epoch_records),
            "total_steps": self.trainer.global_step,
            "average_loss": float(np.mean(losses)) if losses else None,
            "final_loss": losses[-1] if losses else None,
            "loss_reduction": (
                (losses[0] - losses[-1]) / losses[0]
                if len(losses) > 1 and losses[0] else None
            ),
            "final_system_trust":
                self.trainer.trust_manager.calculate_system_trust(),
            "compromised_nodes": sorted(
                self.trainer.trust_manager.get_compromised_nodes()
            ),
            "total_attacks_detected": len(self.trainer.attack_history),
            "total_reassignments": len(self.trainer.reassignment_history),
            "total_evictions": self._count_records("evicted_nodes"),
            "total_readmissions": self._count_records("readmitted_nodes"),
            "final_live_nodes": self.trainer.config.num_nodes,
            "recovered_nodes": sorted({
                nid for r in self.trainer.reassignment_history
                if "readmitted_nodes" in r for nid in r["readmitted_nodes"]
                if nid in self.trainer.node_map
            }),
            "detection_quality": self._detection_quality(),
        }
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata

        return {
            "experiment_config": dataclasses.asdict(self.config),
            "training_config": dataclasses.asdict(self.training_config),
            "run_metadata": run_metadata(),
            "epoch_records": self.epoch_records,
            "attack_history": self.trainer.attack_history,
            "reassignment_history": self.trainer.reassignment_history,
            "final_trust_statistics": trust_stats,
            "final_attack_statistics": attack_stats,
            "training_stats": self.trainer.get_training_stats(),
            "experiment_summary": summary,
            # Step-time breakdown + MFU of THIS run (obs/report.py); the
            # standalone copy lands at <output_dir>/obs/.
            "obs_report": (self.obs.step_timer.report()
                           if self.obs is not None else None),
        }

    def _step_records(self) -> List[Dict[str, Any]]:
        """Per-step records (loss + per-node trust), computed once.
        Plain dicts — the runner must work on a base install (pandas is an
        optional extra)."""
        if getattr(self, "_step_records_cache", None) is None:
            records = []
            for m in self.trainer.metrics_collector.batch_metrics:
                row = {"step": m.get("step"), "epoch": m.get("epoch"),
                       "loss": m.get("loss"), "timestamp": m.get("timestamp")}
                for node, score in (m.get("trust_scores") or {}).items():
                    row[f"trust_node_{node}"] = score
                records.append(row)
            self._step_records_cache = records
        return self._step_records_cache

    def _save_results(self, results: Dict[str, Any]) -> None:
        import csv

        atomic_write_json(self.output_dir / "experiment_results.json",
                          results, default=_jsonable)
        records = self._step_records()
        if records:
            fields = list(records[0].keys())
            for r in records[1:]:
                for k in r:
                    if k not in fields:
                        fields.append(k)
            import io as _io

            buf = _io.StringIO(newline="")
            writer = csv.DictWriter(buf, fieldnames=fields)
            writer.writeheader()
            writer.writerows(records)
            atomic_write_text(
                self.output_dir / "training_metrics.csv", buf.getvalue())
        logger.info("Results saved to %s", self.output_dir)

    # ------------------------------------------------------------------
    # Visualizations — all from recorded data
    # ------------------------------------------------------------------

    def _generate_visualizations(self) -> None:
        try:
            import matplotlib

            matplotlib.use("Agg")
        except ImportError:
            logger.warning("matplotlib unavailable; skipping plots")
            return
        self._plot_training_loss()
        self._plot_trust_evolution()
        self._plot_attack_impact()
        self._plot_system_metrics()
        if self.trainer.reassignment_history:
            # Elastic runs only: the topology actually changed (the
            # history catches even an evict+readmit that reverts within
            # one epoch, which per-epoch snapshots would miss).
            self._plot_topology_timeline()
        logger.info("Visualizations saved to %s", self.output_dir)

    def _plot_topology_timeline(self) -> None:
        """Live-coordinate count per epoch with eviction/readmission
        markers — the elastic lifecycle at a glance (recovery
        experiments)."""
        import matplotlib.pyplot as plt

        epochs = [r["epoch"] for r in self.epoch_records]
        live = [r["live_nodes"] for r in self.epoch_records]
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.step(epochs, live, where="post", linewidth=2)
        ax.set_ylim(0, self.config.num_nodes + 1)
        ax.set_xlabel("epoch")
        ax.set_ylabel("live mesh coordinates")
        ax.set_title("Elastic Topology Timeline")
        steps_per = max(self.config.steps_per_epoch, 1)
        for rec in self.trainer.reassignment_history:
            x = rec.get("step", 0) / steps_per
            if "evicted_nodes" in rec:
                ax.axvline(x, color="tab:red", linestyle="--", alpha=0.7)
                ax.annotate(f"evict {rec['evicted_nodes']}", (x, 0.5),
                            rotation=90, fontsize=8, color="tab:red")
            elif "readmitted_nodes" in rec:
                ax.axvline(x, color="tab:green", linestyle="--", alpha=0.7)
                ax.annotate(f"readmit {rec['readmitted_nodes']}", (x, 0.5),
                            rotation=90, fontsize=8, color="tab:green")
        fig.tight_layout()
        fig.savefig(self.output_dir / "topology_timeline.png", dpi=120)
        plt.close(fig)

    def _plot_training_loss(self) -> None:
        import matplotlib.pyplot as plt

        records = self._step_records()
        if not records:
            return
        steps = np.array([r["step"] for r in records])
        losses = np.array([r["loss"] for r in records], dtype=float)
        plt.figure(figsize=(12, 6))
        plt.plot(steps, losses, alpha=0.6, label="per-step loss")
        if len(losses) > 10:
            window = min(20, max(len(losses) // 5, 2))
            kernel = np.ones(window) / window
            ma = np.convolve(losses, kernel, mode="valid")
            plt.plot(steps[window - 1:], ma, linewidth=2,
                     label=f"moving average ({window})")
        self._mark_attack_start(plt)
        plt.xlabel("Step")
        plt.ylabel("Loss")
        plt.title("Training Loss (recorded)")
        plt.legend()
        plt.grid(True, alpha=0.3)
        plt.savefig(self.output_dir / "training_loss.png", dpi=150,
                    bbox_inches="tight")
        plt.close()

    def _plot_trust_evolution(self) -> None:
        import matplotlib.pyplot as plt

        records = self._step_records()
        if not records:
            return
        trust_cols = sorted(
            {k for r in records for k in r if k.startswith("trust_node_")},
            key=lambda c: int(c.rsplit("_", 1)[1]),
        )
        if not trust_cols:
            return
        steps = np.array([r["step"] for r in records])
        plt.figure(figsize=(12, 8))
        targets = set(self.config.target_nodes) if (
            self.config.attack_enabled) else set()
        for col in trust_cols:
            node = int(col.rsplit("_", 1)[1])
            style = "--" if node in targets else "-"
            series = np.array([r.get(col, np.nan) for r in records],
                              dtype=float)
            plt.plot(steps, series, style, linewidth=2,
                     label=f"node {node}" + (" (target)" if node in targets
                                             else ""))
        self._mark_attack_start(plt)
        plt.axhline(self.config.trust_threshold, color="grey", alpha=0.5,
                    label="trust threshold")
        plt.xlabel("Step")
        plt.ylabel("Trust score")
        plt.title("Trust Score Evolution by Node (recorded)")
        plt.legend(ncol=2, fontsize=8)
        plt.grid(True, alpha=0.3)
        plt.ylim(0, 1.05)
        plt.savefig(self.output_dir / "trust_evolution.png", dpi=150,
                    bbox_inches="tight")
        plt.close()

    def _mark_attack_start(self, plt) -> None:
        if self.config.attack_enabled:
            start = (self.config.attack_start_epoch
                     * self.config.steps_per_epoch)
            plt.axvline(start, color="red", alpha=0.4, linestyle=":",
                        label="attack start")

    def _plot_attack_impact(self) -> None:
        """2×2: detections over time, per-node detections, system trust,
        attack timeline — real events, not the reference's synthetic ramps
        (experiment_runner.py:427-451)."""
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 2, figsize=(15, 10))
        steps = [r["step"] for r in self.trainer.attack_history]
        max_step = max(self.trainer.global_step, 1)

        grid = np.arange(0, max_step + 1)
        cumulative = np.searchsorted(np.sort(steps), grid, side="right")
        axes[0, 0].plot(grid, cumulative, linewidth=2)
        axes[0, 0].set_title("Cumulative Detections")
        axes[0, 0].set_ylabel("incidents")

        nodes = [r["node_id"] for r in self.trainer.attack_history]
        counts = np.bincount(nodes, minlength=self.config.num_nodes) if nodes \
            else np.zeros(self.config.num_nodes)
        axes[0, 1].bar(range(self.config.num_nodes), counts)
        axes[0, 1].set_title("Detections per Node")
        axes[0, 1].set_xlabel("node")
        axes[0, 1].set_ylabel("incidents")

        epochs = [r["epoch"] for r in self.epoch_records]
        axes[1, 0].plot(epochs,
                        [r["system_trust"] for r in self.epoch_records],
                        linewidth=2)
        axes[1, 0].set_title("System Trust")
        axes[1, 0].set_xlabel("epoch")
        axes[1, 0].set_ylim(0, 1.05)

        active = [
            1 if (self.config.attack_enabled
                  and e >= self.config.attack_start_epoch) else 0
            for e in epochs
        ]
        axes[1, 1].fill_between(epochs, active, alpha=0.3, color="red",
                                label="attack period")
        axes[1, 1].set_title("Attack Timeline")
        axes[1, 1].set_xlabel("epoch")
        axes[1, 1].legend()

        for ax in axes.flat:
            ax.grid(True, alpha=0.3)
        plt.tight_layout()
        plt.savefig(self.output_dir / "attack_impact.png", dpi=150,
                    bbox_inches="tight")
        plt.close()

    def _plot_system_metrics(self) -> None:
        """Measured step time / throughput / memory (reference simulated
        all three, experiment_runner.py:488-519)."""
        import matplotlib.pyplot as plt

        epochs = [r["epoch"] for r in self.epoch_records]
        fig, axes = plt.subplots(1, 3, figsize=(18, 5))

        axes[0].plot(epochs, [r["epoch_time_s"] for r in self.epoch_records],
                     linewidth=2)
        axes[0].set_title("Epoch Wall Time")
        axes[0].set_ylabel("seconds")

        sps = [r["system_metrics"].get("samples_per_sec")
               for r in self.epoch_records]
        if any(v is not None for v in sps):
            axes[1].plot(epochs, sps, linewidth=2)
        axes[1].set_title("Throughput")
        axes[1].set_ylabel("samples/sec")

        mem = [r["system_metrics"].get("device_memory_utilization")
               for r in self.epoch_records]
        if any(v is not None for v in mem):
            axes[2].plot(epochs, mem, linewidth=2)
            axes[2].set_ylabel("fraction of HBM")
            axes[2].set_title("Device Memory Utilization")
        else:
            st = self.trainer.metrics_collector._step_times
            if st:
                axes[2].hist(st, bins=30)
                axes[2].set_title("Step Time Histogram")
                axes[2].set_xlabel("seconds")

        for ax in axes:
            ax.grid(True, alpha=0.3)
            ax.set_xlabel("epoch")
        plt.tight_layout()
        plt.savefig(self.output_dir / "system_metrics.png", dpi=150,
                    bbox_inches="tight")
        plt.close()

    # ------------------------------------------------------------------
    # Report
    # ------------------------------------------------------------------

    def _generate_experiment_report(self, results: Dict[str, Any]) -> None:
        summary = results.get("experiment_summary", {})
        quality = summary.get("detection_quality", {})
        reliability = {
            i: self.trainer.trust_manager.predict_node_reliability(i)
            for i in range(self.config.num_nodes)
        }

        def fmt(v, spec=".4f"):
            return format(v, spec) if isinstance(v, (int, float)) else "n/a"

        lines = [
            f"# Experiment Report: {self.config.experiment_name}",
            "",
            "## Configuration",
            f"- model: {self.config.model_name}"
            f" / dataset: {self.config.dataset_name}",
            f"- nodes: {self.config.num_nodes}"
            f" ({self.config.parallelism} parallelism)",
            f"- epochs: {self.config.num_epochs},"
            f" batch size: {self.config.batch_size},"
            f" lr: {self.config.learning_rate}",
            f"- attacks: {self.config.attack_enabled}"
            + (f" ({', '.join(self.config.attack_types)} on nodes"
               f" {self.config.target_nodes}, intensity"
               f" {self.config.attack_intensity}, from epoch"
               f" {self.config.attack_start_epoch})"
               if self.config.attack_enabled else ""),
            f"- trust threshold: {self.config.trust_threshold}",
            "",
            "## Training",
            f"- steps: {summary.get('total_steps')}",
            f"- average loss: {fmt(summary.get('average_loss'))}",
            f"- final loss: {fmt(summary.get('final_loss'))}",
            f"- loss reduction: {fmt(summary.get('loss_reduction'), '.2%')}",
            "",
            "## Security (all measured against ground-truth injection)",
            f"- final system trust: "
            f"{fmt(summary.get('final_system_trust'), '.3f')}",
            f"- compromised nodes: {summary.get('compromised_nodes')}",
            f"- incidents recorded: {summary.get('total_attacks_detected')},"
            f" reassignments: {summary.get('total_reassignments')}",
        ]
        if quality.get("attack_enabled"):
            lines += [
                f"- detection precision: {fmt(quality.get('precision'), '.2f')}"
                f" / recall: {fmt(quality.get('recall'), '.2f')}",
                f"- steps to detection: {quality.get('steps_to_detection')}",
                f"- false positives: {quality.get('false_positives')}",
            ]
        else:
            lines += [
                "- clean run false-positive rate: "
                f"{fmt(quality.get('false_positive_rate'), '.3f')}",
            ]
        lines += [
            "",
            "## Node reliability forecast (trend extrapolation)",
        ]
        for node, pred in reliability.items():
            lines.append(f"- node {node}: {fmt(pred, '.3f')}")
        lines += [
            "",
            "## Artifacts",
            "- `experiment_results.json`, `training_metrics.csv`",
            "- `training_loss.png`, `trust_evolution.png`,"
            " `attack_impact.png`, `system_metrics.png`",
            "",
            f"*Generated {time.strftime('%Y-%m-%d %H:%M:%S')}*",
        ]
        atomic_write_text(self.output_dir / "experiment_report.md",
                          "\n".join(lines) + "\n")
        logger.info("Experiment report generated")

    def _cleanup(self) -> None:
        if self.obs is not None:
            self.obs.finalize()   # snapshot, obs_report.json, trace closed
        if self.trainer is not None:
            self.trainer.cleanup()
        if self.attacker is not None:
            self.attacker.cleanup()
        logger.info("Experiment cleanup completed")


# ---------------------------------------------------------------------------
# BASELINE.md benchmark-matrix presets
# ---------------------------------------------------------------------------

PRESETS: Dict[str, Dict[str, Any]] = {
    # 1. ResNet-32 / CIFAR-10 clean
    "resnet32_cifar10_clean": dict(
        model_name="resnet32", dataset_name="cifar10", num_nodes=8,
        attack_enabled=False, parallelism="data",
    ),
    # 2. VGG-16 / CIFAR-10 gradient poisoning + detector
    "vgg16_cifar10_poisoning": dict(
        model_name="vgg16", dataset_name="cifar10", num_nodes=8,
        attack_enabled=True,
        attack_types=["gradient_poisoning", "data_poisoning"],
        target_nodes=[1, 3], parallelism="data",
    ),
    # 3. GPT-2-small / OpenWebText 8-way model parallel, clean
    "gpt2_small_pipeline_clean": dict(
        model_name="gpt2", dataset_name="openwebtext", num_nodes=8,
        attack_enabled=False, parallelism="model",
    ),
    # 4. GPT-2-medium, 2/8 compromised, reassignment
    "gpt2_medium_reassignment": dict(
        model_name="gpt2-medium", dataset_name="openwebtext", num_nodes=8,
        attack_enabled=True, attack_types=["gradient_poisoning"],
        target_nodes=[1, 3], parallelism="data",
    ),
    # 5. ResNet-101 Byzantine multi-node (trust-threshold sweep via
    #    run_threshold_sweep)
    "resnet101_byzantine": dict(
        model_name="resnet101", dataset_name="cifar10", num_nodes=8,
        attack_enabled=True, attack_types=["byzantine"],
        target_nodes=[1, 3], parallelism="data",
    ),
    # 6. (beyond-reference) Transient attack -> eviction -> recovery /
    #    readmission: the full elastic lifecycle as a measured experiment.
    "gpt2_transient_recovery": dict(
        model_name="gpt2", dataset_name="openwebtext", num_nodes=8,
        attack_enabled=True, attack_types=["gradient_poisoning"],
        target_nodes=[5], attack_start_epoch=1, attack_end_epoch=3,
        parallelism="data", elastic_resharding=True,
        readmit_after_steps=60, num_epochs=6,
    ),
}


def preset_config(name: str, **overrides: Any) -> ExperimentConfig:
    if name not in PRESETS:
        raise ValueError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    kwargs = dict(PRESETS[name])
    kwargs.update(overrides)
    kwargs.setdefault(
        "experiment_name", f"{name}_{time.strftime('%Y%m%d_%H%M%S')}"
    )
    return ExperimentConfig(**kwargs)


def run_threshold_sweep(base: ExperimentConfig,
                        thresholds: List[float],
                        **runner_kwargs: Any) -> Dict[str, Any]:
    """BASELINE config 5: repeat an experiment across trust thresholds and
    aggregate detection quality per threshold."""
    from trustworthy_dl_tpu_torch.obs.meta import run_metadata

    sweep: Dict[str, Any] = {"thresholds": {}, "base": base.experiment_name,
                             "run_metadata": run_metadata()}
    for threshold in thresholds:
        config = dataclasses.replace(
            base,
            experiment_name=f"{base.experiment_name}_t{threshold:g}",
            trust_threshold=threshold,
        )
        results = ExperimentRunner(config, **runner_kwargs).run_experiment()
        sweep["thresholds"][f"{threshold:g}"] = {
            "summary": results["experiment_summary"],
            # The threshold's direct lever is the status machine
            # (trust_manager.py:162-181): per-threshold status counts are
            # what a sweep consumer compares first.
            "trust_statistics": results["final_trust_statistics"],
        }
    out_dir = Path(base.output_dir) / f"{base.experiment_name}_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    atomic_write_json(out_dir / "sweep_results.json", sweep,
                      default=_jsonable)
    return sweep


# ---------------------------------------------------------------------------
# Console entry point: trustworthy-dl-experiment (setup_py.py:62-65)
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None,
         model_overrides: Optional[Dict[str, Any]] = None,
         data_overrides: Optional[Dict[str, Any]] = None) -> int:
    """``python -m trustworthy_dl_tpu_torch.experiments.runner``: the
    JAX package's ``trustworthy-dl-experiment`` with ``--device``;
    ``model_overrides`` / ``data_overrides`` shrink the run (tests).
    ``--envelope`` and ``--serve-envelope`` sweep their own tiny GPT-2,
    as JAX's do, on ``--device``."""
    import argparse

    parser = argparse.ArgumentParser(
        description="Run trustworthy distributed DL experiments"
    )
    parser.add_argument("--config", type=str,
                        help="experiment config file (YAML/JSON)")
    parser.add_argument("--preset", type=str, choices=sorted(PRESETS),
                        help="BASELINE.md benchmark preset")
    parser.add_argument("--name", type=str, help="experiment name")
    parser.add_argument("--model", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--nodes", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--attack", action="store_true",
                        help="enable fault injection")
    parser.add_argument("--parallelism", type=str, default=None)
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--sweep-thresholds", type=str, default=None,
                        help="comma-separated trust thresholds (preset 5)")
    parser.add_argument("--envelope", action="store_true",
                        help="measure the detection envelope (attack type "
                        "x intensity matrix) instead of a single "
                        "experiment")
    parser.add_argument("--serve-envelope", action="store_true",
                        help="measure the serve-side detection envelope "
                        "(adaptive attacker strength x monitor threshold "
                        "x vote K against a ServingFleet) instead of a "
                        "single experiment")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cpu runs every kernel's plain PyTorch version")
    args = parser.parse_args(argv)

    if args.serve_envelope:
        from trustworthy_dl_tpu_torch.experiments.serve_envelope import \
            run_serve_envelope

        kwargs: Dict[str, Any] = {"device": args.device}
        if args.output_dir:
            kwargs["output_dir"] = args.output_dir
        results = run_serve_envelope(**kwargs)
        caught = sum(1 for c in results["cells"]
                     if c["detected_by"] != "none")
        print(f"Serve envelope: {len(results['cells'])} cells "
              f"({caught} detected) in {results['wall_time_s']:.1f}s")
        return 0

    if args.envelope:
        from trustworthy_dl_tpu_torch.experiments.envelope import \
            run_detection_envelope

        # Refuse flags the sweep would silently ignore: a user passing
        # --model/--steps must not publish numbers believing they
        # measured that configuration.
        unsupported = {
            "--config": args.config, "--preset": args.preset,
            "--name": args.name, "--model": args.model,
            "--dataset": args.dataset, "--epochs": args.epochs,
            "--batch-size": args.batch_size,
            "--parallelism": args.parallelism,
            "--steps-per-epoch": args.steps_per_epoch,
            "--attack": args.attack or None,
            "--sweep-thresholds": args.sweep_thresholds,
        }
        rejected = [flag for flag, value in unsupported.items()
                    if value is not None]
        if rejected:
            parser.error(
                f"--envelope does not take {', '.join(rejected)}; it "
                "sweeps its own fixed matrix (use "
                "run_detection_envelope(...) for custom shapes)"
            )
        kwargs: Dict[str, Any] = {"device": args.device}
        if args.output_dir:
            kwargs["output_dir"] = args.output_dir
        if args.nodes:
            kwargs["num_nodes"] = args.nodes
        results = run_detection_envelope(**kwargs)
        print(f"Detection envelope: {len(results['cells'])} cells in "
              f"{results['wall_time_s']:.1f}s")
        return 0

    overrides = {
        k: v for k, v in {
            "model_name": args.model,
            "dataset_name": args.dataset,
            "num_nodes": args.nodes,
            "num_epochs": args.epochs,
            "batch_size": args.batch_size,
            "parallelism": args.parallelism,
            "steps_per_epoch": args.steps_per_epoch,
            "output_dir": args.output_dir,
            "experiment_name": args.name,
        }.items() if v is not None
    }
    if args.attack:
        overrides["attack_enabled"] = True

    if args.config:
        from trustworthy_dl_tpu_torch.core.config import \
            load_experiment_config

        overrides.setdefault(
            "experiment_name",
            f"experiment_{time.strftime('%Y%m%d_%H%M%S')}",
        )
        config = load_experiment_config(args.config, **overrides)
    elif args.preset:
        config = preset_config(args.preset, **overrides)
    else:
        overrides.setdefault("model_name", "gpt2")
        overrides.setdefault("dataset_name", "openwebtext")
        name = overrides.pop(
            "experiment_name",
            "{}_{}_nodes{}_{}".format(
                overrides["model_name"], overrides["dataset_name"],
                overrides.get("num_nodes", 4),
                time.strftime("%Y%m%d_%H%M%S"),
            ),
        )
        config = ExperimentConfig(experiment_name=name, **overrides)

    runner_kwargs = dict(model_overrides=model_overrides,
                         data_overrides=data_overrides, device=args.device)
    if args.sweep_thresholds:
        thresholds = [float(t) for t in args.sweep_thresholds.split(",")]
        run_threshold_sweep(config, thresholds, **runner_kwargs)
        print(f"Sweep completed: {config.experiment_name} over {thresholds}")
        return 0

    runner = ExperimentRunner(config, **runner_kwargs)
    runner.run_experiment()
    print(f"Experiment completed: {config.experiment_name}")
    print(f"Results saved to: {runner.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
