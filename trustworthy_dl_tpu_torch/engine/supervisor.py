"""Self-healing training supervisor: keeps a run alive through the
failures the trust stack does not cover.

Counterpart of ``trustworthy_dl_tpu/engine/supervisor.py``.  The in-step
machinery neutralises a lying node, but the
run itself still dies or wedges on systemic faults: fleet-wide non-finite
state, preempted hosts, truncated checkpoints.  The supervisor wraps
:class:`DistributedTrainer` with the recovery ladder:

1. step guard: after every step, reject it if the aggregate loss or
   gradient norm is non-finite, or if no node produced finite gradients
   (the in-step gate then froze the params and masked the loss to 0.0);
2. bounded retries: re-run the same batch up to ``max_retries`` times,
   with exponential backoff;
3. verified-checkpoint rollback: after ``rollback_after`` consecutive bad
   steps, restore the newest checkpoint that passes its manifest and
   loads, and continue;
4. preemption: a preemption (SIGTERM with ``handle_signals``, or a chaos
   ``SimulatedPreemption``) saves, then resumes from the newest verified
   checkpoint, at most ``max_restarts`` times.

The guard only accepts steps, so periodic checkpoints are taken from sane
state.  Under the async host pipeline (``async_host_depth`` > 0) the
verdict on a step arrives up to K steps late (``after_step(...,
lagged=True)``): the in-place retries are skipped and a bad step counts
straight toward the rollback, whose target predates the in-flight window.
:meth:`TrainingSupervisor.report` carries the counters, keyed like
``FaultPlan.predict``, which assumes depth 0.

Telemetry, as in JAX: every ladder action counts in
``tddl_supervisor_actions_total{action=}`` (on the session's registry,
else the process-wide one).  With ``obs`` (an ``ObsSession``) each guard
trip, retry, rollback, preemption and restart is a trace event, a
rejected step's loss and gradient norm feed the anomaly watcher, the
flight recorder is dumped next to the checkpoints at the first bad step
of a streak, at a rollback and at a preemption, and ``report`` carries
the watchers' active anomalies and SLO breaches.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from trustworthy_dl_tpu_torch.chaos.injector import FaultInjector, \
    SimulatedPreemption
from trustworthy_dl_tpu_torch.engine.step import StepMetrics
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer, \
    TrainingState
from trustworthy_dl_tpu_torch.obs.events import EventType
from trustworthy_dl_tpu_torch.obs.registry import get_registry

logger = logging.getLogger(__name__)


class PreemptionSignal(Exception):
    """Raised inside the step loop when a real termination signal
    (SIGTERM) arrived: the same recovery path as a simulated
    preemption."""


class TrainingSupervisor:
    """Wraps a :class:`DistributedTrainer` with the skip / retry /
    rollback / restart ladder.  Construction attaches the supervisor as
    the trainer's ``step_guard`` and wires ``chaos`` into the trainer and
    its checkpointer; drive training through :meth:`run`.

    ``backoff_base_s`` is the first retry's sleep (doubled per attempt; 0
    sleeps not at all).  ``handle_signals=True`` installs a SIGTERM
    handler (main thread only).  ``obs`` (an ``ObsSession``) is attached
    to the trainer too, so both sides' events share one trace."""

    def __init__(self, trainer: DistributedTrainer, *,
                 max_retries: int = 2, rollback_after: int = 3,
                 max_restarts: int = 3, backoff_base_s: float = 0.0,
                 chaos: Optional[FaultInjector] = None,
                 handle_signals: bool = False, obs: Any = None):
        if max_retries < 0 or rollback_after < 1 or max_restarts < 0:
            raise ValueError(
                "max_retries >= 0, rollback_after >= 1, max_restarts >= 0")
        self.trainer = trainer
        self.max_retries = max_retries
        self.rollback_after = rollback_after
        self.max_restarts = max_restarts
        self.backoff_base_s = backoff_base_s
        self.chaos = chaos
        self.handle_signals = handle_signals
        self.obs = obs

        self.retries = 0
        self.rollbacks = 0
        self.rollback_steps: List[int] = []
        self.restarts = 0
        self.preemptions = 0
        self.bad_steps = 0
        self._bad_streak = 0
        self._preempt_flag = False
        self._old_handler: Any = None

        registry = obs.registry if obs is not None else get_registry()
        self._counters = registry.counter(
            "tddl_supervisor_actions_total",
            "Supervisor recovery-ladder actions, by action",
            labels=("action",))

        trainer.step_guard = self
        if chaos is not None:
            trainer.chaos = chaos
            trainer.checkpointer.chaos = chaos
        if obs is not None:
            trainer.attach_obs(obs)

    # -- step guard --------------------------------------------------------

    @staticmethod
    def _verdict(metrics: StepMetrics) -> Dict[str, Any]:
        """Loss, gradient norm and finite-node count: one device-to-host
        copy of device metrics, none of a lagged step's unpacked ones."""
        if isinstance(metrics.loss, torch.Tensor):
            flat = torch.cat([metrics.loss.reshape(1).float(),
                              metrics.grad_norm.reshape(1).float(),
                              metrics.finite.reshape(-1).float()]
                             ).cpu().numpy()
        else:
            flat = np.concatenate([
                np.asarray(metrics.loss, np.float32).reshape(1),
                np.asarray(metrics.grad_norm, np.float32).reshape(1),
                np.asarray(metrics.finite, np.float32).reshape(-1)])
        finite = flat[2:]
        return {"loss": float(flat[0]), "grad_norm": float(flat[1]),
                "finite_nodes": int(finite.sum()),
                "nodes": int(finite.size)}

    @staticmethod
    def _bad(v: Dict[str, Any]) -> bool:
        """A step the run must not build on: non-finite aggregate loss or
        gradient norm, or a fleet with no finite-gradient node (the gate
        then masked the loss to 0.0: finite, but the params froze)."""
        if not math.isfinite(v["loss"]) or not math.isfinite(v["grad_norm"]):
            return True
        return v["nodes"] > 0 and v["finite_nodes"] == 0

    @classmethod
    def _is_bad(cls, metrics: StepMetrics) -> bool:
        return cls._bad(cls._verdict(metrics))

    def after_step(self, trainer: DistributedTrainer, node_batch: Any,
                   metrics: StepMetrics, lagged: bool = False
                   ) -> Optional[StepMetrics]:
        """The trainer's step-guard hook: the metrics to account, or None
        when the step was rejected (and perhaps rolled back, with
        ``trainer.global_step`` then at the restored step).

        ``lagged=True``: the verdict arrives up to K steps after the step
        ran, with ``trainer.state`` already at the dispatch frontier.
        Re-running a K-step-old batch against that state is another
        computation, so no retry runs and the bad step counts toward the
        rollback at once; the newest verified checkpoint predates the
        window (saves drain fully first)."""
        if self._preempt_flag:
            self._preempt_flag = False
            raise PreemptionSignal("SIGTERM received")
        v = self._verdict(metrics)
        if not self._bad(v):
            self._bad_streak = 0
            return metrics
        retries = 0 if lagged else self.max_retries
        logger.warning(
            "Supervisor: bad step %d (loss=%s, grad_norm=%s, "
            "finite_nodes=%d/%d)%s: retrying up to %d time(s)",
            trainer.global_step, v["loss"], v["grad_norm"],
            v["finite_nodes"], v["nodes"],
            " [lagged verdict: no in-place retry]" if lagged else "",
            retries)
        if self.obs is not None:
            self.obs.trace.emit(
                EventType.GUARD_TRIP, step=trainer.global_step,
                loss=v["loss"], grad_norm=v["grad_norm"],
                finite_nodes=v["finite_nodes"])
            if self.obs.anomaly is not None:
                # Rejected steps never reach the trainer's accepted-step
                # feed: the bad observations (a NaN loss IS the anomaly)
                # go to the watcher here.
                self.obs.anomaly.observe("loss", v["loss"],
                                         step=trainer.global_step)
                self.obs.anomaly.observe("grad_norm", v["grad_norm"],
                                         step=trainer.global_step)
        self._counters.inc(action="guard_trip")
        for attempt in range(retries):
            self.retries += 1
            self._counters.inc(action="retry")
            if self.obs is not None:
                self.obs.trace.emit(EventType.SUPERVISOR_RETRY,
                                    step=trainer.global_step,
                                    attempt=attempt + 1)
            if self.backoff_base_s > 0:
                time.sleep(self.backoff_base_s * (2 ** attempt))
            trainer.state, metrics = trainer._train_step(
                trainer.state, node_batch, trainer.attack_plan)
            if not self._is_bad(metrics):
                logger.info("Supervisor: retry %d recovered step %d",
                            attempt + 1, trainer.global_step)
                self._bad_streak = 0
                return metrics
        self.bad_steps += 1
        self._bad_streak += 1
        self._counters.inc(action="bad_step")
        if self.obs is not None and self._bad_streak == 1:
            # One dump per incident (the streak's first bad step); a
            # rollback writes its own.
            self.obs.dump_flight("guard_trip", step=trainer.global_step,
                                 directory=trainer.config.checkpoint_dir)
        if self._bad_streak >= self.rollback_after:
            self._rollback(trainer)
        return None

    def _rollback(self, trainer: DistributedTrainer) -> None:
        """Restore the newest restorable checkpoint and clear the bad
        streak: the verified candidates newest-first, falling to the next
        older one when a restore fails."""
        bad_step = trainer.global_step   # where the run was when it broke
        candidates = trainer.checkpointer.verified_steps()
        if not candidates:
            raise RuntimeError(
                f"{self._bad_streak} consecutive bad steps and no verified "
                "checkpoint to roll back to (run() writes one at start; "
                "direct train() callers must save one themselves)")
        logger.error(
            "Supervisor: %d consecutive unrecoverable steps: rolling back "
            "from step %d (candidates: %s)", self._bad_streak,
            trainer.global_step, candidates[:5])
        for step in candidates:
            try:
                trainer.load_checkpoint(step)
                break
            except Exception as exc:
                logger.error(
                    "Supervisor: restore of checkpoint step %d failed "
                    "(%s: %s); trying the next older checkpoint", step,
                    type(exc).__name__, str(exc)[:200])
        else:
            raise RuntimeError(
                f"every candidate checkpoint failed to restore "
                f"({candidates})")
        trainer.training_state = TrainingState.RECOVERING
        self.rollbacks += 1
        self.rollback_steps.append(trainer.global_step)
        self._bad_streak = 0
        self._counters.inc(action="rollback")
        if self.obs is not None:
            self.obs.trace.emit(EventType.SUPERVISOR_ROLLBACK, step=bad_step,
                                restored_step=trainer.global_step)
            self.obs.dump_flight(
                "rollback", step=trainer.global_step,
                directory=trainer.config.checkpoint_dir,
                extra={"bad_step": bad_step,
                       "restored_step": trainer.global_step,
                       "rollbacks": self.rollbacks,
                       "retries": self.retries,
                       "bad_steps": self.bad_steps})

    # -- restart loop ------------------------------------------------------

    def run(self, train_dataloader, val_dataloader=None,
            num_epochs: Optional[int] = None) -> Dict[str, Any]:
        """``DistributedTrainer.train`` with the survival ladder; the
        result gains a ``"supervisor"`` report.  A verified checkpoint
        exists before the first step, so a rollback always has a
        target."""
        trainer = self.trainer
        if num_epochs is None:
            num_epochs = trainer.config.num_epochs
        if trainer.state is None:
            trainer.initialize()
        trainer.training_state = TrainingState.TRAINING
        # The rollback floor, re-checked: the save itself can die before
        # COMMIT, and one retry rewrites the uncommitted remnants.
        for _ in range(2):
            if trainer.checkpointer.latest_step() is not None:
                break
            trainer.save_checkpoint()
            trainer.checkpointer.wait()
        else:
            if trainer.checkpointer.latest_step() is None:
                raise RuntimeError(
                    "could not establish an initial verified checkpoint "
                    f"under {trainer.config.checkpoint_dir}")
        self._install_signals()
        history: List[Dict[str, Any]] = []
        epoch = 0
        try:
            while epoch < num_epochs:
                try:
                    avg_loss = trainer.train_epoch(train_dataloader, epoch)
                except (SimulatedPreemption, PreemptionSignal) as exc:
                    self.preemptions += 1
                    self._counters.inc(action="preemption")
                    logger.warning("Supervisor: preemption during epoch %d "
                                   "(%s): saving state", epoch, exc)
                    # The signal came before the pending step ran: align
                    # the label with the state, or the save would take the
                    # next step's slot.
                    trainer.global_step = int(trainer.state.step)
                    if self.obs is not None:
                        self.obs.trace.emit(EventType.PREEMPTION,
                                            step=trainer.global_step,
                                            epoch=epoch)
                    trainer.save_checkpoint()
                    trainer.checkpointer.wait()
                    if self.obs is not None:
                        self.obs.dump_flight(
                            "preemption", step=trainer.global_step,
                            directory=trainer.config.checkpoint_dir)
                    if self.restarts >= self.max_restarts:
                        raise RuntimeError(
                            f"restart budget exhausted ({self.max_restarts})"
                            f"; last preemption: {exc}") from exc
                    self.restarts += 1
                    self._counters.inc(action="restart")
                    trainer.load_checkpoint()
                    if self.obs is not None:
                        self.obs.trace.emit(EventType.SUPERVISOR_RESTART,
                                            step=trainer.global_step,
                                            restart=self.restarts)
                    logger.info("Supervisor: auto-resume %d/%d from step %d",
                                self.restarts, self.max_restarts,
                                trainer.global_step)
                    # The interrupted epoch re-runs from its first batch;
                    # the restored step counter keeps fault events
                    # fire-once and the checkpoint cadence consistent.
                    continue
                record = {"epoch": epoch, "train_loss": avg_loss}
                if val_dataloader is not None:
                    record["val_loss"] = trainer.validate(val_dataloader)
                if trainer.training_state in (TrainingState.UNDER_ATTACK,
                                              TrainingState.RECOVERING):
                    trainer.training_state = TrainingState.TRAINING
                history.append(record)
                epoch += 1
        finally:
            self._restore_signals()
        trainer.training_state = TrainingState.COMPLETED
        return {"epochs": history, "stats": trainer.get_training_stats(),
                "supervisor": self.report()}

    def report(self) -> Dict[str, Any]:
        """Survival counters, keyed to match ``FaultPlan.predict``."""
        out: Dict[str, Any] = {
            "retries": self.retries,
            "rollbacks": self.rollbacks,
            "rollback_steps": list(self.rollback_steps),
            "restarts": self.restarts,
            "preemptions": self.preemptions,
            "bad_steps": self.bad_steps,
        }
        injector = self.chaos or self.trainer.chaos
        if injector is not None:
            counts = injector.counts()
            out["faults_fired"] = counts
            out["dropped_batches"] = counts.get("data_loss", 0)
            out["stalls"] = counts.get("stall", 0)
        # What is anomalous or burning budget NOW, beside the lifetime
        # counters.
        if self.obs is not None:
            if self.obs.anomaly is not None:
                out["anomalies_active"] = self.obs.anomaly.active
                out["anomaly_events"] = self.obs.anomaly.event_total
            if self.obs.slo is not None:
                out["slo_breaches_active"] = self.obs.slo.active
                out["slo_breach_total"] = self.obs.slo.breach_total
        return out

    # -- signals -----------------------------------------------------------

    def _install_signals(self) -> None:
        if not self.handle_signals:
            return
        import signal

        def handler(signum, frame):
            logger.warning("Supervisor: received signal %d: will "
                           "checkpoint and resume", signum)
            self._preempt_flag = True

        try:
            self._old_handler = signal.signal(signal.SIGTERM, handler)
        except ValueError:  # not the main thread
            logger.warning("Supervisor: cannot install a SIGTERM handler "
                           "outside the main thread")
            self._old_handler = None

    def _restore_signals(self) -> None:
        if self._old_handler is None:
            return
        import signal

        signal.signal(signal.SIGTERM, self._old_handler)
        self._old_handler = None


__all__ = ["PreemptionSignal", "TrainingSupervisor"]
