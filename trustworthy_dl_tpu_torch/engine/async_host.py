"""Bounded in-flight dispatch with lagged host telemetry.

Counterpart of ``trustworthy_dl_tpu/engine/async_host.py``.  At
``TrainingConfig.async_host_depth`` = K > 0 the trainer dispatches step
k + 1 before it reads step k's metrics:

* each step's host-facing outputs are packed into one fresh f32 device
  vector whose device-to-host copy (to pinned memory, with an event
  recorded after it) starts at dispatch (``engine.step.HostMetricsPacker``);
* a bounded deque holds up to K steps in flight;
* the oldest entries drain through the trainer's usual host path (the
  step guard, ``_record_batch``), lagged by up to K steps, each with its
  own step number restored while it drains, so every host record equals
  the synchronous loop's.

The port updates the training state in place where JAX threads it, so
whatever a drain reads is copied into the packed vector at push time
(the post-step ``fleet_raw_streak`` included) and never read from
``trainer.state``, which is already up to K steps ahead.

Drain contract, as in the JAX package:

* checkpoint saves: the trainer drains fully before ``save_checkpoint``
  and skips the save when the frontier step was rejected, so a verified
  checkpoint always covers an accounted, guard-accepted prefix;
* epoch end and preemption: ``train_epoch`` drains fully in a
  ``finally``;
* guard trips: the lagged guard runs no in-place retry (re-running a
  K-step-old batch against the frontier state is another computation)
  and a rollback restores the newest verified checkpoint, which predates
  the window by the rule above; the rest of the window is discarded;
* elastic transitions: evictions found while draining are deferred
  (``DrainContext``) until the window has drained fully, then applied
  once at the dispatch frontier, as are readmissions whose cool-off is
  due.  The in-step trust gate has zero-weighted the node throughout.

Depth 0 does not use this module (the synchronous loop).  Drills that
assert ``FaultPlan.predict``'s exact retry counts must run at depth 0.
The trace events of a lagged step are emitted as it drains, under its own
step number; :meth:`AsyncHostPipeline.consume_rejection` tells the
trainer's step timer to discard a window in which a step was rejected.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Any, Deque, Optional, Set

from trustworthy_dl_tpu_torch.engine.step import HostMetricsPacker, \
    PackedMetrics, StepMetrics

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DrainContext:
    """Installed as ``trainer._drain_ctx`` while a lagged entry drains:
    ``_record_batch`` defers its elastic evictions into ``evict_coords``
    instead of resharding mid-window (the entries still in flight were
    packed for the old node count)."""

    evict_coords: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _InFlight:
    """One dispatched, not yet drained step."""

    step: int
    epoch: int
    batch_idx: int
    packed: PackedMetrics    # the device vector and its host copy
    packer: HostMetricsPacker
    step_s: float            # wall since the previous dispatch


class AsyncHostPipeline:
    """The bounded in-flight window of one ``train_epoch`` call.  ``push``
    packs a dispatched step and starts its host copy; ``drain`` resolves
    the oldest entries down to the depth (``drain(0)``: all of them)
    through the trainer's host path, then applies deferred topology
    changes.  ``epoch_loss`` and ``num_batches`` accumulate what the
    synchronous loop's counters would."""

    def __init__(self, trainer: Any, depth: int):
        self.trainer = trainer
        self.depth = int(depth)
        self.entries: Deque[_InFlight] = collections.deque()
        self.packer: Optional[HostMetricsPacker] = None
        self.pending_evicts: Set[int] = set()
        self.epoch_loss = 0.0
        self.num_batches = 0
        self.last_rejected_step: Optional[int] = None
        self._rejected_since_check = False

    # -- dispatch side -----------------------------------------------------

    def push(self, epoch: int, batch_idx: int, metrics: StepMetrics,
             state: Any, step_s: float) -> None:
        """Pack the step the trainer just dispatched and enqueue it;
        ``state`` is the post-step state, whose ``fleet_raw_streak`` is
        the value this step's record must see."""
        streak = state.fleet_raw_streak
        if self.packer is None or not self.packer.matches(metrics, streak):
            # First step, or the node count changed (topology changes
            # happen only at full drains, so layouts never mix).
            self.packer = HostMetricsPacker(metrics, streak)
        self.entries.append(_InFlight(
            step=self.trainer.global_step, epoch=epoch, batch_idx=batch_idx,
            packed=self.packer.pack(metrics, streak), packer=self.packer,
            step_s=step_s))

    # -- drain side --------------------------------------------------------

    def drain(self, depth: Optional[int] = None) -> None:
        """Resolve the oldest entries until at most ``depth`` (default:
        the pipeline's) remain, then apply deferred topology changes."""
        self._drain_until(self.depth if depth is None else int(depth))
        self._maybe_apply_topology()

    def consume_rejection(self) -> bool:
        """True when an entry was guard-rejected since the last check: the
        trainer then discards the frontier step's timer laps, as the
        synchronous loop does for a rejected step."""
        rejected = self._rejected_since_check
        self._rejected_since_check = False
        return rejected

    def _drain_until(self, target: int) -> None:
        while len(self.entries) > target:
            # Peek, then pop: when the guard raises mid-drain (a
            # preemption signal) the entry stays queued, so the unwinding
            # full drain still records it.
            entry = self.entries[0]
            self._drain_one(entry)
            if self.entries and self.entries[0] is entry:
                self.entries.popleft()

    def _drain_one(self, entry: _InFlight) -> None:
        """One lagged step through the host path, with its own step number
        restored."""
        trainer = self.trainer
        metrics, streak = entry.packer.unpack(entry.packed)
        frontier = trainer.global_step
        trainer.global_step = entry.step
        try:
            guard = trainer.step_guard
            # Lagged: the guard runs no in-place retry (there is no batch
            # to re-run against the frontier state).
            if guard is not None and guard.after_step(
                    trainer, None, metrics, lagged=True) is None:
                self.last_rejected_step = entry.step
                self._rejected_since_check = True
                if trainer.global_step != entry.step:
                    # Rollback: an older verified checkpoint was restored.
                    # What is still in flight ran on the abandoned
                    # timeline.
                    logger.warning(
                        "async pipeline: rollback at lagged step %d: "
                        "discarding %d in-flight step(s)", entry.step,
                        len(self.entries))
                    self.entries.clear()
                    self.pending_evicts.clear()
                    frontier = trainer.global_step
                return
            if self.last_rejected_step == entry.step:
                # The step number was rejected on an abandoned timeline;
                # this acceptance supersedes it.
                self.last_rejected_step = None
            trainer.metrics_collector.tick()
            ctx = DrainContext()
            trainer._drain_ctx = ctx
            try:
                record = trainer._record_batch(
                    trainer._host_record(metrics, streak), entry.epoch,
                    entry.step_s)
            finally:
                trainer._drain_ctx = None
            self.pending_evicts.update(ctx.evict_coords)
            self.epoch_loss += record["loss"]
            self.num_batches += 1
            if entry.batch_idx % 10 == 0:
                logger.info("Epoch %d, Batch %d, Loss: %.4f", entry.epoch,
                            entry.batch_idx, record["loss"])
        finally:
            trainer.global_step = frontier

    def _maybe_apply_topology(self) -> None:
        """Deferred elastic transitions: a full drain first, then the
        evictions and due readmissions once, at the dispatch frontier."""
        trainer = self.trainer
        if not self.pending_evicts and not trainer._readmit_due():
            return
        self._drain_until(0)  # may add evictions, or clear on a rollback
        evicts = sorted(self.pending_evicts)
        self.pending_evicts.clear()
        n = trainer.config.num_nodes
        if len(evicts) >= n:
            # Evictions gathered over the window would empty the fleet,
            # which the per-step path never asks for: keep the highest
            # coordinate (its gradients stay gated in the step).
            logger.error(
                "async pipeline: %d deferred evictions would empty the "
                "%d-node fleet; keeping coordinate %d in service",
                len(evicts), n, evicts[-1])
            evicts = evicts[:n - 1]
        if evicts:
            trainer._apply_evictions(evicts)
        trainer._maybe_readmit()


__all__ = ["AsyncHostPipeline", "DrainContext"]
