"""Fault injector: executes a ``FaultPlan`` at explicit hook points.

Counterpart of the training and checkpoint half of
``trustworthy_dl_tpu/chaos/injector.py``.  Hook points, all on the host:

* ``DistributedTrainer.train_epoch``: :meth:`FaultInjector.on_batch`
  (data-iterator failures), :meth:`~FaultInjector.on_step_start` (stalls,
  preemption signals), :meth:`~FaultInjector.on_step_end` (state
  corruption, so every later loss is genuinely non-finite);
* ``CheckpointManager``: :meth:`~FaultInjector.on_checkpoint_commit`
  (crash before the COMMIT marker), :meth:`~FaultInjector.on_checkpoint_saved`
  (bit-rot of a committed payload);
* ``serve.ServingEngine``: :meth:`~FaultInjector.on_serve_retire` (a
  poisoned request's output signals, before the monitor scores them);
* ``serve.ServingFleet``: :meth:`~FaultInjector.on_fleet_tick` (the
  fleet-granularity events due at a tick, whose mechanics the fleet
  applies) and :meth:`~FaultInjector.on_flag_observed` (a replica's public
  flag rate after each scored retirement, the adaptive attacker's
  feedback).

Each event fires exactly once (``fired``), so when the supervisor rolls
global steps back past a fired event the replayed steps run clean.
``counts()`` reports fired events by kind for the supervisor's report,
and with ``trace`` (an obs ``TraceBus``) every fired fault is a
``chaos_fault`` event, so a flight dump can be diffed against
``FaultPlan.predict``.

The serve hook's compromises, in JAX's order: an active ADAPTER_POISON on
the request's adapter, then an adaptive or a plain replica compromise of
the retiring engine's replica, then a SERVE_POISON event of the plan at
the request id (replica-gated).  The persistent states are armed by
``on_fleet_tick``: REPLICA_POISON and ADAPTER_POISON here, and a
REPLICA_ADAPTIVE_POISON activates the attached adversary
(``chaos.adversary.AdaptivePoisonAttacker``; the event firing without one,
or with one configured for another replica, raises JAX's ``ValueError``).
:meth:`~FaultInjector.heal_replica` and :meth:`~FaultInjector.heal_adapter`
are the operator's clears.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from trustworthy_dl_tpu_torch.chaos.plan import FLEET_KINDS, FaultEvent, \
    FaultKind, FaultPlan
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, \
    tree_unflatten

logger = logging.getLogger(__name__)


class SimulatedPreemption(Exception):
    """Raised at a PREEMPT event's hook point, standing in for the
    termination notice a preemptible host receives.  The supervisor
    catches it, checkpoints and resumes."""


class FaultInjector:
    """Consumes a :class:`FaultPlan`; one instance per run.  ``sleep_fn``
    is injectable so tests run STALL events without wall-clock cost;
    ``max_stall_s`` caps a stall.  ``adversary`` is the
    ``AdaptivePoisonAttacker`` a REPLICA_ADAPTIVE_POISON event activates."""

    def __init__(self, plan: FaultPlan,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 max_stall_s: float = 30.0, adversary: Any = None):
        self.plan = plan
        self.adversary = adversary
        self._sleep = sleep_fn
        self._max_stall_s = max_stall_s
        self.fired: List[FaultEvent] = []
        self.trace: Any = None
        # Replicas with an active REPLICA_POISON (replica -> severity): the
        # event fires once, the compromise lasts until heal_replica.
        self._poisoned_replicas: Dict[int, float] = {}
        # The adaptive counterpart: replica -> the attached adversary,
        # armed by a REPLICA_ADAPTIVE_POISON event.  It owns the
        # corruption and its strength controller; the fleet feeds the
        # replica's public flag rate back through on_flag_observed.
        self._adaptive_replicas: Dict[int, Any] = {}
        # Adapters with an active ADAPTER_POISON (adapter id -> severity),
        # replica-blind: every request retiring under the adapter.
        self._poisoned_adapters: Dict[str, float] = {}

    # -- bookkeeping -------------------------------------------------------

    def _fire(self, event: FaultEvent, at_step: int) -> FaultEvent:
        self.fired.append(event)
        if self.trace is not None:
            from trustworthy_dl_tpu_torch.obs.events import EventType

            self.trace.emit(EventType.CHAOS_FAULT, step=at_step,
                            kind=event.kind.value,
                            scheduled_step=event.step,
                            severity=event.severity,
                            target=(event.target if event.target >= 0
                                    else None),
                            **({"tenant": event.tenant}
                               if event.tenant else {}))
        return event

    def _take_at(self, step: int, kind: FaultKind) -> Optional[FaultEvent]:
        """Fire-once event scheduled exactly at ``step``."""
        for event in self.plan.at(step, kind):
            if event not in self.fired:
                return self._fire(event, step)
        return None

    def _take_due(self, step: int, kind: FaultKind) -> Optional[FaultEvent]:
        """Fire-once event whose schedule step has been reached (the
        checkpoint kinds fire on the first save at or after it)."""
        for event in self.plan.of_kind(kind):
            if event.step <= step and event not in self.fired:
                return self._fire(event, step)
        return None

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for event in self.fired:
            out[event.kind.value] = out.get(event.kind.value, 0) + 1
        return out

    # -- trainer hooks -----------------------------------------------------

    def on_batch(self, step: int, batch: Any) -> Optional[Any]:
        """DATA_LOSS: the batch for this step is lost; None makes the
        trainer skip it without counting a step."""
        if self._take_at(step, FaultKind.DATA_LOSS) is not None:
            logger.warning("chaos: data-iterator failure at step %d "
                           "(batch dropped)", step)
            return None
        return batch

    def on_step_start(self, step: int) -> None:
        """STALL: block the host like a straggling peer (capped).
        PREEMPT: raise the simulated preemption signal."""
        stall = self._take_at(step, FaultKind.STALL)
        if stall is not None:
            seconds = min(float(stall.severity), self._max_stall_s)
            logger.warning("chaos: host stall %.2fs at step %d", seconds,
                           step)
            self._sleep(seconds)
        if self._take_at(step, FaultKind.PREEMPT) is not None:
            logger.warning("chaos: simulated preemption at step %d", step)
            raise SimulatedPreemption(f"preempted at step {step}")

    def on_step_end(self, step: int, state: Any, metrics: Any
                    ) -> Tuple[Any, Any]:
        """GRAD_NAN: NaN the largest parameter leaf after this step
        commits, so every later step's gradients are non-finite and the
        in-step gate freezes the params: only a rollback recovers."""
        if self._take_at(step, FaultKind.GRAD_NAN) is not None:
            logger.warning("chaos: corrupting params with NaN after "
                           "step %d", step)
            state = state._replace(params=_corrupt_largest_leaf(state.params))
        return state, metrics

    # -- checkpoint hooks --------------------------------------------------

    def on_checkpoint_commit(self, step: int) -> bool:
        """CKPT_CRASH: False simulates dying between the payload write and
        the COMMIT marker; the save stays uncommitted."""
        if self._take_due(step, FaultKind.CKPT_CRASH) is not None:
            logger.warning("chaos: simulated crash before COMMIT of "
                           "checkpoint step %d", step)
            return False
        return True

    def on_checkpoint_saved(self, step: int, path: str) -> None:
        """CKPT_CORRUPT: flip bytes in the committed payload's largest
        file, so its manifest checksum no longer matches."""
        if self._take_due(step, FaultKind.CKPT_CORRUPT) is None:
            return
        target = _largest_file(path)
        if target is None:
            logger.warning("chaos: no payload file to corrupt in %s", path)
            return
        logger.warning("chaos: corrupting checkpoint file %s (step %d)",
                       target, step)
        corrupt_file(target)


    # -- serving hooks -------------------------------------------------------

    def _poison_signals(self, task: Any, severity: float) -> None:
        """A collapsed-entropy, inflated-margin profile: a poisoned replica
        looping on one token."""
        n = max(len(task.entropies), 1)
        task.entropies[:] = [0.0] * n
        task.margins[:] = [1e3 * float(severity)] * n

    def on_serve_retire(self, task: Any,
                        replica: Optional[int] = None) -> None:
        """Overwrite a retiring request's output signals when a compromise
        covers it, so the engine's monitor must flag it and quarantine its
        slot.  ``replica`` is the engine's ``replica_id`` (None
        standalone).  Checked in order: an active ADAPTER_POISON on the
        task's adapter (first, so the flag lands in the adapter's window
        whatever replica hosted it); an adaptive compromise of this replica
        (delegated to the attacker); a REPLICA_POISON of this replica; then
        the plan's SERVE_POISON event at this request id, whose target,
        when set, must be this replica (request ids are replica-local)."""
        if self._poisoned_adapters:
            adapter = getattr(task, "adapter", None)
            severity = (self._poisoned_adapters.get(adapter)
                        if adapter is not None else None)
            if severity is not None:
                self._poison_signals(task, severity)
                return
        key = -1 if replica is None else replica
        adversary = self._adaptive_replicas.get(key)
        if adversary is not None:
            adversary.corrupt(task)
            return
        severity = self._poisoned_replicas.get(key)
        if severity is not None:
            self._poison_signals(task, severity)
            return
        for event in self.plan.at(int(task.request_id),
                                  FaultKind.SERVE_POISON):
            if event in self.fired:
                continue
            if event.target >= 0 and event.target != replica:
                continue
            self._fire(event, int(task.request_id))
            logger.warning("chaos: poisoning serve output of request %d%s",
                           task.request_id, "" if replica is None
                           else f" on replica {replica}")
            self._poison_signals(task, event.severity)
            return

    # -- fleet hooks -------------------------------------------------------

    def on_fleet_tick(self, tick: int) -> List[FaultEvent]:
        """Fire every fleet event scheduled at or before ``tick`` (each
        once) and return them in ``FLEET_KINDS`` order; the fleet applies
        the mechanics (kill, wedge, warm-up, flood), the injector keeps
        the persistent compromises."""
        out: List[FaultEvent] = []
        for kind in FLEET_KINDS:
            for event in self.plan.of_kind(kind):
                if event.step > tick or event in self.fired:
                    continue
                self._fire(event, tick)
                if kind is FaultKind.TENANT_FLOOD:
                    # The fleet runs the burst through its admission
                    # path: the tenant's token bucket throttles what it
                    # cannot pay for, the class queues schedule the rest.
                    logger.warning(
                        "chaos: tenant flood (%d requests from %r) at "
                        "tick %d", max(int(event.severity), 1),
                        event.tenant or "flood", tick)
                    out.append(event)
                    continue
                if kind is FaultKind.ADAPTER_POISON:
                    # Artifact-addressed: the adapter id rides ``tenant``.
                    name = event.tenant or "adapter"
                    logger.warning("chaos: adapter poison on %r at tick "
                                   "%d", name, tick)
                    self._poisoned_adapters[name] = float(event.severity)
                    out.append(event)
                    continue
                logger.warning("chaos: %s on replica %d at tick %d",
                               kind.value, event.target, tick)
                if kind is FaultKind.REPLICA_POISON:
                    self._poisoned_replicas[event.target] = \
                        float(event.severity)
                elif kind is FaultKind.REPLICA_ADAPTIVE_POISON:
                    # Loud: without an attacker (or with a mis-targeted
                    # one) the drill would silently run no fault at all.
                    if self.adversary is None:
                        raise ValueError(
                            "REPLICA_ADAPTIVE_POISON fired but no "
                            "adversary is attached — build the injector "
                            "with FaultInjector(plan, adversary="
                            "AdaptivePoisonAttacker(...))")
                    if self.adversary.config.target != event.target:
                        raise ValueError(
                            f"REPLICA_ADAPTIVE_POISON targets replica "
                            f"{event.target} but the attached adversary "
                            f"is configured for replica "
                            f"{self.adversary.config.target}")
                    self._adaptive_replicas[event.target] = self.adversary
                    self.adversary.activate()
                out.append(event)
        return out

    def on_flag_observed(self, replica: int, flagged: bool,
                         flag_rate: float) -> None:
        """The fleet's feedback: ``replica``'s public flag rate after a
        scored retirement, handed to an active adaptive attacker's
        controller (a no-op without one)."""
        adversary = self._adaptive_replicas.get(replica)
        if adversary is not None:
            adversary.observe(flagged, flag_rate)

    def heal_replica(self, replica: int) -> None:
        """Operator action: clear an active REPLICA_POISON or adaptive
        compromise of ``replica``."""
        self._poisoned_replicas.pop(replica, None)
        adversary = self._adaptive_replicas.pop(replica, None)
        if adversary is not None:
            adversary.deactivate()

    def replica_poisoned(self, replica: int) -> bool:
        return (replica in self._poisoned_replicas
                or replica in self._adaptive_replicas)

    def heal_adapter(self, adapter: str) -> None:
        """Operator action: clear an active ADAPTER_POISON."""
        self._poisoned_adapters.pop(adapter, None)

    def adapter_poisoned(self, adapter: str) -> bool:
        return adapter in self._poisoned_adapters


def _corrupt_largest_leaf(params: Any) -> Any:
    """NaN-out the largest parameter leaf of a nested dict (GPT-2's tied
    embedding and head, on every step's path).  Leaves are taken in
    ``tree_leaves`` order and the first of equal sizes wins, as
    ``np.argmax`` picks it in the JAX package.  A new tensor replaces the
    leaf; the old one is not written."""
    leaves = tree_leaves(params)
    idx = int(np.argmax([leaf.numel() for leaf in leaves]))
    leaves[idx] = leaves[idx] * float("nan")
    return tree_unflatten(params, leaves)


def _largest_file(root: str) -> Optional[str]:
    best, best_size = None, -1
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            p = os.path.join(dirpath, name)
            size = os.path.getsize(p)
            if size > best_size:
                best, best_size = p, size
    return best


def corrupt_file(path: str, offset: int = 0, nbytes: int = 64) -> None:
    """Flip bytes in place (XOR 0xFF): deterministic, size-preserving
    corruption that a checksum catches and a directory listing does
    not."""
    size = os.path.getsize(path)
    if size == 0:
        with open(path, "wb") as f:
            f.write(b"\xff")
        return
    offset = min(offset, size - 1)
    nbytes = min(nbytes, size - offset)
    with open(path, "r+b") as f:
        f.seek(offset)
        chunk = f.read(nbytes)
        f.seek(offset)
        f.write(bytes(b ^ 0xFF for b in chunk))


__all__ = ["FaultInjector", "SimulatedPreemption", "corrupt_file"]
