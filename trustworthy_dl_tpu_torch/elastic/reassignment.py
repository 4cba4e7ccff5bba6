"""Elastic eviction and readmission of logical nodes on one card.

Counterpart of ``trustworthy_dl_tpu/elastic/reassignment.py`` in data
mode, the JAX package's "dev mode": logical nodes share the device, so no
device leaves or returns.  An eviction narrows the node axis:

1. every per-node row of the training world-view (trust, detector
   baselines, verifier, monitor, suspect flags, clean streaks;
   ``PER_NODE_FIELDS``) is compacted to the surviving coordinates on the
   card (``compact_train_state``); params and optimizer state are
   node-replicated and stay where they are;
2. the train and eval steps are rebuilt for the new node count (the
   step's node loop reads ``config.num_nodes``), and the attack plan's
   mask is compacted with the rows;
3. the surgery is timed between two ``torch.cuda.synchronize()`` calls,
   and the record keeps JAX's keys: ``migration_time_s``, ``bytes_moved``
   (the bytes of the rebuilt per-node rows, the state this eviction
   wrote) and ``measured_gbps``, which replaces ``migration_gbps`` for
   later estimates.  ``new_device_count`` is 1.

A readmission appends fresh probation rows (``expand_train_state``: trust
0.5, RECOVERING, recovery rate 0.02, empty baselines, verifier and
monitor) and rebuilds the attack mask from the original identities, so a
node still in the attack's target set attacks again and is evicted again.

Host bookkeeping keeps original node ids throughout: ``trainer.node_map``
maps a coordinate to its id.  A pipeline stage is not evicted here: it
restaffs (``restaff.py``) and returns through the restaff's idle pool.
The tensor, sequence, expert and hybrid modes wait for ROADMAP Slice 4b.
The trainer emits ``elastic_evict`` and ``elastic_readmit`` trace events
after each transition, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, Sequence

import torch

from trustworthy_dl_tpu_torch.engine.state import MonitorState, TrainState
from trustworthy_dl_tpu_torch.trust.state import METRIC_DEFAULTS, \
    NodeStatus

logger = logging.getLogger(__name__)

#: TrainState fields whose tensors carry a per-node leading axis: the one
#: list that compaction, expansion and the byte count walk.
PER_NODE_FIELDS = ("trust", "out_baseline", "grad_baseline", "verifier",
                   "monitor", "prev_suspects", "clean_streak")

#: Modes with elastic eviction on one card.  JAX's group modes (tensor,
#: sequence, expert, hybrid) wait for ROADMAP Slice 4b.
ELASTIC_MODES = ("data",)


def _refuse_mode(config: Any, what: str) -> None:
    if config.parallelism == "model":
        # JAX's routing: a compromised stage restaffs instead.
        raise NotImplementedError(
            f"elastic {what} supports {ELASTIC_MODES}; a compromised "
            "pipeline stage restaffs instead and re-enters through the "
            "restaff idle pool (elastic/restaff.py)")
    if config.parallelism not in ELASTIC_MODES:
        raise NotImplementedError(
            f"elastic {what} in parallelism={config.parallelism!r} is not "
            "ported yet (ROADMAP Slice 4b: the group modes of elastic/); "
            "the port evicts in 'data' mode")


def _per_node_tensors(state: TrainState):
    """Every per-node tensor of the state, the trust threshold (a scalar)
    excepted."""
    for name in PER_NODE_FIELDS:
        value = getattr(state, name)
        if isinstance(value, torch.Tensor):
            yield value
            continue
        for key, leaf in zip(value._fields, value):
            if key != "threshold":
                yield leaf


def _per_node_bytes(state: TrainState) -> int:
    return sum(t.numel() * t.element_size()
               for t in _per_node_tensors(state))


def _map_rows(state: TrainState, fn) -> TrainState:
    """``fn`` over every per-node tensor, the NamedTuples rebuilt."""
    out = {}
    for name in PER_NODE_FIELDS:
        value = getattr(state, name)
        if isinstance(value, torch.Tensor):
            out[name] = fn(value)
        else:
            out[name] = value._replace(**{
                key: fn(leaf) for key, leaf in zip(value._fields, value)
                if key != "threshold"})
    return state._replace(**out)


def compact_train_state(state: TrainState, keep: Sequence[int]
                        ) -> TrainState:
    """The per-node rows of the surviving coordinates; params, optimizer
    state and the fleet-level fields pass through."""
    device = state.prev_suspects.device
    idx = torch.tensor(list(keep), dtype=torch.long, device=device)
    return _map_rows(state, lambda leaf: leaf.index_select(0, idx))


def expand_train_state(state: TrainState, num_new: int, now: float,
                       decay_rate: float, readmit_trust: float = 0.5
                       ) -> TrainState:
    """``num_new`` fresh rows appended to every per-node tensor, on
    probation: trust ``readmit_trust``, RECOVERING, the boosted 0.02
    recovery rate (``initiate_recovery``'s), the trust clock at ``now``,
    default metrics, empty detector baselines, verifier and monitor (a
    fresh warm-up: their old history described a poisoned node), no
    suspicion carried over."""
    r = num_new

    def app(leaf: torch.Tensor, fill: float = 0) -> torch.Tensor:
        fresh = torch.full((r,) + tuple(leaf.shape[1:]), fill,
                           dtype=leaf.dtype, device=leaf.device)
        return torch.cat([leaf, fresh])

    trust = state.trust
    defaults = torch.tensor(METRIC_DEFAULTS, dtype=trust.metrics.dtype,
                            device=trust.metrics.device)
    trust = trust._replace(
        scores=app(trust.scores, readmit_trust),
        status=app(trust.status, int(NodeStatus.RECOVERING)),
        update_count=app(trust.update_count),
        last_updated=app(trust.last_updated, now),
        decay_rate=app(trust.decay_rate, decay_rate),
        recovery_rate=app(trust.recovery_rate, 0.02),
        metrics=torch.cat([trust.metrics, defaults.repeat(r, 1)]),
        attack_count=app(trust.attack_count))
    out_bl, grad_bl = state.out_baseline, state.grad_baseline
    verifier, mon = state.verifier, state.monitor
    return state._replace(
        trust=trust,
        out_baseline=out_bl._replace(ring=app(out_bl.ring),
                                     count=app(out_bl.count)),
        grad_baseline=grad_bl._replace(ring=app(grad_bl.ring),
                                       count=app(grad_bl.count)),
        verifier=verifier._replace(count=app(verifier.count),
                                   mean=app(verifier.mean),
                                   m2=app(verifier.m2)),
        monitor=MonitorState(count=app(mon.count),
                             out_mean_avg=app(mon.out_mean_avg),
                             out_std_avg=app(mon.out_std_avg),
                             grad_norm_avg=app(mon.grad_norm_avg)),
        prev_suspects=app(state.prev_suspects),
        clean_streak=app(state.clean_streak))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evict_and_reshard(trainer: Any, drop: Sequence[int]) -> Dict[str, Any]:
    """Evict the current coordinates ``drop`` (the trainer translates
    original ids), compact the state, rebuild the steps; returns the
    timed record."""
    config = trainer.config
    _refuse_mode(config, "eviction")
    n = config.num_nodes
    drop = sorted({int(d) for d in drop})
    keep = [i for i in range(n) if i not in drop]
    if not keep:
        raise ValueError("cannot evict every node")
    device = trainer.state.prev_suspects.device
    # The steps in flight finish before the rows they write are dropped.
    _sync(device)
    t0 = time.perf_counter()
    for i in drop:
        # No device leaves the single card (JAX's dev mode): nothing to
        # hand back on readmission.
        trainer._evicted_devices[trainer.node_map[i]] = []
    new_state = compact_train_state(trainer.state, keep)
    _sync(device)
    migration_time = time.perf_counter() - t0
    bytes_moved = _per_node_bytes(new_state)
    measured_gbps = bytes_moved / max(migration_time, 1e-9) / 1024 ** 3

    trainer._rebuild_steps(dataclasses.replace(config, num_nodes=len(keep)))
    trainer.state = new_state
    plan = trainer.attack_plan
    trainer.attack_plan = plan._replace(target_mask=plan.target_mask[
        torch.tensor(keep, dtype=torch.long, device=plan.target_mask.device)])
    evicted_ids = [trainer.node_map[i] for i in drop]
    trainer.node_map = [trainer.node_map[i] for i in keep]
    # The measured rate replaces the configured guess for later estimates.
    trainer.config = dataclasses.replace(
        trainer.config, migration_gbps=max(measured_gbps, 1e-3))
    record = {
        "evicted_nodes": evicted_ids,
        "surviving_nodes": list(trainer.node_map),
        "migration_time_s": migration_time,
        "bytes_moved": bytes_moved,
        "measured_gbps": measured_gbps,
        "new_device_count": 1,
        "timestamp": time.time(),
    }
    logger.warning(
        "Elastic eviction: nodes %s removed; %d coordinates remain on 1 "
        "device; %.3f MB of per-node rows rebuilt in %.6f s (%.3f GB/s)",
        evicted_ids, len(keep), bytes_moved / 2 ** 20, migration_time,
        measured_gbps)
    return record


def readmit_and_reshard(trainer: Any, node_ids: Sequence[int]
                        ) -> Dict[str, Any]:
    """Readmit the evicted original ids ``node_ids``: probation rows
    appended (:func:`expand_train_state`), the steps rebuilt, the attack
    mask rebuilt from the original identities."""
    config = trainer.config
    _refuse_mode(config, "readmission")
    node_ids = [int(i) for i in node_ids]
    unknown = [i for i in node_ids if i not in trainer._evicted_devices]
    if unknown:
        raise ValueError(f"nodes {unknown} were never evicted")
    n_new = config.num_nodes + len(node_ids)
    device = trainer.state.prev_suspects.device
    _sync(device)
    t0 = time.perf_counter()
    new_state = expand_train_state(
        trainer.state, len(node_ids),
        now=float(trainer.state.step) * config.time_per_step,
        decay_rate=config.trust_decay_rate)
    _sync(device)
    migration_time = time.perf_counter() - t0

    trainer._rebuild_steps(dataclasses.replace(config, num_nodes=n_new))
    trainer.state = new_state
    trainer.node_map = list(trainer.node_map) + node_ids
    bits = [bool(trainer._plan_bits.get(nid, False))
            for nid in trainer.node_map]
    trainer.attack_plan = trainer.attack_plan._replace(
        target_mask=torch.tensor(bits, dtype=torch.bool,
                                 device=trainer.attack_plan.target_mask
                                 .device))
    for nid in node_ids:
        trainer._evicted_devices.pop(nid, None)
        trainer._evicted_at.pop(nid, None)
        trainer._open_incidents.discard(nid)
        trainer.trust_manager.initiate_recovery(nid)
    record = {
        "readmitted_nodes": node_ids,
        "all_nodes": list(trainer.node_map),
        "migration_time_s": migration_time,
        "new_device_count": 1,
        "timestamp": time.time(),
    }
    logger.warning("Elastic readmission: nodes %s restored on probation; "
                   "%d coordinates on 1 device", node_ids, n_new)
    return record


__all__ = ["ELASTIC_MODES", "PER_NODE_FIELDS", "compact_train_state",
           "evict_and_reshard", "expand_train_state", "readmit_and_reshard"]
