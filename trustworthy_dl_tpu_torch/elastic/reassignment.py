"""Elastic eviction and readmission of logical nodes on one card.

Counterpart of ``trustworthy_dl_tpu/elastic/reassignment.py``.  The node
axis is the mesh's data axis, with one position (data mode) or a group of
positions (the group modes: tensor, sequence, expert, hybrid) a node, or
every node on the same positions (JAX's "dev mode", the port's default
one-position mesh).  An eviction narrows the node axis:

1. the evicted node's positions leave the mesh (:func:`node_device_group`,
   :func:`surviving_devices`; none in dev mode), and the mesh is rebuilt
   over the survivors (``core.mesh.build_mesh``; a hybrid ``mesh_shape``
   keeps its other extents, :func:`elastic_mesh_shape`);
2. every per-node row of the training world-view (trust, detector
   baselines, verifier, monitor, suspect flags, clean streaks;
   ``PER_NODE_FIELDS``) is compacted to the surviving coordinates
   (``compact_train_state``) and the state moves onto the new mesh
   (:func:`migrate_state`: on one card every position is the card, so
   nothing moves); params and optimizer state are node-replicated;
3. the mode's mesh is bound again and the layout recomputed through the
   trainer's one spec function (:func:`_reapply_mode_shardings`), the
   train and eval steps rebuilt for the new node count, and the attack
   plan's mask compacted with the rows;
4. the surgery is timed between two ``torch.cuda.synchronize()`` calls,
   and the record keeps JAX's keys: ``migration_time_s``, ``bytes_moved``
   (the bytes of the rebuilt per-node rows, the state this eviction
   wrote) and ``measured_gbps``, which replaces ``migration_gbps`` for
   later estimates.  ``new_device_count`` counts the new mesh's
   positions (1 on the default one-position mesh).

A readmission returns the node's positions to the mesh, appends fresh
probation rows (``expand_train_state``: trust 0.5, RECOVERING, recovery
rate 0.02, empty baselines, verifier and monitor) and rebuilds the attack
mask from the original identities, so a node still in the attack's target
set attacks again and is evicted again.

Host bookkeeping keeps original node ids throughout: ``trainer.node_map``
maps a coordinate to its id.  A pipeline stage is not evicted here: it
restaffs (``restaff.py``) and returns through the restaff's idle pool.  A
hybrid layout qualifies when ``mesh_shape``'s data extent is the node
count within one slice and without a stage axis
(:func:`elastic_supported`).  The trainer emits ``elastic_evict`` and
``elastic_readmit`` trace events after each transition, as in JAX.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, Mesh, \
    bind_mode_mesh, build_mesh
from trustworthy_dl_tpu_torch.core.sharding import row_placer
from trustworthy_dl_tpu_torch.engine.state import MonitorState, TrainState, \
    fleet_scalar_fields
from trustworthy_dl_tpu_torch.trust.state import METRIC_DEFAULTS, \
    NodeStatus
from trustworthy_dl_tpu_torch.utils.tree import map_tree

logger = logging.getLogger(__name__)

#: TrainState fields whose tensors carry a per-node leading axis: the one
#: list that compaction, expansion and the byte count walk.
PER_NODE_FIELDS = ("trust", "out_baseline", "grad_baseline", "verifier",
                   "monitor", "prev_suspects", "clean_streak")

#: Modes with mode-agnostic eviction and readmission (JAX's): the node
#: axis is the data axis, so removing a node removes its whole group.
#: Pipeline ("model") restaffs instead (elastic/restaff.py).
ELASTIC_MODES = ("data", "tensor", "sequence", "expert", "hybrid")


def _check_hybrid_elastic(config: Any) -> None:
    """Hybrid elasticity's preconditions, JAX's: ``mesh_shape``'s data
    extent IS the node count, within one slice, without a stage axis."""
    ms = config.mesh_shape or {}
    if (config.dcn_mesh_shape or ms.get("stage", 1) > 1
            or ms.get("data", 1) != config.num_nodes):
        raise NotImplementedError(
            "hybrid elasticity requires mesh_shape['data'] == num_nodes "
            "within one slice (no dcn_mesh_shape, no stage axis); got "
            f"mesh_shape={ms}, dcn={config.dcn_mesh_shape}")


def elastic_supported(config: Any) -> bool:
    """Can :func:`evict_and_reshard` handle this config?  The trainer's
    gates use this, so an ineligible hybrid layout keeps the in-step
    gating and the greedy hand-off instead of failing mid-run."""
    if config.parallelism not in ELASTIC_MODES:
        return False
    if config.parallelism == "hybrid":
        try:
            _check_hybrid_elastic(config)
        except NotImplementedError:
            return False
    return True


def elastic_mesh_shape(config: Any, n: int) -> Optional[Dict[str, int]]:
    """``mesh_shape`` of a rebuilt mesh whose data axis carries ``n``
    nodes: hybrid keeps its other extents; the single-axis modes pass
    theirs through (``build_mesh`` derives the groups)."""
    if config.parallelism != "hybrid":
        return config.mesh_shape
    return {**(config.mesh_shape or {}), "data": n}


def node_device_group(mesh: Mesh, num_nodes: int, coord: int
                      ) -> List[torch.device]:
    """The positions node ``coord`` owns: its one position in
    one-a-node data mode, its group row in the group modes, none in dev
    mode (the nodes share every position)."""
    devices = np.asarray(mesh.devices)
    if devices.size == num_nodes:
        return [devices.flat[coord]]
    if devices.ndim >= 1 and devices.shape[0] == num_nodes:
        return list(devices[coord].flat)
    return []


def surviving_devices(mesh: Mesh, num_nodes: int, drop: Sequence[int]
                      ) -> List[torch.device]:
    """The positions after evicting node coordinates ``drop``: an
    evicted node's own positions leave (row-major order kept); in dev
    mode the position set is unchanged and only the node axis
    narrows."""
    devices = np.asarray(mesh.devices)
    dropped = set(drop)
    if devices.size == num_nodes:
        return [d for i, d in enumerate(devices.flat) if i not in dropped]
    if devices.ndim >= 1 and devices.shape[0] == num_nodes:
        return [d for i in range(num_nodes) if i not in dropped
                for d in devices[i].flat]
    return list(devices.flat)


def migrate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place a (compacted or expanded) state onto ``mesh``, as JAX's
    does: the per-node rows through ``core.sharding.row_placer``, the
    params, optimizer state, fleet-alarm fields
    (``engine.state.fleet_scalar_fields``) and canary replicated (on one
    card both rules land on the card, so nothing moves; a mesh of
    several devices is refused).  Which leaves shard is the layout's
    business (:func:`_reapply_mode_shardings` recomputes it), not the
    tensors'."""
    n = int(state.prev_suspects.shape[0])
    place_row = row_placer(mesh, DATA_AXIS, n)
    place = shreg.replicated_placer(mesh)

    def move(value: Any, place: Any = place) -> Any:
        if isinstance(value, torch.Tensor):
            return place(value)
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            return type(value)(*(move(v, place) for v in value))
        if isinstance(value, (dict, list)):
            return map_tree(place, value)
        return value

    per_node = {k: move(getattr(state, k), place_row)
                for k in PER_NODE_FIELDS}
    shared = {k: move(v) for k, v in dict(
        params=state.params, opt_state=state.opt_state,
        canary=state.canary, **fleet_scalar_fields(state)).items()}
    return state._replace(**per_node, **shared)


def _reapply_mode_shardings(trainer: Any) -> None:
    """The mode's placement after a mesh rebuild: the sequence and expert
    meshes bound again (``core.mesh.bind_mode_mesh``), and the layout of
    the params and optimizer state recomputed on the new mesh through
    the trainer's one spec function (the TP layout in tensor mode and in
    hybrid with a ``model`` axis, ``core.sharding.tp_owns_params``, JAX's
    ``_tp_placement_owns_params``; ZeRO/FSDP in data mode)."""
    bind_mode_mesh(trainer.mesh, trainer.config.parallelism)
    trainer._lay_out()


def _refuse_mode(config: Any, what: str) -> None:
    if config.parallelism not in ELASTIC_MODES:
        # JAX's routing: a compromised stage restaffs instead.
        raise NotImplementedError(
            f"elastic {what} supports {ELASTIC_MODES}; a compromised "
            "pipeline stage restaffs instead and re-enters through the "
            "restaff idle pool (elastic/restaff.py)")
    if config.parallelism == "hybrid":
        _check_hybrid_elastic(config)


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
    original ids): their positions leave the mesh, the state is compacted
    and migrated, the layout and steps rebuilt; returns the timed
    record."""
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
        # Each evicted node's positions, for a readmission to return.
        trainer._evicted_devices[trainer.node_map[i]] = node_device_group(
            trainer.mesh, n, i)
    new_devices = surviving_devices(trainer.mesh, n, drop)
    new_shape = elastic_mesh_shape(config, len(keep))
    new_mesh = build_mesh(len(keep), config.parallelism, new_shape,
                          devices=new_devices, device=device)
    new_state = migrate_state(compact_train_state(trainer.state, keep),
                              new_mesh)
    _sync(device)
    migration_time = time.perf_counter() - t0
    bytes_moved = _per_node_bytes(new_state)
    measured_gbps = bytes_moved / max(migration_time, 1e-9) / 1024 ** 3

    trainer.mesh = new_mesh
    trainer._rebuild_steps(dataclasses.replace(
        config, num_nodes=len(keep), mesh_shape=new_shape))
    trainer.state = new_state
    _reapply_mode_shardings(trainer)
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
        "new_device_count": len(new_devices),
        "timestamp": time.time(),
    }
    logger.warning(
        "Elastic eviction: nodes %s removed; %d coordinates remain on %d "
        "position(s); %.3f MB of per-node rows rebuilt in %.6f s (%.3f "
        "GB/s)", evicted_ids, len(keep), len(new_devices),
        bytes_moved / 2 ** 20, migration_time, measured_gbps)
    return record


def readmit_and_reshard(trainer: Any, node_ids: Sequence[int]
                        ) -> Dict[str, Any]:
    """Readmit the evicted original ids ``node_ids``: their positions
    return to the mesh, probation rows are appended
    (:func:`expand_train_state`), the layout and steps rebuilt, the
    attack mask rebuilt from the original identities."""
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
    devices = list(trainer.mesh.devices.flat)
    for nid in node_ids:
        # The node's whole group returns (none in dev mode).
        devices.extend(trainer._evicted_devices.get(nid) or [])
    new_shape = elastic_mesh_shape(config, n_new)
    new_mesh = build_mesh(n_new, config.parallelism, new_shape,
                          devices=devices, device=device)
    new_state = migrate_state(expand_train_state(
        trainer.state, len(node_ids),
        now=float(trainer.state.step) * config.time_per_step,
        decay_rate=config.trust_decay_rate), new_mesh)
    _sync(device)
    migration_time = time.perf_counter() - t0

    trainer.mesh = new_mesh
    trainer._rebuild_steps(dataclasses.replace(
        config, num_nodes=n_new, mesh_shape=new_shape))
    trainer.state = new_state
    _reapply_mode_shardings(trainer)
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
        "new_device_count": len(devices),
        "timestamp": time.time(),
    }
    logger.warning("Elastic readmission: nodes %s restored on probation; "
                   "%d coordinates on %d position(s)", node_ids, n_new,
                   len(devices))
    return record


__all__ = ["ELASTIC_MODES", "PER_NODE_FIELDS", "compact_train_state",
           "elastic_mesh_shape", "elastic_supported", "evict_and_reshard",
           "expand_train_state", "migrate_state", "node_device_group",
           "readmit_and_reshard", "row_placer", "surviving_devices"]
