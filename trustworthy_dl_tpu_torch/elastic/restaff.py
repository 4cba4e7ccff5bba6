"""Pipeline-stage restaffing: the layer migration of model mode.

Counterpart of ``trustworthy_dl_tpu/elastic/restaff.py``.  The
reference's ``reassign_node_tasks`` promises to hand a compromised
node's layer partition to the most trusted node but only relabels a
string; here a confirmed stage leaves and the model repartitions:

1. the compromised stage coordinates leave the pipeline;
2. blocks and their optimizer moments go [S, L/S, ...] -> [S', L/S',
   ...] (:func:`restack_blocks`), S' the largest stage count <= the
   candidates that divides L: every layer, the evicted stage's included,
   keeps training;
3. the S' highest-trust candidates staff the new stages: the surviving
   stages plus the trainer's idle pool (healthy nodes an earlier restaff
   could not seat); unseated candidates park in the pool;
4. per-stage detector, verifier, monitor and canary state start afresh
   (stage k now computes another layer slice); trust rows carry over
   with their owners, and a pool node's row comes from the host
   ``TrustManager`` (TRUSTED for a parked survivor, RECOVERING at the
   0.5 floor for a cooled-off evicted identity);
5. the train and eval steps are rebuilt for S' stages.

On the port's one-card mesh every stage position is the same card, so
no device leaves or returns: the evicted ids park ``[]`` in
``_evicted_devices`` and pool entries hold ``[]`` (JAX's dev mode).  The
record keeps JAX's keys; ``new_device_count`` is 1, and the repartition
is timed between two ``torch.cuda.synchronize()`` calls.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Sequence, Tuple

import torch

from trustworthy_dl_tpu_torch.core.mesh import build_mesh
from trustworthy_dl_tpu_torch.elastic.reassignment import _sync
from trustworthy_dl_tpu_torch.engine.state import init_monitor_state
from trustworthy_dl_tpu_torch.utils.tree import map_tree, tree_leaves

logger = logging.getLogger(__name__)


def choose_stage_count(num_layers: int, max_stages: int) -> int:
    """Largest S' <= max_stages dividing num_layers (1 always does)."""
    for s in range(max_stages, 0, -1):
        if num_layers % s == 0:
            return s
    return 1


def _restack_leaf(leaf: torch.Tensor, new_stages: int) -> torch.Tensor:
    total = leaf.shape[0] * leaf.shape[1]
    return leaf.reshape((new_stages, total // new_stages)
                        + tuple(leaf.shape[2:]))


def restack_blocks(blocks: Any, new_stages: int) -> Any:
    """[S, L/S, ...] -> [S', L/S', ...] preserving layer order: the layer
    migration itself (block params and their moment mirrors alike)."""
    return map_tree(lambda leaf: _restack_leaf(leaf, new_stages), blocks)


def restack_opt_state(opt_state: Any, block_index: Sequence[int],
                      num_params: int, new_stages: int,
                      old_prefix: Tuple[int, int]) -> Any:
    """Restack every optimizer leaf that mirrors a stage-stacked block
    leaf (leading dims ``old_prefix``): in a moment list aligned with the
    ``num_params`` param leaves, the entries at ``block_index`` (their
    positions in ``tree_leaves(params)``); in Adafactor's second-moment
    list (a factored leaf holds two entries) every entry with that
    prefix, JAX's rule.  Moments are per parameter, so they follow their
    weights to the new stage exactly."""
    wanted = set(block_index)

    def restack(entries: List[torch.Tensor]) -> List[torch.Tensor]:
        aligned = len(entries) == num_params
        return [_restack_leaf(x, new_stages)
                if (not aligned or i in wanted) and x.dim() >= 2
                and tuple(x.shape[:2]) == tuple(old_prefix) else x
                for i, x in enumerate(entries)]

    return opt_state._replace(mu=restack(opt_state.mu),
                              nu=restack(opt_state.nu))


def restaff_pipeline(trainer: Any, drop: Sequence[int]) -> Dict[str, Any]:
    """Evict the current stage coordinates ``drop`` and repartition the
    model over the best-trusted candidates; returns the migration record
    (``evict_and_reshard``'s contract plus the stage counts)."""
    from trustworthy_dl_tpu_torch.detect.baseline import init_baseline_state
    from trustworthy_dl_tpu_torch.detect.stats import NUM_GRADIENT_STATS
    from trustworthy_dl_tpu_torch.detect.verifier import init_verifier_state
    from trustworthy_dl_tpu_torch.parallel.pipeline import \
        init_canary_state, make_canary
    from trustworthy_dl_tpu_torch.trust.state import METRIC_DEFAULTS

    config = trainer.config
    if config.parallelism != "model":
        raise ValueError("restaff_pipeline requires parallelism='model'")
    S = config.num_nodes
    drop = sorted({int(d) for d in drop})
    survivors = [i for i in range(S) if i not in drop]
    if not survivors:
        raise ValueError("cannot evict every stage")

    state = trainer.state
    device = state.prev_suspects.device
    # The steps in flight finish before the state they write is replaced.
    _sync(device)
    blocks = state.params["blocks"]
    lead = tree_leaves(blocks)[0]
    num_layers = lead.shape[0] * lead.shape[1]

    # Candidates: the surviving stages plus the idle pool.
    pool: Dict[int, list] = trainer._idle_pool
    trust_scores = state.trust.scores.tolist()
    candidates: List[Tuple[float, int, Any]] = [
        (float(trust_scores[c]), trainer.node_map[c], c) for c in survivors
    ] + [(trainer.trust_manager.get_trust_score(nid), nid, None)
         for nid in sorted(pool)]
    new_S = choose_stage_count(num_layers, len(candidates))

    t0 = time.perf_counter()
    # Staffing: the highest-trust candidates take the new stages, seated
    # in id order.
    ranked = sorted(candidates, key=lambda x: -x[0])
    chosen = sorted(ranked[:new_S], key=lambda x: x[1])
    chosen_keys = {(nid, coord) for _, nid, coord in chosen}
    new_pool = {nid: [] for _, nid, coord in candidates
                if (nid, coord) not in chosen_keys}
    for i in drop:
        # No device leaves the one card: nothing to bring back.
        trainer._evicted_devices[trainer.node_map[i]] = []

    # Trust rows: a stage's row carries over; a pool node's comes from
    # the host's standing.
    now = float(state.step) * config.time_per_step
    host = trainer.trust_manager.state

    def host_row(attr: str, nid: int, default: float) -> float:
        arr = getattr(host, attr)
        return arr[nid].item() if nid < arr.shape[0] else default

    def gather(field: torch.Tensor, synth) -> torch.Tensor:
        rows = [field[coord] if coord is not None else torch.as_tensor(
            synth(score, nid), dtype=field.dtype, device=field.device)
            for score, nid, coord in chosen]
        return torch.stack(rows)

    t = state.trust
    trust = t._replace(
        scores=gather(t.scores, lambda s, nid: s),
        status=gather(t.status, lambda s, nid: int(
            trainer.trust_manager.get_node_status(nid))),
        update_count=gather(t.update_count, lambda s, nid: 0),
        last_updated=gather(t.last_updated, lambda s, nid: now),
        decay_rate=gather(t.decay_rate,
                          lambda s, nid: config.trust_decay_rate),
        recovery_rate=gather(t.recovery_rate, lambda s, nid: host_row(
            "recovery_rate", nid, config.trust_recovery_rate)),
        metrics=gather(t.metrics, lambda s, nid: list(METRIC_DEFAULTS)),
        attack_count=gather(t.attack_count, lambda s, nid: int(host_row(
            "attack_count", nid, 0))))

    # The layer migration: blocks and their moments restack.
    param_leaves = tree_leaves(state.params)
    block_ids = {id(x) for x in tree_leaves(blocks)}
    block_index = [i for i, x in enumerate(param_leaves)
                   if id(x) in block_ids]
    params = dict(state.params)
    params["blocks"] = restack_blocks(blocks, new_S)
    opt_state = restack_opt_state(state.opt_state, block_index,
                                  len(param_leaves), new_S,
                                  tuple(lead.shape[:2]))

    # Fresh per-stage intelligence (stage k holds a new layer slice).
    window = state.out_baseline.ring.shape[1]
    num_leaves = state.monitor.grad_norm_avg.shape[1]
    zeros = dict(dtype=torch.int32, device=device)
    new_state = state._replace(
        params=params, opt_state=opt_state, trust=trust,
        out_baseline=init_baseline_state(new_S, window, NUM_GRADIENT_STATS,
                                         device=device),
        grad_baseline=init_baseline_state(new_S, window,
                                          NUM_GRADIENT_STATS, device=device),
        verifier=init_verifier_state(new_S, device),
        monitor=init_monitor_state(new_S, num_leaves, device),
        canary=init_canary_state(new_S, make_canary(
            trainer.model.config, config.canary_tokens, device=device)),
        prev_suspects=torch.zeros(new_S, dtype=torch.bool, device=device),
        clean_streak=torch.zeros(new_S, **zeros))
    _sync(device)
    migration_time = time.perf_counter() - t0
    bytes_moved = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params["blocks"]))
    measured_gbps = bytes_moved / max(migration_time, 1e-9) / 1024 ** 3

    new_config = dataclasses.replace(config, num_nodes=new_S)
    trainer.mesh = build_mesh(new_S, "model", device=device)
    trainer._rebuild_steps(new_config)
    trainer.state = new_state
    trainer._lay_out()      # the blocks' stage specs on the new mesh
    evicted_ids = [trainer.node_map[i] for i in drop]
    new_map = [nid for _, nid, _ in chosen]
    trainer.node_map = new_map
    trainer._idle_pool = new_pool
    bits = [bool(trainer._plan_bits.get(nid, False)) for nid in new_map]
    trainer.attack_plan = trainer.attack_plan._replace(
        target_mask=torch.tensor(bits, dtype=torch.bool, device=device))
    record = {
        "evicted_nodes": evicted_ids,
        "surviving_nodes": list(new_map),
        "idle_nodes": sorted(new_pool),
        "old_num_stages": S,
        "new_num_stages": new_S,
        "layers_per_stage": num_layers // new_S,
        "migration_time_s": migration_time,
        "bytes_moved": bytes_moved,
        "measured_gbps": measured_gbps,
        "new_device_count": 1,
        "timestamp": time.time(),
    }
    logger.warning(
        "Pipeline restaff: stage(s) %s evicted; %d layers repartitioned "
        "%d -> %d stages on 1 device (%.1f MB in %.6f s); idle survivors "
        "%s", evicted_ids, num_layers, S, new_S, bytes_moved / 2 ** 20,
        migration_time, sorted(new_pool))
    return record


__all__ = ["choose_stage_count", "restack_blocks", "restack_opt_state",
           "restaff_pipeline"]
