"""The trusted training step.

Counterpart of ``trustworthy_dl_tpu/engine/step.py`` (``build_train_step``
and its helpers).  One call runs, in the JAX package's order:

  1. poison the batch (attack injection, experiments only);
  2. per-node forward, loss and the detector's output features;
  3. per-node gradients, then gradient poisoning (injection);
  4. gradient verification (finite + log-norm z, cross-node gated) and
     the fleet-level norm-surge alarm;
  5. detector verdicts on the output and gradient batteries, Byzantine
     and backdoor consensus checks, loss detachment, hard cross-node
     outliers; rolling baselines absorb only clean nodes;
  6. mark compromised (confirmed verdicts, non-finite gradients);
  7. trust update from output deviation / gradient consistency, then
     probation recovery;
  8. trust-gated aggregation with gated nodes hard-masked (0 * NaN = NaN);
  9. the optimizer update, skipped entirely (params and optimizer state)
     when every node is gated out; the monitor absorbs clean samples.

The JAX step vmaps the node axis; here the per-node gradients come from a
Python loop over the nodes (forward, loss, ``torch.autograd.grad``),
stacked into [n, ...] leaves.  With ``grad_accum_steps`` = a > 1 each
node's batch runs as a sequential microbatches (JAX's ``lax.scan``): loss,
gradients, mean logits and the model's diagnostics (``model_aux``, the
MoE family's drop fraction) average over them, the output batteries
combine per microbatch (``stats.combine_microbatch_stats``) and the
feature mean/std average.  The diagnostics then average over the nodes
(a fleet-level capacity health, not a detection signal).  The batch is poisoned before the split and the
gradients after the average, as in JAX.  The statistic batteries run on
detached tensors under ``torch.no_grad``: one moment-battery launch
(kernel B1) covers every gradient leaf of every node, one more every
node's (every microbatch's) features.

Across processes (``process_group`` of W > 1 ranks, one process a card,
``core/mesh.initialize_multihost``): each rank holds its ``n / W``
contiguous node rows of the batch and runs only their node passes; one
all-gather, staged through host memory, then collects every node's loss,
mean logits, gradient leaves, features and model diagnostics in node
order, and every rank runs detection, trust, aggregation and the
optimizer over all ``n`` nodes.  Every rank ends the step with the same
state, bit for bit, as the one-process step over the same global batch
(JAX's replicated state): the per-node values are the same computations,
gathered as bytes.  A live plan's batch poisoning draws for all ``n``
rows, as the one-process step does, so the ranks gather the batch first
on such a step and each keeps its own rows; the gradient injection acts
on the gathered ``n``.

:func:`build_eval_step` and :func:`build_node_eval_step` are the
validation steps: loss and accuracy, through the fused eval head where
``lm_head_chunk`` resolves to a width (dense GPT-2 only, as in JAX).
Medians follow ``jnp.median`` (the two middle values averaged, NaN if any
input is NaN) and standard deviations are population ones, as in JAX.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch
from torch.profiler import record_function

from trustworthy_dl_tpu_torch.attacks.adversarial import AttackPlan, \
    poison_batch, poison_gradients
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.core.mesh import process_node_rows
from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.detect.detector import anomaly_verdicts, \
    attribute_attack
from trustworthy_dl_tpu_torch.detect.verifier import absorb_norms, \
    fleet_surge_update, norm_suspicions
from trustworthy_dl_tpu_torch.engine.optimizer import Optimizer, \
    global_norm, guarded_update
from trustworthy_dl_tpu_torch.engine.state import TrainState, update_monitor
from trustworthy_dl_tpu_torch.models.factory import ModelBundle
from trustworthy_dl_tpu_torch.ops import fused_stats as fs
from trustworthy_dl_tpu_torch.trust import state as ts
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor

CROSS_SECTIONAL_THRESHOLD = 3.0
HARD_CROSS_Z = 25.0
NORM_CROSS_Z = 3.0
NORM_MAD_FLOOR = 0.1
LOSS_CROSS_Z = 6.0
LOSS_MAD_FLOOR_REL = 0.05
LOSS_MAD_FLOOR_ABS = 0.02


def _median(values: Tensor, dim: int = 0, keepdim: bool = False) -> Tensor:
    """``jnp.median``: the mean of the two middle values for an even count
    ((lo + hi) * 0.5), NaN wherever an input along ``dim`` is NaN."""
    n = values.shape[dim]
    s = values.sort(dim=dim).values
    med = (s.narrow(dim, (n - 1) // 2, 1) + s.narrow(dim, n // 2, 1)) * 0.5
    med = torch.where(values.isnan().any(dim=dim, keepdim=True),
                      torch.full_like(med, float("nan")), med)
    return med if keepdim else med.squeeze(dim)


def _median_mad(values: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """[n, d] -> (median [1, d], |dev| [n, d], sigma-consistent MAD
    [1, d])."""
    med = _median(values, 0, keepdim=True)
    abs_dev = (values - med).abs()
    return med, abs_dev, _median(abs_dev, 0, keepdim=True) * 1.4826


def _cross_sectional_score(stats: Tensor) -> Tensor:
    """f32 [n]: mean robust z of each node's stat vector against this
    step's cross-node median/MAD."""
    _, abs_dev, mad = _median_mad(stats)
    usable = mad[0] > 1e-12
    z = torch.where(usable[None, :], abs_dev / mad.clamp(min=1e-12),
                    torch.zeros_like(abs_dev))
    return z.sum(dim=1) / usable.sum().clamp(min=1)


def _hard_cross_outliers(stats: Tensor) -> Tensor:
    """bool [n]: astronomical cross-node outliers (MAD floored at 5 % of
    the median), the detection path a poisoned baseline cannot blind."""
    med, abs_dev, mad = _median_mad(stats)
    floor = (0.05 * med.abs()).clamp(min=1e-6)
    return (abs_dev / torch.maximum(mad, floor)).mean(dim=1) > HARD_CROSS_Z


def _loss_cross_outliers(losses: Tensor) -> Tensor:
    """bool [n]: a node's loss far ABOVE the cross-node median (the
    data-poisoning signature), one-sided."""
    med = _median(losses)
    dev = losses - med
    mad = _median(dev.abs()) * 1.4826
    floor = (LOSS_MAD_FLOOR_REL * med.abs()).clamp(min=LOSS_MAD_FLOOR_ABS)
    return dev / torch.maximum(mad, floor) > LOSS_CROSS_Z


def _norm_cross_outliers(global_norms: Tensor) -> Tensor:
    """bool [n]: cross-node outliers of the log gradient norm."""
    log_norm = global_norms.clamp(min=1e-30).log()
    _, abs_dev, mad = _median_mad(log_norm[:, None])
    return (abs_dev / mad.clamp(min=NORM_MAD_FLOOR))[:, 0] > NORM_CROSS_Z


def _moments(segments: Sequence[Tensor]) -> Tensor:
    """B1 over any number of segments, :data:`fs.MAX_SEGMENTS` a launch
    (one launch's rows come back as they are, several are concatenated)."""
    step = fs.MAX_SEGMENTS
    if len(segments) <= step:
        return fs.fused_moments(segments)
    return torch.cat([fs.fused_moments(segments[i:i + step])
                      for i in range(0, len(segments), step)])


def gradient_stat_vector(leaves: Sequence[Tensor], moments: Tensor,
                         max_sort: int) -> Tuple[Tensor, Tensor, Tensor]:
    """(17-stat battery, per-leaf norms, finite flag) of one node's
    flattened gradient leaves from their moments [L, 8]."""
    base, leaf_norms, finite, sample = st.leafwise_statistics(
        leaves, max_sort, moments)
    extra = torch.stack([
        torch.full((), float(len(leaves)), device=base.device),
        leaf_norms.mean(), leaf_norms.std(correction=0), leaf_norms.max(),
        st.chunked_cosine_mean(sample)])
    return torch.cat([base, extra]), leaf_norms, finite


def output_stat_vector(flat: Tensor, moments: Tensor, max_sort: int
                       ) -> Tensor:
    """17-padded output battery (12 real stats + zero padding)."""
    base = st.leafwise_statistics([flat], max_sort, moments)[0]
    pad = torch.zeros(st.NUM_GRADIENT_STATS - st.NUM_TENSOR_STATS,
                      device=base.device)
    return torch.cat([base, pad])


class StepMetrics(NamedTuple):
    loss: Tensor            # f32 [] trust-weighted aggregate
    per_node_loss: Tensor   # f32 [n]
    trust_scores: Tensor    # f32 [n]
    status: Tensor          # i32 [n]
    attacked: Tensor        # bool [n] confirmed (debounced) verdicts
    verified: Tensor        # bool [n] gradient verification passed
    finite: Tensor          # bool [n]
    weights: Tensor         # f32 [n] contribution gate used
    system_trust: Tensor    # f32 []
    grad_norm: Tensor       # f32 [] aggregated gradient norm
    out_score: Tensor       # f32 [n]
    grad_score: Tensor      # f32 [n]
    attack_type: Tensor     # i32 [n] (valid iff attacked)
    byzantine: Tensor       # bool [n]
    backdoor: Tensor        # bool [n]
    out_stats: Tensor       # f32 [n, 17]
    grad_stats: Tensor      # f32 [n, 17]
    # Model diagnostics, {"moe_drop_fraction": f32 []} for the MoE family
    # (the share of routed assignments dropped at expert capacity, mean
    # over layers, microbatches and nodes); None for the other models.
    model_aux: Optional[Dict[str, Tensor]] = None
    fleet_alert: Any = None  # bool [] debounced fleet norm surge


class PackedMetrics(NamedTuple):
    """One step's packed metrics: the fresh device vector, its host copy
    (pinned, possibly still in flight on a card) and the event recorded
    after the copy (None on the CPU)."""

    device: Tensor
    host: Tensor
    event: Any


class HostMetricsPacker:
    """Packs every field of a step's :class:`StepMetrics` (and the
    post-step ``fleet_raw_streak``, which the host must see at its value
    of that step) into one fresh f32 device vector, and starts that
    vector's one device-to-host copy at dispatch (``pack``).  ``unpack``
    waits for the copy and restores each field's dtype and shape, so the
    host reads what a synchronous read would have.  bool and the small
    int32 codes survive f32 exactly; each ``model_aux`` entry packs as
    ``model_aux:<key>`` in key order.  The layout is fixed from a template
    step; ``matches`` fails when the node count changed (an elastic
    transition), and the pipeline builds a new packer.  Counterpart of
    JAX's ``engine/step.py`` ``HostMetricsPacker``."""

    def __init__(self, metrics: StepMetrics, fleet_streak: Any = None):
        self._layout = []   # (key, shape, size, numpy dtype)
        for key, leaf in self._leaves(metrics, fleet_streak):
            np_dtype = torch.empty(0, dtype=leaf.dtype).numpy().dtype
            self._layout.append((key, tuple(leaf.shape), leaf.numel(),
                                 np_dtype))
        self.total = sum(size for _, _, size, _ in self._layout)

    @staticmethod
    def _leaves(metrics: StepMetrics, fleet_streak: Any):
        """(key, tensor) in field order, shared by layout and pack."""
        for name in StepMetrics._fields:
            value = getattr(metrics, name)
            if name == "model_aux":
                for k in sorted(value or {}):
                    yield f"model_aux:{k}", value[k]
            elif value is not None:
                yield name, value
        if fleet_streak is not None:
            yield "fleet_raw_streak", fleet_streak

    def matches(self, metrics: StepMetrics, fleet_streak: Any = None
                ) -> bool:
        """The template's fields and shapes?"""
        probe = [(k, tuple(v.shape))
                 for k, v in self._leaves(metrics, fleet_streak)]
        return probe == [(k, shape) for k, shape, _, _ in self._layout]

    def pack(self, metrics: StepMetrics, fleet_streak: Any = None
             ) -> PackedMetrics:
        """The packed vector and its host copy.  On a card the copy goes
        to pinned memory without blocking, and an event is recorded after
        it on the current stream; nothing here waits for the card."""
        flat = torch.cat([leaf.float().reshape(-1)
                          for _, leaf in self._leaves(metrics, fleet_streak)])
        if flat.device.type != "cuda":
            return PackedMetrics(flat, flat, None)
        host = flat.to("cpu", non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PackedMetrics(flat, host, event)

    def unpack(self, packed: PackedMetrics
               ) -> Tuple[StepMetrics, Optional[Any]]:
        """(StepMetrics of numpy arrays, fleet_raw_streak or None), after
        the copy's event completes: a pinned buffer read before it holds
        whatever was there."""
        if packed.event is not None:
            packed.event.synchronize()
        flat = packed.host.numpy()
        fields: Dict[str, Any] = {"model_aux": None, "fleet_alert": None}
        aux: Dict[str, Any] = {}
        streak = None
        offset = 0
        for key, shape, size, dtype in self._layout:
            chunk = flat[offset:offset + size].astype(dtype).reshape(shape)
            offset += size
            if key.startswith("model_aux:"):
                aux[key.split(":", 1)[1]] = chunk
            elif key == "fleet_raw_streak":
                streak = chunk
            else:
                fields[key] = chunk
        if aux:
            fields["model_aux"] = aux
        return StepMetrics(**fields), streak


StepFn = Callable[..., Tuple[TrainState, StepMetrics]]


def _node_loss(bundle: ModelBundle) -> Callable:
    """(params, batch) -> (loss, features, mean_logits[, model_aux]): the
    bundle's ``loss_monitor``, else (the vision models) ``apply`` and the
    cross-entropy, with the logits as the features and their f32 mean
    over every axis but the class axis as the mean logits."""
    if bundle.loss_monitor is not None:
        return bundle.loss_monitor
    from trustworthy_dl_tpu_torch.models import layers as L

    def plain(params: Any, batch: Dict[str, Tensor]):
        logits = bundle.apply(params, batch["input"])
        lead = tuple(range(logits.dim() - 1))
        return (L.cross_entropy_loss(logits, batch["target"]), logits,
                logits.float().mean(dim=lead))

    return plain


#: Each tensor's bytes start on this boundary in a gather's buffer, so
#: every view back to a wider dtype is aligned.
_GATHER_ALIGN = 16


def _gather_from_ranks(tensors: Sequence[Tensor], group: Any
                       ) -> Tuple[List[List[Tensor]], int]:
    """Every rank's ``tensors`` (the same shapes and dtypes on each rank),
    in rank order, on their device: their bytes in one buffer, one
    all-gather of it staged through host memory, and views back.  Returns
    (per rank, the tensors; the bytes gathered)."""
    import torch.distributed as dist

    device = tensors[0].device
    chunks, spans, offset = [], [], 0
    for t in tensors:
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % _GATHER_ALIGN
        chunks += [raw, raw.new_zeros(pad)] if pad else [raw]
        spans.append((offset, raw.numel()))
        offset += raw.numel() + pad
    flat = torch.cat(chunks).cpu()
    world = dist.get_world_size(group)
    host = torch.empty((world, flat.numel()), dtype=torch.uint8)
    dist.all_gather(list(host.unbind(0)), flat, group=group)
    out = []
    for buf in host.to(device):
        out.append([buf[start:start + size].view(t.dtype).reshape(t.shape)
                    for t, (start, size) in zip(tensors, spans)])
    return out, host.numel()


def build_train_step(bundle: ModelBundle, config: TrainingConfig,
                     optimizer: Optimizer, max_sort: int = 16384,
                     process_group: Any = None) -> StepFn:
    """The step for ``config.num_nodes`` nodes: ``step(state, batch, plan,
    grad_noise=None, batch_noise=None) -> (state, metrics)``, with batches
    {'input': [n, b, T], 'target': [n, b, T]} on the state's device (b a
    multiple of ``config.grad_accum_steps``), or {'input': [n, b, H, W,
    C] f32 images, 'target': [n, b] labels} for a vision model.
    ``grad_noise`` / ``batch_noise`` hand the attack injectors their draws
    (else they draw from ``state.rng``), for all n nodes.

    ``process_group`` (``torch.distributed``, W ranks): the batch is this
    rank's ``n / W`` contiguous node rows, and the step gathers the
    per-node results from every rank (module docstring).  The step's
    ``last_gather`` then holds the last gather's ``bytes`` and wall
    ``ms`` (device work drained first, so it is the gather alone)."""
    n_nodes = config.num_nodes
    world, rank = 1, 0
    if process_group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(process_group)
        rank = dist.get_rank(process_group)
    my_rows = process_node_rows(n_nodes, rank, world)
    accum = config.grad_accum_steps
    detection = config.attack_detection_enabled
    verification = config.gradient_verification_enabled
    num_classes = bundle.input_spec.get(
        "num_classes", bundle.input_spec.get("vocab_size", 2))
    node_loss = _node_loss(bundle)

    def node_passes(params: Any, batch: Dict[str, Tensor]):
        """Per node row of ``batch``, per microbatch: forward + loss +
        grads.  Returns (losses [r], features (detached, r lists of
        ``accum``), mean_logits [r, V], grads as [r, ...] leaves in tree
        order, per-node model_aux {key: [r]} or None), each node's loss,
        mean logits, grads and diagnostics the mean over its
        microbatches."""
        template = tree_leaves(params)
        rows = next(iter(batch.values())).shape[0]
        losses, feats, mean_logits, node_aux = [], [], [], []
        grads: List[Tensor] = []
        inv = 1.0 / accum
        for i in range(rows):
            leaves = [p.detach().requires_grad_(True) for p in template]
            node_params = tree_unflatten(params, leaves)
            micro = {k: v[i].chunk(accum) for k, v in batch.items()}
            loss_sum = ml_sum = None
            node_feats, micro_aux = [], []
            for a in range(accum):
                mb = {k: v[a] for k, v in micro.items()}
                with torch.enable_grad():
                    out = node_loss(node_params, mb)
                    loss, f, ml = out[:3]
                    g = torch.autograd.grad(loss, leaves)
                if len(out) > 3:
                    micro_aux.append({k: v.detach()
                                      for k, v in out[3].items()})
                if i == 0 and a == 0:
                    grads = [torch.empty((rows,) + x.shape, dtype=x.dtype,
                                         device=x.device) for x in g]
                for dst, src in zip(grads, g):
                    if a == 0:
                        dst[i].copy_(src)
                    else:
                        dst[i].add_(src)
                del g
                loss, ml = loss.detach(), ml.detach()
                loss_sum = loss if a == 0 else loss_sum + loss
                ml_sum = ml if a == 0 else ml_sum + ml
                node_feats.append(f.detach())
            if accum > 1:
                for dst in grads:
                    dst[i].mul_(inv)
                loss_sum, ml_sum = loss_sum * inv, ml_sum * inv
            losses.append(loss_sum)
            feats.append(node_feats)
            mean_logits.append(ml_sum)
            if micro_aux:
                node_aux.append({k: torch.stack([m[k] for m in micro_aux])
                                 .mean(dim=0) for k in micro_aux[0]})
        node_aux = ({k: torch.stack([m[k] for m in node_aux])
                     for k in node_aux[0]} if node_aux else None)
        return (torch.stack(losses), feats, torch.stack(mean_logits), grads,
                node_aux)

    def gather_rows(tensors: Sequence[Tensor]) -> List[Tensor]:
        """Each of this rank's per-node-row tensors, joined with every
        other rank's rows in rank (node) order."""
        if tensors and tensors[0].device.type == "cuda":
            torch.cuda.synchronize(tensors[0].device)
        t0 = time.perf_counter()
        by_rank, nbytes = _gather_from_ranks(tensors, process_group)
        out = [torch.cat([r[j] for r in by_rank])
               for j in range(len(tensors))]
        train_step.last_gather = {
            "bytes": nbytes, "ms": 1e3 * (time.perf_counter() - t0)}
        return out

    def gather_passes(losses, feats, mean_logits, grads, node_aux):
        """Every rank's node passes, all n nodes in node order."""
        keys = sorted(node_aux) if node_aux else []
        flat_feats = [f for node in feats for f in node]
        pieces = ([losses, mean_logits] + list(grads)
                  + [torch.stack(flat_feats)] + [node_aux[k] for k in keys])
        joined = gather_rows(pieces)
        losses, mean_logits = joined[0], joined[1]
        grads = joined[2:2 + len(grads)]
        every_feat = joined[2 + len(grads)]
        feats = [[every_feat[i * accum + a] for a in range(accum)]
                 for i in range(n_nodes)]
        node_aux = ({k: v for k, v in zip(keys, joined[3 + len(grads):])}
                    if keys else None)
        return losses, feats, mean_logits, grads, node_aux

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   plan: AttackPlan,
                   grad_noise: Optional[Sequence[Tensor]] = None,
                   batch_noise: Optional[Dict[str, Tensor]] = None
                   ) -> Tuple[TrainState, StepMetrics]:
        step = state.step
        now = float(step) * config.time_per_step
        live = plan.is_live(step)

        # 1. Attack injection on the data path: across processes over
        # the gathered batch (the draws cover all n rows), each rank then
        # keeping its own rows.
        if live and world > 1:
            keys = sorted(batch)
            full = dict(zip(keys, gather_rows([batch[k] for k in keys])))
            full = poison_batch(plan, full, step, num_classes,
                                generator=state.rng, noise=batch_noise)
            batch = {k: v[my_rows.start:my_rows.stop]
                     for k, v in full.items()}
        elif live:
            batch = poison_batch(plan, batch, step, num_classes,
                                 generator=state.rng, noise=batch_noise)

        # 2-3. Per-node forward/backward (this rank's nodes), the gather
        # of every rank's, then gradient injection.
        with record_function("tddl.forward_backward"):
            passes = node_passes(state.params, batch)
        if world > 1:
            with record_function("tddl.gather"):
                passes = gather_passes(*passes)
        losses, feats, mean_logits, grads, node_aux = passes
        # The diagnostics' mean over the nodes (a fleet-level health).
        model_aux = ({k: v.mean(dim=0) for k, v in node_aux.items()}
                     if node_aux else None)
        if live:
            grads = poison_gradients(plan, grads, step, generator=state.rng,
                                     noise=grad_noise)

        with torch.no_grad():
            return _after_backward(state, plan, losses, feats, mean_logits,
                                   grads, model_aux, now)

    train_step.last_gather = None

    def _after_backward(state, plan, losses, feats, mean_logits, grads,
                        model_aux, now):
        n = n_nodes
        device = losses.device
        with record_function("tddl.detection"):     # stages 4-7
            # Output batteries: one B1 launch over every node's (every
            # microbatch's) features; microbatch batteries combine per node.
            flat_feats = [f.reshape(-1) for node in feats for f in node]
            feat_moments = _moments(flat_feats)
            mb_stats = torch.stack([
                output_stat_vector(x, feat_moments[j:j + 1], max_sort)
                for j, x in enumerate(flat_feats)]).reshape(n, accum, -1)
            out_stats = torch.stack([st.combine_microbatch_stats(m)
                                     for m in mb_stats])
            out_mean = torch.stack([f.mean() for f in flat_feats]
                                   ).reshape(n, accum).mean(dim=1)
            out_std = torch.stack([f.std(correction=0) for f in flat_feats]
                                  ).reshape(n, accum).mean(dim=1)
            del feats, flat_feats

            # Gradient batteries: one B1 launch over every leaf of every node.
            n_leaves = len(grads)
            node_leaves = [[g[i].reshape(-1) for g in grads] for i in range(n)]
            grad_moments = _moments([x for node in node_leaves for x in node]
                                    ).reshape(n, n_leaves, 8)
            per_node = [gradient_stat_vector(node_leaves[i], grad_moments[i],
                                             max_sort) for i in range(n)]
            grad_stats = torch.stack([p[0] for p in per_node])
            leaf_norms = torch.stack([p[1] for p in per_node])
            finite_b = torch.stack([p[2] for p in per_node])
            global_norms = (leaf_norms * leaf_norms).sum(dim=1).sqrt()

            # 4. Gradient verification (pure read; absorption after 5).
            if verification:
                norm_suspect = norm_suspicions(state.verifier, global_norms)
                if n >= 4:
                    norm_suspect = norm_suspect & _norm_cross_outliers(
                        global_norms)
            else:
                norm_suspect = torch.zeros_like(finite_b)
            verified = finite_b & ~norm_suspect

            # 4b. Fleet-level norm-surge alarm.
            if verification:
                fleet_median = _median(global_norms)[None]
                _, fleet_norm, fleet_streak = fleet_surge_update(
                    state.fleet_norm, fleet_median, state.fleet_raw_streak)
                fleet_alert = (fleet_streak >= 2)[0]
            else:
                fleet_alert = None
                fleet_norm, fleet_streak = state.fleet_norm, \
                    state.fleet_raw_streak

            # 5. Detector verdicts.
            zeros_b = torch.zeros(n, dtype=torch.bool, device=device)
            if detection:
                warmup = config.detector_warmup
                out_v = anomaly_verdicts(out_stats, state.out_baseline,
                                         warmup=warmup)
                grad_v = anomaly_verdicts(grad_stats, state.grad_baseline,
                                          warmup=warmup)
                if n >= 4:
                    out_v = out_v._replace(is_attack=out_v.is_attack & (
                        _cross_sectional_score(out_stats)
                        > CROSS_SECTIONAL_THRESHOLD))
                    grad_v = grad_v._replace(is_attack=grad_v.is_attack & (
                        _cross_sectional_score(grad_stats)
                        > CROSS_SECTIONAL_THRESHOLD))
                warm_nodes = state.out_baseline.count >= warmup
                if n >= 3:
                    byz = st.byzantine_verdicts(
                        torch.softmax(mean_logits, dim=-1)) & warm_nodes
                else:
                    byz = zeros_b
                consensus = mean_logits.mean(dim=0, keepdim=True)
                kl = torch.stack([st.backdoor_divergence(m[None], consensus)
                                  for m in mean_logits])
                backdoor = (kl > 2.0) & warm_nodes
                loss_outlier = (_loss_cross_outliers(losses) & warm_nodes
                                if n >= 4 else zeros_b)
                candidates = (out_v.is_attack | grad_v.is_attack | byz
                              | backdoor | loss_outlier)
                if n >= 4:
                    candidates = candidates | _hard_cross_outliers(out_stats) \
                        | _hard_cross_outliers(grad_stats)
                clean_now = ~(candidates | norm_suspect | ~finite_b)
                out_bl = bl.push_stats(state.out_baseline, out_stats,
                                       mask=clean_now)
                grad_bl = bl.push_stats(state.grad_baseline, grad_stats,
                                        mask=clean_now)
                attacked = candidates & state.prev_suspects
                out_score, grad_score = out_v.score, grad_v.score
                attack_type = attribute_attack(grad_v, out_v, byz, backdoor,
                                               loss_outlier)
            else:
                out_bl, grad_bl = state.out_baseline, state.grad_baseline
                attacked = candidates = byz = backdoor = zeros_b
                out_score = grad_score = torch.zeros(n, device=device)
                attack_type = torch.zeros(n, dtype=torch.int32, device=device)
                clean_now = verified

            candidates = candidates | norm_suspect
            attacked = attacked | (norm_suspect & state.prev_suspects)

            # 5b. Verifier absorption by the same clean-this-step rule.
            verifier = (absorb_norms(state.verifier, global_norms, clean_now)
                        if verification else state.verifier)

            # 6. Compromise marking.
            trust = ts.mark_compromised(state.trust, attacked | ~finite_b)

            # 7. Trust signals against the monitor's expectations, EMA update.
            mon = state.monitor
            warm = mon.warm
            exp_std = mon.out_std_avg.clamp(min=1e-6)
            mean_dev = (out_mean - mon.out_mean_avg).abs() / exp_std
            std_dev = (out_std - mon.out_std_avg).abs() / exp_std
            output_deviation = torch.where(
                warm, torch.clamp((mean_dev + std_dev) / 2.0, max=1.0),
                torch.zeros_like(mean_dev))
            exp_norms = mon.grad_norm_avg
            per_leaf = torch.clamp(leaf_norms / exp_norms.clamp(min=1e-12),
                                   max=1.0)
            usable = exp_norms > 0
            cons = torch.where(usable, per_leaf, torch.zeros_like(per_leaf)
                               ).sum(dim=1) / usable.sum(dim=1).clamp(min=1)
            gradient_consistency = torch.where(warm, cons,
                                               torch.ones_like(cons))
            trust = ts.update_trust(trust, output_deviation,
                                    gradient_consistency, now,
                                    alpha=config.trust_alpha)
            trust, clean_streak = ts.probation_recovery(
                trust, state.clean_streak, verified & ~candidates,
                config.recovery_probation_steps)

        with record_function("tddl.update"):        # stages 8-9
            # 8. Trust-gated aggregation, gated nodes hard-masked.
            weights = ts.contribution_weights(trust, verified & ~candidates)
            denom = weights.sum()
            inv = torch.where(denom > 0, 1.0 / denom.clamp(min=1e-30),
                              torch.zeros_like(denom))
            w = weights * inv
            agg = []
            for g in grads:
                mask = (weights > 0).reshape((n,) + (1,) * (g.dim() - 1))
                agg.append(torch.tensordot(
                    w.to(g.dtype), torch.where(mask, g, torch.zeros_like(g)),
                    dims=1))
            del grads

            # 9. Optimizer (skipped when every node is gated) and monitor.
            param_leaves = tree_leaves(state.params)
            new_leaves, opt_state = guarded_update(
                denom > 0, optimizer, agg, state.opt_state, param_leaves)
            monitor = update_monitor(mon, out_mean, out_std, leaf_norms,
                                     verified & ~candidates)
            loss = (torch.where(weights > 0, losses, torch.zeros_like(losses))
                    * weights).sum() * inv
        new_state = TrainState(
            params=tree_unflatten(state.params, new_leaves),
            opt_state=opt_state, trust=trust, out_baseline=out_bl,
            grad_baseline=grad_bl, verifier=verifier, monitor=monitor,
            prev_suspects=candidates, step=state.step + 1,
            epoch=state.epoch, rng=state.rng, clean_streak=clean_streak,
            fleet_norm=fleet_norm, fleet_raw_streak=fleet_streak)
        metrics = StepMetrics(
            loss=loss, per_node_loss=losses, trust_scores=trust.scores,
            status=trust.status, attacked=attacked, verified=verified,
            finite=finite_b, weights=weights,
            system_trust=ts.system_trust(trust),
            grad_norm=global_norm(agg), out_score=out_score,
            grad_score=grad_score, attack_type=attack_type, byzantine=byz,
            backdoor=backdoor, out_stats=out_stats, grad_stats=grad_stats,
            model_aux=model_aux, fleet_alert=fleet_alert)
        return new_state, metrics

    return train_step


EvalFn = Callable[[Any, Dict[str, Tensor]], Dict[str, Tensor]]


def build_eval_step(bundle: ModelBundle) -> EvalFn:
    """Validation step on an un-noded batch: {'loss', 'accuracy'}, no
    detection.  Dense GPT-2 takes the fused eval head where
    ``lm_head_chunk`` resolves to a width for this batch (the training
    dispatch), so the [B, T, V] logits never materialise; a bundle with
    ``fused_eval_head`` False (the MoE family, as in JAX) and the vision
    models take ``apply`` and the cross-entropy."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.models import layers as L
    from trustworthy_dl_tpu_torch.ops.fused_ce import fused_lm_eval

    cfg = bundle.config
    lm = bundle.kind == "lm" and bundle.fused_eval_head

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
        chunk = lm and gpt2.resolve_lm_head_chunk(cfg,
                                                  batch["target"].numel())
        if not chunk:
            logits = bundle.apply(params, batch["input"])
            return {"loss": L.cross_entropy_loss(logits, batch["target"]),
                    "accuracy": L.accuracy(logits, batch["target"])}
        x = gpt2.apply_blocks(params["blocks"],
                              gpt2.embed(params, batch["input"]), cfg)
        normed = L.layernorm(params["ln_f"], x)
        loss, acc = fused_lm_eval(normed, params["wte"], batch["target"],
                                  chunk, cfg.dtype)
        return {"loss": loss, "accuracy": acc}

    return eval_step


def build_node_eval_step(bundle: ModelBundle) -> EvalFn:
    """Validation over the node axis: [rows, b, ...] batches, one eval per
    row; rows are equal-sized, so the mean of the row means is the
    batch mean."""
    eval_step = build_eval_step(bundle)

    def node_eval_step(params: Any, node_batch: Dict[str, Tensor]
                       ) -> Dict[str, Tensor]:
        rows = next(iter(node_batch.values())).shape[0]
        outs = [eval_step(params, {k: v[i] for k, v in node_batch.items()})
                for i in range(rows)]
        return {k: torch.stack([o[k] for o in outs]).mean()
                for k in outs[0]}

    return node_eval_step


__all__ = [
    "CROSS_SECTIONAL_THRESHOLD", "HARD_CROSS_Z", "LOSS_CROSS_Z",
    "NORM_CROSS_Z", "HostMetricsPacker", "PackedMetrics", "StepMetrics",
    "build_eval_step", "build_node_eval_step", "build_train_step",
    "gradient_stat_vector", "output_stat_vector",
]
