"""Pipeline (stage) parallelism: the GPipe schedule, per-stage detection,
the canary probe and the trust gate of a stage's updates.

Counterpart of ``trustworthy_dl_tpu/parallel/pipeline.py``.  Stacked
block params [L, ...] reshape to [S, L/S, ...] (:func:`stack_stages`):
stage s holds layers s L/S .. (s + 1) L/S - 1, the reference's contiguous
per-node chunks.  :func:`build_pipeline_apply` runs the GPipe microbatch
schedule over the port's single-controller mesh (``core/mesh.py``): at
tick t stage s applies its layer slice to microbatch t - s and hands the
result to stage s + 1's device (``tensor.to``, JAX's ``ppermute``; a
no-op on one card).  JAX computes every stage at every one of the M + S -
1 ticks and masks the inactive ones; here a stage runs only where 0 <= t
- s < M.  The outputs are the same (an inactive chain never reaches a
written output or an active battery), and a step is exactly M x S stage
applications: on one card the stages run one after another, which is
what the reference's sequential loop does.  The backward is autograd
through the ticks (JAX transposes the ring under ``jax.grad``): the flash
kernels' ``autograd.Function`` (B2 forward, B3 backward) at every stage
application where ``attn_impl`` picks flash.

Per-stage trust integration, as in JAX:
  * each stage's boundary battery is ``tensor_statistics_sampled`` over
    its active ticks' outputs (detached), averaged over those ticks, with
    the outputs' mean and population std;
  * per-stage gradient batteries come from the [S, L/S, ...] block
    gradients' leading axis: one moment-battery launch (kernel B1) over
    every stage's block leaves;
  * the trust gate zeroes a flagged stage's parameter updates (its layers
    freeze until a restaff, ``elastic/restaff.py``); the cross-sectional
    outlier filter of data mode is off (stages legitimately differ);
  * a per-stage canary (:func:`canary_probe`) applies each stage's slice
    to one fixed input every step: an abrupt change flags a Byzantine
    stage, a slow drift of its softmax signature a backdoor.  While a
    Byzantine verdict is live every stage's gradients flowed through the
    corrupted stage, so the statistical verdicts, the baselines and the
    trust EMA freeze and the whole update is skipped.

The canary's input is a seeded standard-normal draw of the port's own
(:func:`make_canary`; JAX draws from ``PRNGKey(0xCA9A12)``, which torch
cannot reproduce): the train step takes another through ``canary=``.
The pipeline supports the dense GPT-2 family, as JAX's does.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, \
    Sequence, Tuple

import torch
from torch.profiler import record_function

from trustworthy_dl_tpu_torch.attacks.adversarial import AttackPlan, \
    corrupt_stage_compute, poison_gradients
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.core.mesh import Mesh, stage_devices
from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.detect.detector import AttackType, \
    anomaly_verdicts
from trustworthy_dl_tpu_torch.detect.verifier import absorb_norms, \
    norm_suspicions
from trustworthy_dl_tpu_torch.engine.optimizer import Optimizer, \
    global_norm, guarded_update
from trustworthy_dl_tpu_torch.engine.state import TrainState, update_monitor
from trustworthy_dl_tpu_torch.engine.step import StepMetrics, _moments, \
    gradient_stat_vector
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.trust import state as ts
from trustworthy_dl_tpu_torch.utils.tree import map_tree, tree_leaves, \
    tree_unflatten

logger = logging.getLogger(__name__)

Tensor = torch.Tensor


def stack_stages(blocks: Any, num_stages: int) -> Any:
    """[L, ...] stacked blocks -> [S, L/S, ...], stage-major."""
    def reshape(leaf: Tensor) -> Tensor:
        n = leaf.shape[0]
        if n % num_stages:
            raise ValueError(f"{n} layers not divisible by {num_stages} "
                             "stages")
        return leaf.reshape((num_stages, n // num_stages)
                            + tuple(leaf.shape[1:]))
    return map_tree(reshape, blocks)


def unstack_stages(blocks: Any) -> Any:
    """Inverse of :func:`stack_stages`."""
    return map_tree(lambda a: a.reshape((a.shape[0] * a.shape[1],)
                                        + tuple(a.shape[2:])), blocks)


def choose_num_microbatches(batch_size: int, num_stages: int,
                            dp: int = 1) -> int:
    """The auto schedule depth (``num_microbatches = 0``), JAX's rule: the
    largest M <= min(per-row batch, 4 S) dividing the per-row batch; where
    none does, the trim-tolerant M in [2, cap] that uses the most of the
    batch (ties to the larger M), with a warning, instead of M = 1."""
    per_row = max(batch_size // max(dp, 1), 1)
    cap = min(per_row, 4 * num_stages)
    for m in range(cap, 1, -1):
        if per_row % m == 0:
            return m
    best_m, best_used = 1, 0
    for m in range(2, cap + 1):
        used = (per_row // m) * m
        if used >= best_used:
            best_m, best_used = m, used
    if best_m > 1:
        logger.warning(
            "no exact microbatch divisor of per-row batch %d <= cap %d; "
            "auto-selected trim-tolerant M=%d (utilises %d/%d samples "
            "per row, bubble %.0f%% vs %.0f%% at M=1)",
            per_row, cap, best_m, best_used, per_row,
            100.0 * bubble_fraction(num_stages, best_m),
            100.0 * bubble_fraction(num_stages, 1))
    return best_m


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """GPipe's idle fraction of the M + S - 1 tick schedule,
    (S - 1) / (M + S - 1); the backward mirrors it."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _stage_slices(blocks: Any, num_stages: int) -> List[Any]:
    """[S, L/S, ...] blocks -> one [L/S, ...] tree per stage (``unbind``:
    one view per stage from a single op, so the backward stacks the
    stages' gradients once)."""
    per_leaf = map_tree(lambda a: a.unbind(0), blocks)
    return [map_tree(lambda views, s=s: views[s], per_leaf)
            for s in range(num_stages)]


def stage_forward(stage_blocks: Any, x: Tensor, cfg: gpt2.GPT2Config
                  ) -> Tensor:
    """One stage: its L/S blocks in turn on f32 [b, T, D] activations."""
    n = tree_leaves(stage_blocks)[0].shape[0]
    for block in gpt2.unstack_blocks(stage_blocks, n):
        x = gpt2.block_forward(block, x, cfg)
    return x


def _boundary_battery(out: Tensor, max_sort: int) -> Tensor:
    """17-padded battery of one tick's stage output."""
    stats = st.tensor_statistics_sampled(out.reshape(-1).float(), max_sort)
    pad = torch.zeros(st.NUM_GRADIENT_STATS - st.NUM_TENSOR_STATS,
                      device=stats.device)
    return torch.cat([stats, pad])


def build_pipeline_apply(cfg: gpt2.GPT2Config, mesh: Mesh, num_stages: int,
                         num_microbatches: int, max_sort: int = 16384
                         ) -> Callable[[Any, Tensor],
                                       Tuple[Tensor, Tensor, Tensor,
                                             Tensor]]:
    """``pipe_apply(stage_blocks, x_mb) -> (y_mb, stage_stats [S, 17],
    act_mean [S], act_std [S])``: ``stage_blocks`` leaves [S, L/S, ...],
    ``x_mb`` [M, mb, T, D] f32.  Stage s runs on the mesh's s-th stage
    device; the outputs land on the first stage's device."""
    S, M = num_stages, num_microbatches
    devices = stage_devices(mesh)
    if len(devices) != S:
        raise ValueError(f"mesh has {len(devices)} stages, want {S}")

    def pipe_apply(stage_blocks: Any, x_mb: Tensor
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        home = x_mb.device
        slices = [map_tree(lambda a, d=devices[s]: a.to(d), sl)
                  for s, sl in enumerate(_stage_slices(stage_blocks, S))]
        outputs: List[Optional[Tensor]] = [None] * M
        stats_sum: List[Any] = [0.0] * S
        mean_sum: List[Any] = [0.0] * S
        std_sum: List[Any] = [0.0] * S
        carry: List[Optional[Tensor]] = [None] * S   # last tick's outputs
        for t in range(M + S - 1):
            fresh: List[Optional[Tensor]] = [None] * S
            for s in range(S):
                m = t - s
                if not 0 <= m < M:
                    continue
                inp = x_mb[m] if s == 0 else carry[s - 1]
                out = stage_forward(slices[s], inp.to(devices[s]), cfg)
                with torch.no_grad():
                    sg = out.detach()
                    stats_sum[s] = stats_sum[s] + _boundary_battery(
                        sg, max_sort)
                    mean_sum[s] = mean_sum[s] + sg.mean()
                    std_sum[s] = std_sum[s] + sg.std(correction=0)
                if s == S - 1:
                    outputs[m] = out.to(home)
                else:
                    fresh[s] = out.to(devices[s + 1])
            carry = fresh
        y_mb = torch.stack(outputs)
        denom = float(max(M, 1))
        stage_stats = torch.stack([x.to(home) for x in stats_sum]) / denom
        act_mean = torch.stack([x.to(home) for x in mean_sum]) / denom
        act_std = torch.stack([x.to(home) for x in std_sum]) / denom
        return y_mb, stage_stats, act_mean, act_std

    return pipe_apply


class CanaryState(NamedTuple):
    """Per-stage reference of the canary probe (JAX's)."""

    prev: Tensor     # f32 [S, cb, tc, d] last step's canary outputs
    sig_ema: Tensor  # f32 [S, d] EMA softmax signature of the outputs
    count: Tensor    # i32 [] probes absorbed


def init_canary_state(num_stages: int, canary: Tensor) -> CanaryState:
    cb, tc, d = canary.shape
    dev = canary.device
    return CanaryState(
        prev=torch.zeros(num_stages, cb, tc, d, device=dev),
        sig_ema=torch.full((num_stages, d), 1.0 / d, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev))


#: The canary's seed, JAX's key (the draw itself is torch's).
CANARY_SEED = 0xCA9A12


def make_canary(cfg: gpt2.GPT2Config, canary_tokens: int = 8,
                canary_batch: int = 1, device: Any = "cpu") -> Tensor:
    """The fixed probe input: seeded unit-Gaussian activations at the block
    interface, f32 [canary_batch, canary_tokens, n_embd], drawn on the
    CPU so that every device gets the same values."""
    gen = torch.Generator().manual_seed(CANARY_SEED)
    return torch.randn((canary_batch, canary_tokens, cfg.n_embd),
                       generator=gen).to(device)


CANARY_BYZ_REL_CHANGE = 0.25   # honest per-step drift is lr-sized
CANARY_BACKDOOR_KL = 2.0       # the reference's backdoor bar


@torch.no_grad()
def canary_probe(canary_state: CanaryState, blocks: Any, canary: Tensor,
                 cfg: gpt2.GPT2Config, warmup: int
                 ) -> Tuple[CanaryState, Tensor, Tensor]:
    """Probe every stage's transform on the canary; returns (new state,
    byz [S], backdoor [S])."""
    S = tree_leaves(blocks)[0].shape[0]
    y = torch.stack([stage_forward(sl, canary, cfg).float()
                     for sl in _stage_slices(blocks, S)])
    axes = tuple(range(1, y.dim()))
    prev = canary_state.prev
    delta = torch.sqrt(((y - prev) ** 2).sum(dim=axes))
    ref = torch.sqrt((prev ** 2).sum(dim=axes)) + 1e-8
    count = canary_state.count
    byz = (delta / ref > CANARY_BYZ_REL_CHANGE) & (count >= 1)
    sig = torch.softmax(y.mean(dim=(1, 2)), dim=-1)
    ema = canary_state.sig_ema
    kl = (sig * (torch.log(sig + 1e-12) - torch.log(ema + 1e-12))).sum(-1)
    backdoor = (kl > CANARY_BACKDOOR_KL) & (count >= warmup)
    flagged = byz | backdoor
    new_ema = torch.where(flagged[:, None], ema, 0.9 * ema + 0.1 * sig)
    # Both references freeze on a flagged stage, or the first clean step
    # after an attack would read as another abrupt change.
    new_prev = torch.where(flagged.reshape((-1,) + (1,) * (y.dim() - 1)),
                           prev, y)
    return CanaryState(prev=new_prev, sig_ema=new_ema, count=count + 1), \
        byz, backdoor


def _check_family(bundle: Any) -> None:
    if bundle.kind != "lm" or hasattr(bundle.config, "n_experts"):
        raise ValueError(
            "pipeline parallelism supports the dense GPT-2 family only "
            "(the reference's partitioner also only implemented GPT)")


def _pipe_forward(pipe_apply: Callable, params: Any, tokens: Tensor,
                  M: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    x = gpt2.embed(params, tokens)
    b, t, d = x.shape
    y_mb, stage_stats, act_mean, act_std = pipe_apply(
        params["blocks"], x.reshape(M, b // M, t, d))
    return y_mb.reshape(b, t, d), stage_stats, act_mean, act_std


PipelineStepFn = Callable[..., Tuple[TrainState, StepMetrics]]


def build_pipeline_train_step(bundle: Any, config: TrainingConfig,
                              optimizer: Optimizer, mesh: Mesh,
                              max_sort: int = 16384,
                              canary: Optional[Tensor] = None
                              ) -> PipelineStepFn:
    """The trusted pipeline step: ``step(state, batch, plan,
    grad_noise=None, stage_noise=None) -> (state, metrics)``, with
    ``state.params["blocks"]`` stage-stacked [S, L/S, ...] and batches
    {'input': [B, T], 'target': [B, T]}, B a multiple of
    ``config.num_microbatches``.  ``grad_noise`` / ``stage_noise`` hand
    the gradient and stage-compute injectors their draws (else they draw
    from ``state.rng``); ``canary`` replaces :func:`make_canary`'s
    input."""
    _check_family(bundle)
    cfg = bundle.config
    S, M = config.num_nodes, config.num_microbatches
    detection = config.attack_detection_enabled
    verification = config.gradient_verification_enabled
    pipe_apply = build_pipeline_apply(cfg, mesh, S, M, max_sort)
    home = stage_devices(mesh)[0]
    canary_const = (make_canary(cfg, config.canary_tokens) if canary is None
                    else canary).to(home)
    logger.info("pipeline schedule: S=%d stages, M=%d microbatches, 1 DP "
                "replica row(s); GPipe bubble fraction %.1f%%", S, M,
                100.0 * bubble_fraction(S, M))

    def train_step(state: TrainState, batch: Dict[str, Tensor],
                   plan: AttackPlan,
                   grad_noise: Optional[Sequence[Tensor]] = None,
                   stage_noise: Optional[Sequence[Tensor]] = None
                   ) -> Tuple[TrainState, StepMetrics]:
        step = state.step
        live = plan.is_live(step)
        # Byzantine compute: the attacked stage's transform is garbage for
        # this step (the forward and the canary probe both ride it); the
        # stored params stay clean.
        fwd_params = state.params
        if live and plan.byzantine:
            block_leaves = tree_leaves(state.params["blocks"])
            fwd_params = dict(state.params)
            fwd_params["blocks"] = tree_unflatten(
                state.params["blocks"], corrupt_stage_compute(
                    plan, block_leaves, step, generator=state.rng,
                    noise=stage_noise))
        with record_function("tddl.forward_backward"):
            leaves = [p.detach().requires_grad_(True)
                      for p in tree_leaves(fwd_params)]
            params = tree_unflatten(fwd_params, leaves)
            with torch.enable_grad():
                y, stage_stats, act_mean, act_std = _pipe_forward(
                    pipe_apply, params, batch["input"], M)
                loss, _ = gpt2.head_loss_and_signature(
                    params, y, batch["target"], cfg)
                grads = tree_unflatten(fwd_params, list(
                    torch.autograd.grad(loss, leaves)))
            del y, params, leaves
        block_grads = tree_leaves(grads["blocks"])
        if live:
            # A compromised stage emits poisoned block gradients (the [S,
            # ...] leading axis maps nodes to stages).
            block_grads = poison_gradients(plan, block_grads, step,
                                           generator=state.rng,
                                           noise=grad_noise)
        with torch.no_grad():
            return _after_backward(state, plan, fwd_params, loss.detach(),
                                   stage_stats, act_mean, act_std, grads,
                                   block_grads)

    def _after_backward(state, plan, fwd_params, loss, stage_stats,
                        act_mean, act_std, grads, block_grads):
        device = loss.device
        now = float(state.step) * config.time_per_step
        with record_function("tddl.detection"):
            # Per-stage gradient batteries: one B1 pass over every stage's
            # block leaves.
            nb = len(block_grads)
            segs = [g[s].reshape(-1) for s in range(S) for g in block_grads]
            moments = _moments(segs).reshape(S, nb, 8)
            per_stage = [gradient_stat_vector(segs[s * nb:(s + 1) * nb],
                                              moments[s], max_sort)
                         for s in range(S)]
            del segs
            grad_stats = torch.stack([p[0] for p in per_stage])
            leaf_norms = torch.stack([p[1] for p in per_stage])
            finite_b = torch.stack([p[2] for p in per_stage])
            global_norms = (leaf_norms * leaf_norms).sum(dim=1).sqrt()

            # Verification verdict (a pure read) before the detector.
            if verification:
                norm_suspect = norm_suspicions(state.verifier, global_norms)
            else:
                norm_suspect = torch.zeros_like(finite_b)

            zeros_b = torch.zeros(S, dtype=torch.bool, device=device)
            if detection:
                warmup = config.detector_warmup
                out_v = anomaly_verdicts(stage_stats, state.out_baseline,
                                         warmup=warmup)
                grad_v = anomaly_verdicts(grad_stats, state.grad_baseline,
                                          warmup=warmup)
                canary_state, byz, backdoor = canary_probe(
                    state.canary, fwd_params["blocks"], canary_const, cfg,
                    warmup)
                # Stages are serially dependent: while a canary-Byzantine
                # verdict is live only the canary localises the culprit.
                byz_any = byz.any()
                stat_cand = grad_v.is_attack & ~byz_any
                candidates = stat_cand | byz | backdoor
                clean_now = ~(candidates | norm_suspect | ~finite_b) \
                    & ~byz_any
                out_bl = bl.push_stats(state.out_baseline, stage_stats,
                                       mask=clean_now)
                grad_bl = bl.push_stats(state.grad_baseline, grad_stats,
                                        mask=clean_now)
                # Canary verdicts confirm at once; the battery debounces.
                attacked = (stat_cand & state.prev_suspects) | byz | backdoor
                out_score, grad_score = out_v.score, grad_v.score
                code = lambda c: torch.full(  # noqa: E731
                    (S,), int(c), dtype=torch.int32, device=device)
                attack_type = torch.where(
                    byz, code(AttackType.BYZANTINE), torch.where(
                        backdoor, code(AttackType.BACKDOOR), torch.where(
                            stat_cand, grad_v.attack_type,
                            out_v.attack_type)))
            else:
                out_bl, grad_bl = state.out_baseline, state.grad_baseline
                canary_state = state.canary
                candidates = attacked = byz = backdoor = zeros_b
                byz_any = torch.zeros((), dtype=torch.bool, device=device)
                out_score = grad_score = torch.zeros(S, device=device)
                attack_type = torch.zeros(S, dtype=torch.int32,
                                          device=device)
                clean_now = finite_b & ~norm_suspect

            # No cross-stage norm gate; a live canary verdict contaminates
            # every stage's gradients, so it is suppressed too.
            norm_suspect = norm_suspect & ~byz_any
            verified = finite_b & ~norm_suspect
            verifier = (absorb_norms(state.verifier, global_norms, clean_now)
                        if verification else state.verifier)
            candidates = candidates | norm_suspect
            attacked = attacked | (norm_suspect & state.prev_suspects)
            trust = ts.mark_compromised(state.trust, attacked | ~finite_b)

            mon = state.monitor
            warm = mon.warm
            exp_std = mon.out_std_avg.clamp(min=1e-6)
            deviation = torch.where(
                warm, torch.clamp(((act_mean - mon.out_mean_avg).abs()
                                   / exp_std
                                   + (act_std - mon.out_std_avg).abs()
                                   / exp_std) / 2.0, max=1.0),
                torch.zeros_like(act_mean))
            per_leaf = torch.clamp(
                leaf_norms / mon.grad_norm_avg.clamp(min=1e-12), max=1.0)
            usable = mon.grad_norm_avg > 0
            consistency = torch.where(
                warm, torch.where(usable, per_leaf, torch.zeros_like(
                    per_leaf)).sum(dim=1) / usable.sum(dim=1).clamp(min=1),
                torch.ones_like(act_mean))
            # Under a live Byzantine verdict every stage's signals come
            # through corrupted activations: the EMA freezes.
            trust = ts.update_trust(trust, deviation, consistency, now,
                                    alpha=config.trust_alpha,
                                    update_mask=(~byz_any).expand(S))
            trust, clean_streak = ts.probation_recovery(
                trust, state.clean_streak,
                verified & ~candidates & ~byz_any,
                config.recovery_probation_steps)

        with record_function("tddl.update"):
            # The gate: a flagged stage's parameters freeze (hard-masked,
            # 0 * NaN = NaN); under a live Byzantine verdict no stage's
            # gradient is trustworthy and the whole update is skipped.
            weights = ts.contribution_weights(trust, verified & ~candidates)
            step_scale = (~byz_any).float()

            def gate_stage(g: Tensor) -> Tensor:
                shape = (S,) + (1,) * (g.dim() - 1)
                gated = torch.where((weights > 0).reshape(shape),
                                    g * weights.reshape(shape).to(g.dtype),
                                    torch.zeros_like(g))
                return gated * step_scale.to(g.dtype)

            def gate_shared(g: Tensor) -> Tensor:
                return torch.where(torch.isfinite(g).all(), g,
                                   torch.zeros_like(g)) \
                    * step_scale.to(g.dtype)

            gated = {k: (tree_unflatten(v, [gate_stage(g)
                                            for g in block_grads])
                         if k == "blocks" else map_tree(gate_shared, v))
                     for k, v in grads.items()}
            del grads, block_grads
            agg = tree_leaves(gated)
            param_leaves = tree_leaves(state.params)
            new_leaves, opt_state = guarded_update(
                ~byz_any & (weights.sum() > 0), optimizer, agg,
                state.opt_state, param_leaves)
            monitor = update_monitor(mon, act_mean, act_std, leaf_norms,
                                     verified & ~candidates & ~byz_any)
        new_state = state._replace(
            params=tree_unflatten(state.params, new_leaves),
            opt_state=opt_state, trust=trust, out_baseline=out_bl,
            grad_baseline=grad_bl, verifier=verifier, monitor=monitor,
            prev_suspects=candidates, step=state.step + 1,
            canary=canary_state, clean_streak=clean_streak)
        metrics = StepMetrics(
            loss=loss, per_node_loss=loss.expand(S), trust_scores=trust.scores,
            status=trust.status, attacked=attacked, verified=verified,
            finite=finite_b, weights=weights,
            system_trust=ts.system_trust(trust), grad_norm=global_norm(agg),
            out_score=out_score, grad_score=grad_score,
            attack_type=attack_type, byzantine=byz, backdoor=backdoor,
            out_stats=stage_stats, grad_stats=grad_stats)
        return new_state, metrics

    return train_step


def build_pipeline_eval_step(bundle: Any, config: TrainingConfig,
                             mesh: Mesh) -> Callable[[Any, Dict[str, Tensor]],
                                                     Dict[str, Tensor]]:
    """Validation through the pipeline on [B, T] batches (B a multiple
    of ``num_microbatches``): {'loss', 'accuracy'}, through the fused
    eval head where ``lm_head_chunk`` resolves to a width."""
    _check_family(bundle)
    cfg = bundle.config
    M = config.num_microbatches
    pipe_apply = build_pipeline_apply(cfg, mesh, config.num_nodes, M)

    @torch.no_grad()
    def eval_step(params: Any, batch: Dict[str, Tensor]
                  ) -> Dict[str, Tensor]:
        y = _pipe_forward(pipe_apply, params, batch["input"], M)[0]
        chunk = gpt2.resolve_lm_head_chunk(cfg, batch["target"].numel())
        if chunk:
            from trustworthy_dl_tpu_torch.ops.fused_ce import fused_lm_eval

            loss, acc = fused_lm_eval(L.layernorm(params["ln_f"], y),
                                      params["wte"], batch["target"], chunk,
                                      cfg.dtype)
            return {"loss": loss, "accuracy": acc}
        logits = gpt2.unembed(params, y, cfg)
        return {"loss": L.cross_entropy_loss(logits, batch["target"]),
                "accuracy": L.accuracy(logits, batch["target"])}

    return eval_step


__all__ = ["CANARY_BACKDOOR_KL", "CANARY_BYZ_REL_CHANGE", "CANARY_SEED",
           "CanaryState", "bubble_fraction", "build_pipeline_apply",
           "build_pipeline_eval_step", "build_pipeline_train_step",
           "canary_probe", "choose_num_microbatches", "init_canary_state",
           "make_canary", "stack_stages", "stage_forward", "unstack_stages"]
