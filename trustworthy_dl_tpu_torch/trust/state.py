"""Trust state as tensors with pure update functions.

Counterpart of ``trustworthy_dl_tpu/trust/state.py``: fixed-shape per-node
tensors, so the whole trust update runs inside the training step with no
host round-trip.  The math is the JAX package's:

* a 6-component weighted score, weights {output_deviation 0.3,
  gradient_consistency 0.3, communication_latency 0.1,
  resource_utilization 0.1, error_rate 0.15, uptime 0.05}, components
  mapped higher-is-better (latency normalised by 10);
* an EMA blend with temporal decay:
  final = (1 - alpha) * old * exp(-decay_rate * dt) + alpha * new,
  clipped to [0, 1];
* the 5-state status machine in the reference's branch order (a
  COMPROMISED node with trust in [threshold, 0.8] jumps to TRUSTED).

Every function keeps its inputs' device.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch


class NodeStatus(enum.IntEnum):
    """Node status codes, as an i32 tensor holds them."""

    TRUSTED = 0
    SUSPICIOUS = 1
    COMPROMISED = 2
    RECOVERING = 3
    OFFLINE = 4

    @property
    def label(self) -> str:
        return self.name.lower()


# Metric component order for the [n, 6] metrics tensor.
METRIC_NAMES = (
    "output_deviation",
    "gradient_consistency",
    "communication_latency",
    "resource_utilization",
    "error_rate",
    "uptime",
)
TRUST_WEIGHTS = (0.3, 0.3, 0.1, 0.1, 0.15, 0.05)
METRIC_DEFAULTS = (0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class TrustState(NamedTuple):
    """Per-node trust world-view, carried through the step."""

    scores: torch.Tensor        # f32 [n] trust in [0, 1]
    status: torch.Tensor        # i32 [n] NodeStatus codes
    update_count: torch.Tensor  # i32 [n]
    last_updated: torch.Tensor  # f32 [n] clock of last update
    decay_rate: torch.Tensor    # f32 [n]
    recovery_rate: torch.Tensor # f32 [n]
    metrics: torch.Tensor       # f32 [n, 6] last metrics per node
    threshold: torch.Tensor     # f32 [] current (adaptive) threshold
    attack_count: torch.Tensor  # i32 [n]

    @property
    def num_nodes(self) -> int:
        return self.scores.shape[0]


def init_trust_state(num_nodes: int, trust_threshold: float = 0.7,
                     initial_trust: float = 1.0, decay_rate: float = 0.01,
                     recovery_rate: float = 0.005, now: float = 0.0,
                     device: torch.device | str = "cpu") -> TrustState:
    n = num_nodes

    def full(value, dtype=torch.float32):
        return torch.full((n,), value, dtype=dtype, device=device)

    return TrustState(
        scores=full(initial_trust),
        status=full(0, torch.int32),
        update_count=full(0, torch.int32),
        last_updated=full(now),
        decay_rate=full(decay_rate),
        recovery_rate=full(recovery_rate),
        metrics=torch.tensor(METRIC_DEFAULTS, dtype=torch.float32,
                             device=device).repeat(n, 1),
        threshold=torch.tensor(trust_threshold, dtype=torch.float32,
                               device=device),
        attack_count=full(0, torch.int32),
    )


def instantaneous_trust(metrics: torch.Tensor) -> torch.Tensor:
    """Weighted 6-component score of metrics [..., 6]."""
    one = torch.ones_like(metrics[..., 0])
    components = torch.stack([
        one - torch.minimum(one, metrics[..., 0]),
        metrics[..., 1],
        one - torch.minimum(one, metrics[..., 2] / 10.0),
        torch.minimum(one, metrics[..., 3]),
        one - torch.minimum(one, metrics[..., 4]),
        metrics[..., 5],
    ], dim=-1)
    return (components @ _trust_weights(metrics.device)).clamp(0.0, 1.0)


@functools.lru_cache(maxsize=None)
def _trust_weights(device: torch.device) -> torch.Tensor:
    """f32 [6] ``TRUST_WEIGHTS``, built once per device (a fresh
    ``torch.tensor`` on a card is a blocking copy in every step).  Read
    only."""
    return torch.tensor(TRUST_WEIGHTS, dtype=torch.float32, device=device)


def next_status(status: torch.Tensor, trust: torch.Tensor,
                threshold: torch.Tensor) -> torch.Tensor:
    """Vectorised status machine, reference branch order (the first
    matching condition wins)."""
    compromised = status == NodeStatus.COMPROMISED
    recovering = status == NodeStatus.RECOVERING
    rules = (
        (trust < 0.3, NodeStatus.COMPROMISED),
        (trust < threshold, NodeStatus.SUSPICIOUS),
        (compromised & (trust > 0.8), NodeStatus.RECOVERING),
        (recovering & (trust > 0.9), NodeStatus.TRUSTED),
        (trust >= threshold, NodeStatus.TRUSTED),
    )
    out = status
    for cond, code in reversed(rules):
        out = torch.where(cond, torch.full_like(status, int(code)), out)
    return out


def update_trust(state: TrustState, output_deviation: torch.Tensor,
                 gradient_consistency: torch.Tensor,
                 now: Union[torch.Tensor, float],
                 extra_metrics: Optional[torch.Tensor] = None,
                 update_mask: Optional[torch.Tensor] = None,
                 alpha: float = 0.1) -> TrustState:
    """One trust update for all nodes at once.  ``extra_metrics`` ([n, 4])
    supplies columns 2..5; ``update_mask`` ([n] bool) leaves masked-out
    nodes untouched."""
    if not isinstance(now, torch.Tensor):
        # A fill on the device, not a blocking host-to-device copy.
        now = torch.full((), now, dtype=torch.float32,
                         device=state.scores.device)
    now = now.to(device=state.scores.device, dtype=torch.float32)
    metrics = state.metrics.clone()
    metrics[:, 0] = output_deviation.float()
    metrics[:, 1] = gradient_consistency.float()
    if extra_metrics is not None:
        metrics[:, 2:6] = extra_metrics.float()

    new_trust = instantaneous_trust(metrics)
    decay = torch.exp(-state.decay_rate * (now - state.last_updated))
    final = ((1.0 - alpha) * state.scores * decay
             + alpha * new_trust).clamp(0.0, 1.0)
    if update_mask is None:
        update_mask = torch.ones_like(final, dtype=torch.bool)
    final = torch.where(update_mask, final, state.scores)
    metrics = torch.where(update_mask[:, None], metrics, state.metrics)
    status = torch.where(update_mask,
                         next_status(state.status, final, state.threshold),
                         state.status)
    return state._replace(
        scores=final, status=status,
        update_count=state.update_count + update_mask.int(),
        last_updated=torch.where(update_mask, now, state.last_updated),
        metrics=metrics)


def mark_compromised(state: TrustState, node_mask: torch.Tensor
                     ) -> TrustState:
    """Force trust to 0.1 and status to COMPROMISED for masked nodes, and
    count the attack."""
    node_mask = node_mask.bool()
    return state._replace(
        scores=torch.where(node_mask, torch.full_like(state.scores, 0.1),
                           state.scores),
        status=torch.where(node_mask, torch.full_like(
            state.status, int(NodeStatus.COMPROMISED)), state.status),
        attack_count=state.attack_count + node_mask.int())


def initiate_recovery(state: TrustState, node_mask: torch.Tensor
                      ) -> TrustState:
    """COMPROMISED -> RECOVERING with the boosted recovery rate."""
    eligible = node_mask.bool() & (state.status == NodeStatus.COMPROMISED)
    return state._replace(
        status=torch.where(eligible, torch.full_like(
            state.status, int(NodeStatus.RECOVERING)), state.status),
        recovery_rate=torch.where(eligible, torch.full_like(
            state.recovery_rate, 0.02), state.recovery_rate))


def probation_recovery(state: TrustState, clean_streak: torch.Tensor,
                       clean_now: torch.Tensor, probation_steps: int
                       ) -> Tuple[TrustState, torch.Tensor]:
    """After ``probation_steps`` consecutive clean steps a COMPROMISED node
    turns RECOVERING with its trust floored at 0.5.  Returns (state,
    clean streak)."""
    streak = torch.where(clean_now.bool(), clean_streak + 1,
                         torch.zeros_like(clean_streak))
    if probation_steps <= 0:
        return state, streak
    rehab = (streak >= probation_steps) & (
        state.status == NodeStatus.COMPROMISED)
    new = initiate_recovery(state, rehab)
    new = new._replace(scores=torch.where(
        rehab, new.scores.clamp(min=0.5), new.scores))
    return new, torch.where(rehab, torch.zeros_like(streak), streak)


def can_assign_task(state: TrustState) -> torch.Tensor:
    """bool [n]: TRUSTED or RECOVERING."""
    return (state.status == NodeStatus.TRUSTED) | (
        state.status == NodeStatus.RECOVERING)


def contribution_weights(state: TrustState,
                         verdict_ok: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """f32 [n] gradient-contribution gate: a node contributes iff its
    status allows (TRUSTED, RECOVERING or SUSPICIOUS) and, when given,
    this step's verdict passed."""
    ok = can_assign_task(state) | (state.status == NodeStatus.SUSPICIOUS)
    if verdict_ok is not None:
        ok = ok & verdict_ok.bool()
    return ok.float()


def select_best_nodes(state: TrustState, k: int) -> torch.Tensor:
    """i64 [k]: the k assignable nodes of highest trust, best first, -1
    where fewer than k are assignable.  Equal scores keep the lower index
    first (``jax.lax.top_k``'s order), through a stable sort."""
    if not 0 <= k <= state.scores.shape[0]:
        raise ValueError(f"k={k} outside [0, {state.scores.shape[0]}]")
    score = torch.where(can_assign_task(state), state.scores,
                        torch.full_like(state.scores, -torch.inf))
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    return torch.where(top > -torch.inf, idx, torch.full_like(idx, -1))


def system_trust(state: TrustState) -> torch.Tensor:
    """Self-weighted average of the scores."""
    s = state.scores
    return (s * s).sum() / s.sum().clamp(min=1e-12)


def adaptive_threshold(state: TrustState, default: float = 0.7
                       ) -> TrustState:
    """Adaptive threshold: low mean trust lowers it (floor 0.3), high mean
    trust raises it (cap 0.8), otherwise it relaxes toward ``default``."""
    mean = state.scores.mean()
    thr = state.threshold
    new = torch.where(
        mean < 0.5, torch.clamp(mean - 0.1, min=0.3),
        torch.where(mean > 0.9, torch.clamp(mean - 0.1, max=0.8),
                    thr + 0.01 * (default - thr)))
    return state._replace(threshold=new)


def predict_reliability(history: torch.Tensor, valid_count: torch.Tensor,
                        horizon: int = 10) -> torch.Tensor:
    """Degree-1 least-squares trend over each node's recent trust samples,
    extrapolated ``horizon`` steps.  ``history`` is f32 [n, window] (most
    recent last, left-padded), ``valid_count`` [n] the number of valid
    entries; a node with fewer than 5 samples keeps its latest score.  The
    JAX package's arithmetic, in f32."""
    history = history.float()
    n, window = history.shape
    count = valid_count.float()
    x = torch.arange(window, dtype=torch.float32, device=history.device)
    first = (window - count)[:, None]
    mask = x[None, :] >= first
    cnt = mask.sum(dim=1).float().clamp(min=1.0)
    # Re-indexed so the first valid sample sits at x = 0.
    zero = torch.zeros_like(history)
    x_local = torch.where(mask, x[None, :] - first, zero)
    y = torch.where(mask, history, zero)
    xm = x_local.sum(dim=1) / cnt
    ym = y.sum(dim=1) / cnt
    cov = torch.where(mask, (x_local - xm[:, None]) * (history - ym[:, None]),
                      zero).sum(dim=1)
    var = torch.where(mask, (x_local - xm[:, None]) ** 2, zero).sum(dim=1)
    slope = torch.where(var > 0, cov / var.clamp(min=1e-12),
                        torch.zeros_like(var))
    intercept = ym - slope * xm
    pred = slope * (count + horizon) + intercept
    return torch.where(valid_count >= 5, pred, history[:, -1]).clamp(0.0,
                                                                      1.0)


__all__ = [
    "METRIC_NAMES", "NodeStatus", "TrustState", "adaptive_threshold",
    "can_assign_task", "contribution_weights", "init_trust_state",
    "initiate_recovery", "instantaneous_trust", "mark_compromised",
    "next_status", "predict_reliability", "probation_recovery",
    "select_best_nodes", "system_trust", "update_trust",
]
