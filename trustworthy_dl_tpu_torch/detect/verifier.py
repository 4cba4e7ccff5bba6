"""Gradient verification: per-node log-norm Welford baselines and the
fleet-level norm-surge alarm.

Counterpart of ``trustworthy_dl_tpu/detect/verifier.py`` (the in-step
functions, the host episode tracker and the host :class:`GradientVerifier`).
Gradients are valid iff finite and their global L2 norm is not an extreme
outlier against the node's own history (z in log space, widened for young
baselines); the verdict is a pure read (:func:`norm_suspicions`) and
absorption a separate step (:func:`absorb_norms`), so the caller absorbs by
its final judgement.  :func:`verify_gradients_array` composes the two.
"""

from __future__ import annotations

import logging
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_NORM_Z = 6.0
DEFAULT_WARMUP = 10
FLEET_WARMUP = 8
FLEET_LATCH_LIMIT = 50  # forced absorption after this many raw steps


class VerifierState(NamedTuple):
    """Per-row rolling log-norm statistics (Welford)."""

    count: torch.Tensor  # i32 [n]
    mean: torch.Tensor   # f32 [n]
    m2: torch.Tensor     # f32 [n]


def init_verifier_state(num_nodes: int, device: torch.device | str = "cpu"
                        ) -> VerifierState:
    return VerifierState(
        count=torch.zeros(num_nodes, dtype=torch.int32, device=device),
        mean=torch.zeros(num_nodes, dtype=torch.float32, device=device),
        m2=torch.zeros(num_nodes, dtype=torch.float32, device=device))


def _log_norm(grad_norms: torch.Tensor) -> torch.Tensor:
    return grad_norms.clamp(min=1e-30).log()


def _z_and_threshold(state: VerifierState, log_norm: torch.Tensor,
                     norm_z_threshold: float, one_sided: bool):
    cnt = state.count.float()
    std = (state.m2 / cnt.clamp(min=1.0)).sqrt()
    dev = log_norm - state.mean
    if not one_sided:
        dev = dev.abs()
    safe = torch.where(std > 0, std, torch.ones_like(std))
    z = torch.where(std > 0, dev / safe, torch.zeros_like(std))
    thr = norm_z_threshold * (1.0 + 8.0 / cnt.clamp(min=1.0))
    return z, thr


def norm_suspicions(state: VerifierState, grad_norms: torch.Tensor,
                    norm_z_threshold: float = DEFAULT_NORM_Z,
                    warmup: int = DEFAULT_WARMUP) -> torch.Tensor:
    """bool [n] raw statistical verdict; no state change."""
    z, thr = _z_and_threshold(state, _log_norm(grad_norms),
                              norm_z_threshold, one_sided=False)
    return (state.count >= warmup) & (z >= thr)


def absorb_norms(state: VerifierState, grad_norms: torch.Tensor,
                 mask: torch.Tensor) -> VerifierState:
    """Welford-absorb this step's log-norms where ``mask`` holds."""
    log_norm = _log_norm(grad_norms)
    new_count = state.count + mask.int()
    delta = log_norm - state.mean
    new_mean = torch.where(
        mask, state.mean + delta / new_count.float().clamp(min=1.0),
        state.mean)
    new_m2 = torch.where(mask, state.m2 + delta * (log_norm - new_mean),
                         state.m2)
    return VerifierState(count=new_count, mean=new_mean, m2=new_m2)


def verify_gradients_array(
        state: VerifierState, grad_norms: torch.Tensor,
        all_finite: torch.Tensor, norm_z_threshold: float = DEFAULT_NORM_Z,
        warmup: int = DEFAULT_WARMUP,
        update_mask: Optional[torch.Tensor] = None
) -> Tuple[VerifierState, torch.Tensor, torch.Tensor]:
    """One-shot verify-and-absorb: ``grad_norms`` f32 [n] (each node's
    global L2 norm), ``all_finite`` bool [n].  Returns (new state, valid
    bool [n], norm_suspect bool [n]) with ``valid = finite & ~suspect &
    update_mask`` (the mask defaults to all-true); the baseline absorbs
    exactly the valid samples, so a poisoned norm never enters its own
    baseline."""
    if update_mask is None:
        update_mask = torch.ones_like(all_finite, dtype=torch.bool)
    suspect = norm_suspicions(state, grad_norms, norm_z_threshold, warmup)
    valid = all_finite.bool() & ~suspect & update_mask.bool()
    return absorb_norms(state, grad_norms, valid), valid, suspect


def _host_f32(gradient: Any) -> np.ndarray:
    """One gradient leaf as flat host f32 (a tensor on any device, or
    anything ``np.asarray`` reads)."""
    if isinstance(gradient, torch.Tensor):
        gradient = gradient.detach().to("cpu", torch.float32).numpy()
    return np.asarray(gradient, np.float32).reshape(-1)


class GradientVerifier:
    """Host verifier with the reference's call signature
    (``distributed_trainer.py:199-201``): one node's gradient leaves in,
    a bool out.  The norm is computed on the host as JAX's is (numpy f32,
    one ``sum(f * f)`` a leaf, summed as Python floats), so the verdicts
    equal JAX's; the Welford state lives on ``device`` (default the
    CPU)."""

    def __init__(self, norm_z_threshold: float = DEFAULT_NORM_Z,
                 warmup: int = DEFAULT_WARMUP, max_nodes: int = 256,
                 device: Any = "cpu"):
        self.norm_z_threshold = norm_z_threshold
        self.warmup = warmup
        self.device = torch.device(device)
        self._state = init_verifier_state(max_nodes, self.device)
        self._max_nodes = max_nodes

    def _row(self, node_id: int, value: Any, dtype: torch.dtype
             ) -> torch.Tensor:
        row = torch.zeros(self._max_nodes, dtype=dtype, device=self.device)
        row[node_id] = value
        return row

    def verify_gradients(self, gradients: Sequence[Any], node_id: int,
                         step: int) -> bool:
        if gradients is None or len(gradients) == 0:
            return False
        flats = [_host_f32(g) for g in gradients]
        all_finite = all(bool(np.all(np.isfinite(f))) for f in flats)
        norm = float(np.sqrt(sum(float(np.sum(f * f)) for f in flats)))
        self._state, valid, _ = verify_gradients_array(
            self._state, self._row(node_id, norm, torch.float32),
            self._row(node_id, all_finite, torch.bool),
            self.norm_z_threshold, self.warmup,
            self._row(node_id, True, torch.bool))
        ok = bool(valid[node_id])
        if not ok:
            logger.warning("Gradient verification failed for node %d at "
                           "step %d", node_id, step)
        return ok

    def reset_node(self, node_id: int) -> None:
        """Forget one node's history (a fresh warm-up)."""
        row = torch.tensor([node_id], device=self.device)
        self._state = VerifierState(
            *(t.index_fill(0, row, 0) for t in self._state))


def fleet_surge_update(state: VerifierState, median_norm: torch.Tensor,
                       raw_streak: torch.Tensor,
                       norm_z_threshold: float = DEFAULT_NORM_Z
                       ) -> Tuple[torch.Tensor, VerifierState, torch.Tensor]:
    """Fleet-level norm-surge verdict and absorption: the cross-node median
    norm (f32 [1]) z-scored one-sided against its own history.  Returns
    (raw bool [1], new state, new streak i32 [1]); a surge is not absorbed
    until it has lasted FLEET_LATCH_LIMIT steps."""
    z, thr = _z_and_threshold(state, _log_norm(median_norm),
                              norm_z_threshold, one_sided=True)
    raw = (state.count >= FLEET_WARMUP) & (z >= thr)
    new_streak = torch.where(raw, raw_streak + 1,
                             torch.zeros_like(raw_streak))
    absorb = ~raw | (raw_streak >= FLEET_LATCH_LIMIT)
    return raw, absorb_norms(state, median_norm, absorb), new_streak


class FleetEpisodeTracker:
    """Host bookkeeping of fleet norm-surge episodes: opened on the rising
    edge of the debounced alarm, closed on the falling edge as
    "recovered" or, when the latch re-baselined a surge that never
    stopped, "absorbed-while-raw"."""

    def __init__(self, latch_limit: int = FLEET_LATCH_LIMIT):
        self.latch_limit = latch_limit
        self.episodes: List[dict] = []
        self._open = False
        self._peak_streak = 0

    @property
    def alarm_open(self) -> bool:
        return self._open

    def update(self, alert: bool, raw_streak: int, step: int,
               extra: Optional[dict] = None) -> Optional[dict]:
        """Feed one step; returns the episode on the step it opens."""
        if alert:
            self._peak_streak = max(self._peak_streak, int(raw_streak))
            if not self._open:
                self._open = True
                episode = {"step": int(step), "resolution": None,
                           **(extra or {})}
                self.episodes.append(episode)
                return episode
        elif self._open:
            self._open = False
            episode = self.episodes[-1]
            episode["resolved_step"] = int(step)
            episode["peak_raw_streak"] = self._peak_streak
            episode["resolution"] = (
                "absorbed-while-raw" if self._peak_streak >= self.latch_limit
                else "recovered")
            logger.info("fleet norm-surge episode (opened step %d) closed "
                        "at step %d: %s", episode["step"], int(step),
                        episode["resolution"])
            self._peak_streak = 0
        return None


__all__ = [
    "DEFAULT_NORM_Z", "DEFAULT_WARMUP", "FLEET_LATCH_LIMIT", "FLEET_WARMUP",
    "FleetEpisodeTracker", "GradientVerifier", "VerifierState",
    "absorb_norms", "fleet_surge_update", "init_verifier_state",
    "norm_suspicions", "verify_gradients_array",
]
