"""Training-step state: everything one step reads and returns.

Counterpart of ``trustworthy_dl_tpu/engine/state.py``.  The whole
world-view (params, optimizer state, trust, detector baselines, verifier,
monitor) is one :class:`TrainState` of tensors on the step's device, so
the step needs no host round-trip.  Two fields differ in kind from the
JAX package: ``step`` and ``epoch`` are host ints (so
``plan.is_live(step)`` and the trust clock need no device sync), and
``rng`` is a ``torch.Generator`` on the device.
:func:`zero1_place_opt_state` is JAX's ZeRO-1 delegate.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from trustworthy_dl_tpu_torch.detect.baseline import BaselineState, \
    init_baseline_state
from trustworthy_dl_tpu_torch.detect.stats import NUM_GRADIENT_STATS
from trustworthy_dl_tpu_torch.detect.verifier import VerifierState, \
    init_verifier_state
from trustworthy_dl_tpu_torch.engine.optimizer import OptState
from trustworthy_dl_tpu_torch.trust.state import TrustState, \
    init_trust_state
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves


class MonitorState(NamedTuple):
    """Per-node expected output mean/std and per-leaf gradient norms, as
    running averages over the samples that passed every check."""

    count: torch.Tensor          # i32 [n]
    out_mean_avg: torch.Tensor   # f32 [n]
    out_std_avg: torch.Tensor    # f32 [n]
    grad_norm_avg: torch.Tensor  # f32 [n, L]

    @property
    def warm(self) -> torch.Tensor:
        return self.count >= 5


def init_monitor_state(num_nodes: int, num_leaves: int,
                       device: Any = "cpu") -> MonitorState:
    zeros = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    return MonitorState(
        count=torch.zeros(num_nodes, dtype=torch.int32, device=device),
        out_mean_avg=zeros(num_nodes), out_std_avg=zeros(num_nodes),
        grad_norm_avg=zeros(num_nodes, num_leaves))


def update_monitor(state: MonitorState, out_mean: torch.Tensor,
                   out_std: torch.Tensor, leaf_norms: torch.Tensor,
                   absorb: torch.Tensor) -> MonitorState:
    """Running-average update for the nodes with ``absorb`` True."""
    new_count = state.count + absorb.int()
    w = 1.0 / new_count.float().clamp(min=1.0)

    def upd(avg, x, wexp):
        mask = absorb.reshape(absorb.shape + (1,) * (avg.dim() - 1))
        return torch.where(mask, avg + (x - avg) * wexp, avg)

    return MonitorState(count=new_count,
                        out_mean_avg=upd(state.out_mean_avg, out_mean, w),
                        out_std_avg=upd(state.out_std_avg, out_std, w),
                        grad_norm_avg=upd(state.grad_norm_avg, leaf_norms,
                                          w[:, None]))


class TrainState(NamedTuple):
    """The full training world-view."""

    params: Any                   # nested dict of f32 master weights
    opt_state: OptState
    trust: TrustState
    out_baseline: BaselineState
    grad_baseline: BaselineState
    verifier: VerifierState
    monitor: MonitorState
    prev_suspects: torch.Tensor   # bool [n] last step's candidates
    step: int
    epoch: int
    rng: torch.Generator
    clean_streak: torch.Tensor    # i32 [n] consecutive clean steps
    fleet_norm: VerifierState     # 1-row Welford of the median log-norm
    fleet_raw_streak: torch.Tensor  # i32 [1]
    # Pipeline mode's per-stage canary reference
    # (``parallel/pipeline.CanaryState``); None in the other modes.
    canary: Any = None


def init_train_state(rng: torch.Generator, params: Any, opt_state: OptState,
                     num_nodes: int, trust_threshold: float = 0.7,
                     initial_trust: float = 1.0, decay_rate: float = 0.01,
                     recovery_rate: float = 0.005,
                     detector_window: int = 1000,
                     device: Optional[Any] = None,
                     num_monitor_leaves: Optional[int] = None,
                     canary: Any = None) -> TrainState:
    """Fresh state for ``num_nodes`` nodes on the params' device.  The
    monitor tracks ``num_monitor_leaves`` gradient leaves a node (default
    every param leaf; a pipeline stage's are its block leaves)."""
    leaves = tree_leaves(params)
    device = leaves[0].device if device is None else torch.device(device)
    n = num_nodes
    return TrainState(
        params=params, opt_state=opt_state,
        trust=init_trust_state(n, trust_threshold, initial_trust, decay_rate,
                               recovery_rate, device=device),
        out_baseline=init_baseline_state(n, detector_window,
                                         NUM_GRADIENT_STATS, device=device),
        grad_baseline=init_baseline_state(n, detector_window,
                                          NUM_GRADIENT_STATS, device=device),
        verifier=init_verifier_state(n, device),
        monitor=init_monitor_state(
            n, len(leaves) if num_monitor_leaves is None
            else num_monitor_leaves, device),
        prev_suspects=torch.zeros(n, dtype=torch.bool, device=device),
        step=0, epoch=0, rng=rng,
        clean_streak=torch.zeros(n, dtype=torch.int32, device=device),
        fleet_norm=init_verifier_state(1, device),
        fleet_raw_streak=torch.zeros(1, dtype=torch.int32, device=device),
        canary=canary)


def fleet_scalar_fields(state: TrainState) -> Dict[str, Any]:
    """The fleet-alarm fields, which move like the scalars (replicated):
    one definition for every site that places the state, so none drops a
    new field."""
    return {k: v for k, v in dict(
        fleet_norm=state.fleet_norm,
        fleet_raw_streak=state.fleet_raw_streak).items() if v is not None}


def zero1_place_opt_state(opt_state: OptState, mesh: Any
                          ) -> Tuple[OptState, Dict[str, Any]]:
    """ZeRO-1 placement: (the optimizer state on the mesh, its specs),
    every moment sharded over the mesh's data axis on its first
    evenly-divisible dim, the count and indivisible leaves replicated.
    A thin delegate, as in JAX: the rule is the registry's
    ``place_zero_sharded``, shared with FSDP and elastic migration."""
    from trustworthy_dl_tpu_torch.core import sharding as shreg
    from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS

    placed, specs = shreg.place_zero_sharded(
        shreg.opt_state_tree(opt_state), mesh, DATA_AXIS)
    return OptState(placed["count"], placed["mu"], placed["nu"]), specs


__all__ = ["MonitorState", "TrainState", "fleet_scalar_fields",
           "init_monitor_state", "init_train_state", "update_monitor",
           "zero1_place_opt_state"]
