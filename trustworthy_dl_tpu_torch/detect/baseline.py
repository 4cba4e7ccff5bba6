"""Rolling statistical baselines as a fixed-shape ring buffer.

Counterpart of ``trustworthy_dl_tpu/detect/baseline.py``: a ring [n, K, S]
of the last K stat vectors per node with a monotonic write count, and
masked mean/std over the valid window.  Every tensor lives on the device
the caller names at construction (the serving monitor keeps host tensors,
the training step keeps its baselines on the card), and every tensor the
functions build follows the state's device.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch


class BaselineState(NamedTuple):
    ring: torch.Tensor   # f32 [n, K, S]
    count: torch.Tensor  # i64 [n], total writes per node

    @property
    def num_nodes(self) -> int:
        return self.ring.shape[0]

    @property
    def window(self) -> int:
        return self.ring.shape[1]


def init_baseline_state(num_nodes: int, window: int, num_stats: int, *,
                        device: Any) -> BaselineState:
    return BaselineState(
        ring=torch.zeros(num_nodes, window, num_stats, dtype=torch.float32,
                         device=device),
        count=torch.zeros(num_nodes, dtype=torch.int64, device=device))


def push_stats(state: BaselineState, stats: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> BaselineState:
    """Append one stat vector per node ([n, S]); ``mask`` ([n] bool) skips
    nodes that produced no signal."""
    n, window, _ = state.ring.shape
    device = state.ring.device
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=device)
    rows = torch.arange(n, device=device)
    idx = state.count % window
    ring = state.ring.clone()
    ring[rows, idx] = torch.where(mask[:, None], stats.float(),
                                  state.ring[rows, idx])
    return BaselineState(ring=ring, count=state.count + mask.long())


def baseline_moments(state: BaselineState
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean [n, S], population std [n, S], valid count [n]) over the
    valid window."""
    n, window, _ = state.ring.shape
    valid = state.count.clamp(max=window)
    slot = torch.arange(window, device=state.ring.device)
    mask = (slot[None, :] < valid[:, None]).float()[..., None]
    denom = valid.float().clamp(min=1.0)[:, None]
    mean = (state.ring * mask).sum(dim=1) / denom
    var = (((state.ring - mean[:, None, :]) ** 2) * mask).sum(dim=1) / denom
    return mean, var.sqrt(), valid


def zscores(stats: torch.Tensor, mean: torch.Tensor, std: torch.Tensor
            ) -> torch.Tensor:
    """Per-stat |z|; a zero-variance stat reports 0."""
    safe = torch.where(std > 0, std, torch.ones_like(std))
    return torch.where(std > 0, (stats - mean).abs() / safe,
                       torch.zeros_like(std))
