"""Rolling statistical baselines as a fixed-shape ring buffer.

Counterpart of ``trustworthy_dl_tpu/detect/baseline.py``, on host (CPU)
f32 tensors: a ring [n, K, S] of the last K stat vectors per node with a
monotonic write count, and masked mean/std over the valid window.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class BaselineState(NamedTuple):
    ring: torch.Tensor   # f32 [n, K, S]
    count: torch.Tensor  # i64 [n], total writes per node


def init_baseline_state(num_nodes: int, window: int, num_stats: int
                        ) -> BaselineState:
    return BaselineState(
        ring=torch.zeros(num_nodes, window, num_stats, dtype=torch.float32),
        count=torch.zeros(num_nodes, dtype=torch.int64))


def push_stats(state: BaselineState, stats: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> BaselineState:
    """Append one stat vector per node ([n, S]); ``mask`` ([n] bool) skips
    nodes that produced no signal."""
    n, window, _ = state.ring.shape
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool)
    rows = torch.arange(n)
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
    mask = (torch.arange(window)[None, :] < valid[:, None]).float()[..., None]
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
