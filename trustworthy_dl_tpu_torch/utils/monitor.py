"""NodeMonitor: per-node expected output and gradient behaviour on the
host.

Counterpart of ``trustworthy_dl_tpu/utils/monitor.py``.  The live running
averages are the step's ``MonitorState`` (``engine/state.py``); this class
mirrors them for the host API (``get_expected_mean`` / ``_std`` /
``get_expected_gradient_norms``) and for loops driven from the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class NodeMonitor:
    """Per-node expected output/gradient behaviour (running averages)."""

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self._count: Dict[int, int] = {}
        self._mean_avg: Dict[int, float] = {}
        self._std_avg: Dict[int, float] = {}
        self._grad_norms_avg: Dict[int, np.ndarray] = {}

    def observe_output(self, node_id: int, mean: float, std: float) -> None:
        c = self._count.get(node_id, 0) + 1
        w = 1.0 / c
        self._mean_avg[node_id] = (self._mean_avg.get(node_id, 0.0)
                                   * (1 - w) + mean * w)
        self._std_avg[node_id] = (self._std_avg.get(node_id, 0.0)
                                  * (1 - w) + std * w)
        self._count[node_id] = c

    def observe_gradient_norms(self, node_id: int,
                               norms: Sequence[float]) -> None:
        arr = np.asarray(norms, np.float64)
        prev = self._grad_norms_avg.get(node_id)
        if prev is None or prev.shape != arr.shape:
            self._grad_norms_avg[node_id] = arr
        else:
            w = 1.0 / max(self._count.get(node_id, 1), 1)
            self._grad_norms_avg[node_id] = prev * (1 - w) + arr * w

    def sync_from_device(self, monitor_state,
                         node_ids: Optional[Sequence[int]] = None) -> None:
        """Absorb the step's ``MonitorState``; ``node_ids`` maps its rows
        to node ids."""
        counts = monitor_state.count.cpu().numpy()
        means = monitor_state.out_mean_avg.cpu().numpy()
        stds = monitor_state.out_std_avg.cpu().numpy()
        norms = monitor_state.grad_norm_avg.cpu().numpy()
        if node_ids is None:
            node_ids = list(range(counts.shape[0]))
        for coord, i in enumerate(node_ids):
            self._count[i] = int(counts[coord])
            self._mean_avg[i] = float(means[coord])
            self._std_avg[i] = float(stds[coord])
            self._grad_norms_avg[i] = norms[coord].astype(np.float64)

    def get_expected_mean(self, node_id: int) -> Optional[float]:
        if self._count.get(node_id, 0) < self.warmup:
            return None
        return self._mean_avg.get(node_id)

    def get_expected_std(self, node_id: int) -> Optional[float]:
        if self._count.get(node_id, 0) < self.warmup:
            return None
        return self._std_avg.get(node_id)

    def get_expected_gradient_norms(self, node_id: int) -> List[float]:
        if self._count.get(node_id, 0) < self.warmup:
            return []
        arr = self._grad_norms_avg.get(node_id)
        return [] if arr is None else [float(v) for v in arr]


__all__ = ["NodeMonitor"]
