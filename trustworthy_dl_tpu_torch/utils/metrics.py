"""Serving metrics: the part of ``trustworthy_dl_tpu/utils/metrics.py`` and
of the JAX engine's rollups that ``ServingEngine.metrics_summary`` reads.

Latencies are kept whole and their percentiles computed exactly with
numpy (the JAX engine uses streaming P-square estimators); occupancy is
the mean share of decode rows holding a request, sampled once per engine
step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def percentile_ms(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile of ``values`` (seconds) in milliseconds, or
    None with no samples."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q) * 1e3)


class ServeMetrics:
    """Per-request latencies and per-step occupancy of one engine."""

    def __init__(self) -> None:
        self.ttft_s: List[float] = []
        self.itl_s: List[float] = []
        self._occupancy_sum = 0.0
        self.steps = 0

    def observe_request(self, ttft_s: Optional[float],
                        itl_s: Sequence[float]) -> None:
        if ttft_s is not None:
            self.ttft_s.append(ttft_s)
        self.itl_s.extend(itl_s)

    def observe_step(self, occupancy: float) -> None:
        self._occupancy_sum += occupancy
        self.steps += 1

    def summary(self) -> Dict[str, float]:
        """TTFT/ITL p50 and p99 in ms with their sample counts, and the
        mean occupancy."""
        out: Dict[str, float] = {
            "ttft_samples": len(self.ttft_s),
            "itl_samples": len(self.itl_s),
            "mean_occupancy": (self._occupancy_sum / self.steps
                               if self.steps else 0.0),
        }
        for name, values in (("ttft", self.ttft_s), ("itl", self.itl_s)):
            if values:
                out[f"{name}_p50_ms"] = percentile_ms(values, 50)
                out[f"{name}_p99_ms"] = percentile_ms(values, 99)
        return out
