"""Training and serving metrics.

:class:`MetricsCollector` is the counterpart of the JAX package's
(``trustworthy_dl_tpu/utils/metrics.py``): per-batch and per-epoch
records, a step-time series from :meth:`MetricsCollector.tick`, and their
summary.  Given a ``tensorboard_dir`` it writes the scalars as TensorBoard
events through ``torch.utils.tensorboard`` when that imports, and
otherwise degrades to in-memory records with a warning, as the JAX
collector does.

The collector also feeds a metrics registry (``obs/registry.py``, the
process-wide one unless given another): numeric batch metrics become
``tddl_<namespace>_<key>`` gauges (per-node dicts gain a ``node``
label), and ``tick()`` observes ``tddl_<namespace>_step_time_seconds``.
``bind_registry`` re-points it (the trainer's ``attach_obs``).

:class:`ServeMetrics` is the part of the JAX engine's rollups that
``ServingEngine.metrics_summary`` reads.  Latencies are kept whole and
their percentiles computed exactly with numpy (the JAX engine uses
streaming P-square estimators; the port's SLO watcher keeps those, and
the summary reports them apart); occupancy is the mean share of decode
rows holding a request, sampled once per engine step.
"""

from __future__ import annotations

import logging
import re
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from trustworthy_dl_tpu_torch.obs.registry import get_registry

logger = logging.getLogger(__name__)

# Correlation ids and bookkeeping keys that would be nonsense as gauges.
_NON_METRIC_KEYS = frozenset({"timestamp", "step", "epoch", "request_id"})
_KEY_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


class _NullHist:
    """No-op histogram stand-in after a registration conflict."""

    def observe(self, *a: Any, **kw: Any) -> None:
        pass


def _make_tb_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(logdir)
    except Exception as exc:  # tensorboard optional: degrade, don't fail
        logger.warning("TensorBoard writer unavailable (%s); metrics stay "
                       "in-memory only", exc)
        return None


class MetricsCollector:
    """Accumulates per-batch metric dicts and summarises them."""

    def __init__(self, max_records: int = 100_000,
                 tensorboard_dir: Optional[str] = None,
                 registry: Any = None, namespace: str = "train",
                 labels: Optional[Dict[str, str]] = None):
        # ``labels``: a constant label set on every registry series (a
        # fleet replica's ``{"replica": i}``, so N replicas' gauges are
        # read apart instead of the last writer winning).
        self._const_labels = {k: str(v) for k, v in (labels or {}).items()}
        self.max_records = max_records
        self.batch_metrics: List[Dict[str, Any]] = []
        self.epoch_metrics: List[Dict[str, Any]] = []
        self._step_times: List[float] = []
        self._last_tick: Optional[float] = None
        self._tb = _make_tb_writer(tensorboard_dir) if tensorboard_dir \
            else None
        self._ns = _KEY_SANITIZE.sub("_", namespace)
        self.bind_registry(registry if registry is not None
                           else get_registry())

    def bind_registry(self, registry: Any) -> None:
        """Re-point the export surface at ``registry`` (an ObsSession's
        per-run registry, so its snapshots describe that run alone)."""
        self._registry = registry
        self._gauges: Dict[Any, Any] = {}
        try:
            self._tick_hist = registry.histogram(
                f"tddl_{self._ns}_step_time_seconds",
                "step/iteration wall time", labels=tuple(self._const_labels))
        except ValueError:
            # A kind clash with a series registered first under the name:
            # degrade this collector's export, keep the record lists.
            logger.debug("metrics: registry rejected "
                         "tddl_%s_step_time_seconds", self._ns,
                         exc_info=True)
            self._tick_hist = _NullHist()

    def _registry_gauge(self, key: str, value: Any,
                        node: Optional[Any] = None) -> None:
        name = f"tddl_{self._ns}_{_KEY_SANITIZE.sub('_', key)}"
        cache_key = (name, node is not None)
        gauge = self._gauges.get(cache_key)
        try:
            if gauge is None:
                labels = tuple(self._const_labels)
                if node is not None:
                    labels = ("node",) + labels
                gauge = self._registry.gauge(name, labels=labels)
                self._gauges[cache_key] = gauge
            if node is not None:
                gauge.set(float(value), node=node, **self._const_labels)
            else:
                gauge.set(float(value), **self._const_labels)
        except ValueError:
            # Name/kind collision or cardinality bound: the record list
            # is the source of truth; export never stops a run.
            logger.debug("metrics: registry rejected %s", name,
                         exc_info=True)

    def _tb_scalars(self, prefix: str, record: Dict[str, Any],
                    step: int) -> None:
        if self._tb is None:
            return
        for key, value in record.items():
            if isinstance(value, (int, float)) and key != "timestamp":
                self._tb.add_scalar(f"{prefix}/{key}", value, step)
            elif isinstance(value, dict):  # e.g. per-node trust scores
                for sub, v in value.items():
                    if isinstance(v, (int, float)):
                        self._tb.add_scalar(f"{prefix}/{key}/{sub}", v,
                                            step)

    def collect_batch_metrics(self, metrics: Dict[str, Any]) -> None:
        if len(self.batch_metrics) >= self.max_records:
            self.batch_metrics.pop(0)
        record = dict(metrics)
        record.setdefault("timestamp", time.time())
        self.batch_metrics.append(record)
        self._tb_scalars("batch", record,
                         int(record.get("step", len(self.batch_metrics))))
        for key, value in record.items():
            if key in _NON_METRIC_KEYS:
                continue
            if isinstance(value, (int, float)):
                self._registry_gauge(key, value)
            elif isinstance(value, dict):  # per-node maps -> node label
                for sub, v in value.items():
                    if isinstance(v, (int, float)):
                        self._registry_gauge(key, v, node=sub)

    def collect_epoch_metrics(self, metrics: Dict[str, Any]) -> None:
        record = dict(metrics)
        record.setdefault("timestamp", time.time())
        self.epoch_metrics.append(record)
        self._tb_scalars("epoch", record,
                         int(record.get("epoch", len(self.epoch_metrics))))

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        """Flush and release the event-file writer (thread + fd)."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def tick(self) -> None:
        """One step's wall time: the time since the previous tick."""
        now = time.perf_counter()
        if self._last_tick is not None:
            dt = now - self._last_tick
            self._step_times.append(dt)
            self._tick_hist.observe(dt, **self._const_labels)
        self._last_tick = now

    def step_time_stats(self) -> Dict[str, float]:
        if not self._step_times:
            return {}
        arr = np.array(self._step_times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "max_s": float(arr.max()),
            "count": int(arr.size),
        }

    def get_summary(self) -> Dict[str, Any]:
        summary: Dict[str, Any] = {
            "num_batches": len(self.batch_metrics),
            "num_epochs": len(self.epoch_metrics),
        }
        losses = [m["loss"] for m in self.batch_metrics if "loss" in m]
        if losses:
            summary["mean_loss"] = float(np.mean(losses))
            summary["final_loss"] = float(losses[-1])
            summary["min_loss"] = float(np.min(losses))
        st = self.step_time_stats()
        if st:
            summary["step_time"] = st
        return summary

    def reset(self) -> None:
        self.batch_metrics.clear()
        self.epoch_metrics.clear()
        self._step_times.clear()
        self._last_tick = None


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
