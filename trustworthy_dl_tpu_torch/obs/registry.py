"""Process-wide metrics registry: counters, gauges, histograms with
labels; JSON snapshot and Prometheus-text export.

Counterpart of ``trustworthy_dl_tpu/obs/registry.py``: the same names,
schemas and behaviour, in the port's own copy.

This replaces the ad-hoc per-subsystem metric piles (``utils.metrics``
record lists, serve-engine summary dicts, supervisor counters, chaos
``counts()``) with one typed surface.  Design constraints:

* **Host-only and cheap** — a metric update is a dict write under a
  lock; nothing here ever touches torch or the hot device path.
* **Bounded cardinality** — each metric refuses to grow past
  ``max_series`` label combinations (a label explosion is a bug, and a
  silent one OOMs long-lived servers; here it raises at the source).
* **Deterministic snapshots** — ``snapshot()`` round-trips through JSON
  (``MetricsRegistry.from_snapshot``) so a metrics file can be diffed,
  asserted on in tests, and re-served.

Naming convention (enforced shape, advisory prefix):
``tddl_<subsystem>_<what>[_unit]``, Prometheus-compatible characters
only; counters end in ``_total``, durations in ``_seconds``.
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _label_key(label_names: Tuple[str, ...],
               labels: Mapping[str, Any]) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(
            f"metric declared labels {label_names}, got {sorted(labels)}"
        )
    return tuple(str(labels[n]) for n in label_names)


class _Metric:
    """One named metric: a family of series keyed by label values."""

    def __init__(self, registry: "MetricsRegistry", kind: str, name: str,
                 help: str, label_names: Sequence[str],
                 buckets: Optional[Sequence[float]] = None):
        self.kind = kind
        self.name = _check_name(name)
        self.help = help
        self.label_names = tuple(label_names)
        for label in self.label_names:
            if not _LABEL_RE.match(label):
                raise ValueError(f"invalid label name {label!r}")
        if buckets is not None:
            buckets = tuple(sorted(float(b) for b in buckets))
            if not buckets:
                raise ValueError("histogram needs at least one bucket")
        self.buckets = buckets
        self._registry = registry
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _get_series(self, labels: Mapping[str, Any]) -> Tuple[str, ...]:
        key = _label_key(self.label_names, labels)
        if key not in self._series:
            if len(self._series) >= self._registry.max_series:
                raise ValueError(
                    f"metric {self.name!r} exceeded the label-cardinality "
                    f"bound ({self._registry.max_series} series); a label "
                    "carrying unbounded values (ids, paths) is a bug"
                )
            if self.kind == "histogram":
                self._series[key] = {
                    "bucket_counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0,
                }
            else:
                self._series[key] = 0.0
        return key

    # -- update ops (called via the handle methods below) ------------------

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a gauge")
        with self._registry._lock:
            key = self._get_series(labels)
            self._series[key] += float(amount)

    def set(self, value: float, **labels: Any) -> None:
        with self._registry._lock:
            key = self._get_series(labels)
            self._series[key] = float(value)

    def observe(self, value: float, **labels: Any) -> None:
        value = float(value)
        with self._registry._lock:
            key = self._get_series(labels)
            series = self._series[key]
            idx = len(self.buckets)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    idx = i
                    break
            series["bucket_counts"][idx] += 1
            series["sum"] += value
            series["count"] += 1

    # -- reads -------------------------------------------------------------

    def value(self, **labels: Any) -> Any:
        with self._registry._lock:
            key = _label_key(self.label_names, labels)
            value = self._series.get(key)
            return dict(value) if isinstance(value, dict) else value


class MetricsRegistry:
    """A set of named metrics with snapshot/export.

    One process-wide default instance exists (:func:`get_registry`);
    tests that assert absolute values should build their own.
    """

    def __init__(self, max_series: int = 1024):
        self.max_series = max_series
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.RLock()

    # -- registration ------------------------------------------------------

    def _register(self, kind: str, name: str, help: str,
                  labels: Sequence[str],
                  buckets: Optional[Sequence[float]] = None) -> _Metric:
        norm_buckets = tuple(sorted(float(b) for b in buckets)) \
            if buckets is not None else None
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != kind or \
                        existing.label_names != tuple(labels) or \
                        existing.buckets != norm_buckets:
                    # Bucket drift matters as much as kind drift: a
                    # silently-returned histogram with someone else's
                    # bounds bins every later observe() wrong.
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.label_names} "
                        f"(buckets={existing.buckets}); cannot "
                        f"re-register as {kind}{tuple(labels)} "
                        f"(buckets={norm_buckets})"
                    )
                return existing
            metric = _Metric(self, kind, name, help, labels, buckets)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Metric:
        return self._register("counter", name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Metric:
        return self._register("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Metric:
        return self._register("histogram", name, help, labels, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serialisable dump of every metric and series."""
        out: Dict[str, Any] = {}
        with self._lock:
            for name, metric in sorted(self._metrics.items()):
                series = []
                for key in sorted(metric._series):
                    value = metric._series[key]
                    series.append({
                        "labels": dict(zip(metric.label_names, key)),
                        "value": dict(value) if isinstance(value, dict)
                        else value,
                    })
                entry: Dict[str, Any] = {
                    "kind": metric.kind,
                    "help": metric.help,
                    "label_names": list(metric.label_names),
                    "series": series,
                }
                if metric.buckets is not None:
                    entry["buckets"] = list(metric.buckets)
                out[name] = entry
        return {"metrics": out}

    @classmethod
    def from_snapshot(cls, snap: Mapping[str, Any],
                      max_series: int = 1024) -> "MetricsRegistry":
        """Rebuild a registry whose ``snapshot()`` equals ``snap`` — the
        round-trip contract a persisted metrics file relies on."""
        registry = cls(max_series=max_series)
        for name, entry in snap.get("metrics", {}).items():
            metric = registry._register(
                entry["kind"], name, entry.get("help", ""),
                entry.get("label_names", ()), entry.get("buckets"),
            )
            for row in entry.get("series", ()):
                key = _label_key(metric.label_names, row["labels"])
                value = row["value"]
                metric._series[key] = dict(value) if isinstance(value, dict) \
                    else float(value)
        return registry

    def snapshot_to_json(self, path: str, extra: Optional[Dict] = None
                         ) -> Dict[str, Any]:
        """Write the snapshot (+ run metadata) to ``path``; returns it."""
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata
        from trustworthy_dl_tpu_torch.utils.io import atomic_write_json

        snap = self.snapshot()
        snap["run_metadata"] = run_metadata()
        if extra:
            snap.update(extra)
        atomic_write_json(path, snap)
        return snap

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain version 0.0.4)."""

        def fmt_labels(names: Tuple[str, ...], key: Tuple[str, ...],
                       extra: Tuple[Tuple[str, str], ...] = ()) -> str:
            pairs = list(zip(names, key)) + list(extra)
            if not pairs:
                return ""
            body = ",".join(
                '{}="{}"'.format(
                    n, v.replace("\\", r"\\").replace('"', r"\"")
                ) for n, v in pairs
            )
            return "{" + body + "}"

        def fmt_value(v: float) -> str:
            if math.isinf(v):
                return "+Inf" if v > 0 else "-Inf"
            return repr(v) if isinstance(v, float) else str(v)

        lines: List[str] = []
        with self._lock:
            for name, metric in sorted(self._metrics.items()):
                if metric.help:
                    lines.append(f"# HELP {name} {metric.help}")
                lines.append(f"# TYPE {name} {metric.kind}")
                for key in sorted(metric._series):
                    value = metric._series[key]
                    if metric.kind != "histogram":
                        lines.append(
                            f"{name}{fmt_labels(metric.label_names, key)} "
                            f"{fmt_value(value)}"
                        )
                        continue
                    cumulative = 0
                    for bound, count in zip(
                        list(metric.buckets) + [float("inf")],
                        value["bucket_counts"],
                    ):
                        cumulative += count
                        le = "+Inf" if math.isinf(bound) else f"{bound:g}"
                        lines.append(
                            f"{name}_bucket"
                            f"{fmt_labels(metric.label_names, key, (('le', le),))}"
                            f" {cumulative}"
                        )
                    suffix = fmt_labels(metric.label_names, key)
                    lines.append(f"{name}_sum{suffix} "
                                 f"{fmt_value(value['sum'])}")
                    lines.append(f"{name}_count{suffix} {value['count']}")
        return "\n".join(lines) + "\n"


_DEFAULT_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem defaults to."""
    return _DEFAULT_REGISTRY
