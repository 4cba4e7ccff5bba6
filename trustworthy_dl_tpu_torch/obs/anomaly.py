"""EWMA/z-score anomaly detection over host telemetry streams.

Counterpart of ``trustworthy_dl_tpu/obs/anomaly.py``: the same names,
schemas and behaviour, in the port's own copy.

The training trust stack z-scores *nodes against the fleet*; this module
z-scores *the run against its own recent past* — step time, loss,
grad-norm, inter-token latency.  Each signal keeps an exponentially
weighted mean/variance (O(1) memory) and scores every new observation
BEFORE absorbing it; an anomalous observation is never absorbed
(score-then-absorb-only-clean — the same hardening the detection
baseline and the serve output monitor use, so a slow-burn corruption
cannot drag its own baseline along).

A non-finite observation is always anomalous once the detector is warm
(a NaN loss has no z-score; it *is* the incident).

On anomaly onset the watcher emits a typed ``anomaly`` trace event,
flips ``tddl_anomaly_active{signal=}`` to 1, bumps
``tddl_anomaly_events_total{signal=}``, fires registered callbacks, and
— once per anomaly *episode* (the transition from no-signal-anomalous to
any-signal-anomalous, NOT per signal: a stall and a NaN landing on the
same step are one incident) — triggers a flight-recorder dump with
reason ``anomaly``.  The gauge returns to 0 on the next clean
observation of that signal.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple


class EwmaDetector:
    """One signal's exponentially weighted baseline + z-scorer."""

    def __init__(self, alpha: float = 0.05, warmup: int = 16,
                 z_threshold: float = 6.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if warmup < 2:
            raise ValueError("warmup must be >= 2")
        if z_threshold <= 0.0:
            raise ValueError("z_threshold must be > 0")
        self.alpha = alpha
        self.warmup = warmup
        self.z_threshold = z_threshold
        self.count = 0           # clean observations absorbed
        self._mean = 0.0
        self._var = 0.0

    @property
    def warm(self) -> bool:
        return self.count >= self.warmup

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def std(self) -> float:
        return math.sqrt(max(self._var, 0.0))

    def score(self, x: float) -> float:
        """z-score of ``x`` against the current baseline (inf for
        non-finite inputs; 0 while the baseline is empty)."""
        if not math.isfinite(x):
            return math.inf
        if self.count == 0:
            return 0.0
        std = self.std
        if std <= 0.0:
            # Degenerate (constant) baseline: any deviation is infinitely
            # surprising; an exact match is not surprising at all.
            return 0.0 if x == self._mean else math.inf
        return abs(x - self._mean) / std

    def observe(self, x: float) -> Tuple[bool, float]:
        """Score ``x``; absorb it iff clean.  Returns (anomalous, z).
        Anomalies only fire once warm — early variance must not page
        anyone."""
        x = float(x)
        z = self.score(x)
        anomalous = self.warm and (not math.isfinite(x)
                                   or z > self.z_threshold)
        if not anomalous and math.isfinite(x):
            self.count += 1
            if self.count == 1:
                self._mean = x
            else:
                delta = x - self._mean
                self._mean += self.alpha * delta
                self._var = ((1 - self.alpha)
                             * (self._var + self.alpha * delta * delta))
        return anomalous, z


#: signal -> (alpha, warmup, z_threshold) defaults.  step_time gets a
#: lower bar (a stalled host is a 10-100x spike, but jitter is real);
#: loss/grad_norm spikes are the guard's territory, so the watcher only
#: flags the far tail.
DEFAULT_SIGNALS: Dict[str, Tuple[float, int, float]] = {
    "step_time": (0.1, 8, 6.0),
    "loss": (0.05, 16, 8.0),
    "grad_norm": (0.05, 16, 8.0),
    "itl": (0.05, 32, 8.0),
}


class AnomalyWatcher:
    """Per-signal EWMA detectors + the emit/gauge/dump/callback plumbing.

    ``dump`` is a callable ``(reason, step=None, extra=None) -> path``
    (``ObsSession.dump_flight``).  Signals not pre-registered are
    auto-registered with :data:`DEFAULT_SIGNALS` (or generic defaults)
    on first observation.
    """

    def __init__(self, signals: Optional[Dict[str, Tuple[float, int, float]]]
                 = None, *, registry: Any = None, trace: Any = None,
                 dump: Optional[Callable[..., Any]] = None):
        self._lock = threading.Lock()
        self._dets: Dict[str, EwmaDetector] = {}
        self._active: Dict[str, bool] = {}
        self.trace = trace
        self.dump = dump
        self.event_total = 0
        self._callbacks: List[Callable[[str, Dict[str, Any]], None]] = []
        self._active_gauge = None
        self._event_counter = None
        if registry is not None:
            self._active_gauge = registry.gauge(
                "tddl_anomaly_active",
                "1 while a signal's latest observation was anomalous",
                labels=("signal",),
            )
            self._event_counter = registry.counter(
                "tddl_anomaly_events_total", "Anomaly onsets, by signal",
                labels=("signal",),
            )
        for name, cfg in (signals if signals is not None
                          else DEFAULT_SIGNALS).items():
            self.watch(name, *cfg)

    def watch(self, signal: str, alpha: float = 0.05, warmup: int = 16,
              z_threshold: float = 6.0) -> EwmaDetector:
        with self._lock:
            if signal in self._dets:
                raise ValueError(f"signal {signal!r} already watched")
            det = EwmaDetector(alpha, warmup, z_threshold)
            self._dets[signal] = det
            self._active[signal] = False
        if self._active_gauge is not None:
            self._active_gauge.set(0.0, signal=signal)
        return det

    def on_anomaly(self, callback: Callable[[str, Dict[str, Any]], None]
                   ) -> None:
        """Register ``callback(signal, info)`` fired at anomaly onset —
        what the supervisor/engine consult beyond the gauges."""
        self._callbacks.append(callback)

    # -- observation -------------------------------------------------------

    def observe(self, signal: str, value: float,
                step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Feed one observation; returns the anomaly info dict at onset
        (None otherwise)."""
        onset: Optional[Dict[str, Any]] = None
        episode_start = False
        with self._lock:
            det = self._dets.get(signal)
            if det is None:
                cfg = DEFAULT_SIGNALS.get(signal, (0.05, 16, 6.0))
                det = EwmaDetector(*cfg)
                self._dets[signal] = det
                self._active[signal] = False
            anomalous, z = det.observe(value)
            if anomalous and not self._active[signal]:
                episode_start = not any(self._active.values())
                onset = {
                    "signal": signal, "zscore": z, "value": float(value),
                    "baseline_mean": det.mean, "step": step,
                }
                self.event_total += 1
            self._active[signal] = anomalous
        if self._active_gauge is not None:
            self._active_gauge.set(1.0 if anomalous else 0.0, signal=signal)
        if onset is not None:
            if self._event_counter is not None:
                self._event_counter.inc(signal=signal)
            if self.trace is not None:
                from trustworthy_dl_tpu_torch.obs.events import EventType

                self.trace.emit(
                    EventType.ANOMALY, step=step, signal=signal,
                    zscore=(z if math.isfinite(z) else None),
                    value=(float(value) if math.isfinite(float(value))
                           else None),
                )
            for cb in self._callbacks:
                cb(signal, onset)
            if episode_start and self.dump is not None:
                self.dump("anomaly", step=step,
                          extra={"signal": signal,
                                 "zscore": z if math.isfinite(z) else None})
        return onset

    # -- reads -------------------------------------------------------------

    @property
    def active(self) -> List[str]:
        with self._lock:
            return sorted(s for s, a in self._active.items() if a)

    @property
    def any_active(self) -> bool:
        with self._lock:
            return any(self._active.values())

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": sorted(s for s, a in self._active.items() if a),
                "event_total": self.event_total,
                "signals": {
                    s: {"count": d.count, "mean": d.mean, "std": d.std,
                        "z_threshold": d.z_threshold,
                        "active": self._active[s]}
                    for s, d in sorted(self._dets.items())
                },
            }
