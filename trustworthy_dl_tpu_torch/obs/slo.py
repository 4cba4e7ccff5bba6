"""Streaming SLO evaluation: bounded-memory percentile estimators +
declarative target/window/burn-rate rules over the live signal streams.

Counterpart of ``trustworthy_dl_tpu/obs/slo.py``: the same names,
schemas and behaviour, in the port's own copy.

Two pieces:

* :class:`P2Quantile` / :class:`StreamingPercentiles` — the P² algorithm
  (Jain & Chlamtac, CACM '85): one quantile tracked with FIVE markers,
  O(1) per observation, no sample list.  Under the million-user framing
  the engine cannot keep every ITL in a python list to ``np.percentile``
  at summary time; these estimators replace that (engine
  ``metrics_summary`` reads them) and feed the SLO rules.
* :class:`SLORule` / :class:`SLOWatcher` — a rule is
  ``observation > target`` counted over a sliding window of the last
  ``window`` observations; ``burn rate`` is the violating fraction
  divided by the error ``budget`` (the SRE burn-rate convention: 1.0 =
  exactly consuming budget, >1 = burning it).  Every observation
  re-evaluates its signal's rules: the burn rate lands in the
  ``tddl_slo_burn_rate{slo=}`` gauge, and a threshold crossing emits a
  typed ``slo_breach`` trace event, bumps
  ``tddl_slo_breaches_total{slo=}``, fires the registered callbacks
  (the serving engine sheds lowest-priority admissions off this hook),
  and — once per breach episode — triggers a flight-recorder dump with
  reason ``slo_breach``.

Everything is host work under one lock; nothing touches torch.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class P2Quantile:
    """One streaming quantile via the P² algorithm — five markers, O(1)
    memory and per-observation work.  Exact below five observations
    (sorted insert), marker interpolation beyond."""

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.count = 0
        self._x: List[float] = []          # warmup buffer (first 5)
        self._h: Optional[List[float]] = None   # marker heights
        self._n: Optional[List[float]] = None   # marker positions
        self._np: Optional[List[float]] = None  # desired positions

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            return  # a NaN latency is an anomaly, not a percentile input
        self.count += 1
        if self._h is None:
            bisect.insort(self._x, x)
            if len(self._x) == 5:
                q = self.q
                self._h = list(self._x)
                self._n = [0.0, 1.0, 2.0, 3.0, 4.0]
                self._np = [0.0, 2 * q, 4 * q, 2 + 2 * q, 4.0]
            return
        h, n, np_ = self._h, self._n, self._np
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            n[i] += 1.0
        dn = (0.0, self.q / 2, self.q, (1 + self.q) / 2, 1.0)
        for i in range(5):
            np_[i] += dn[i]
        for i in (1, 2, 3):
            d = np_[i] - n[i]
            if ((d >= 1.0 and n[i + 1] - n[i] > 1.0)
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0)):
                d = 1.0 if d > 0 else -1.0
                hp = self._parabolic(i, d)
                if not h[i - 1] < hp < h[i + 1]:
                    hp = self._linear(i, d)
                h[i] = hp
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        h, n = self._h, self._n
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    @property
    def value(self) -> Optional[float]:
        if self._h is not None:
            return self._h[2]
        if not self._x:
            return None
        idx = int(round(self.q * (len(self._x) - 1)))
        return self._x[max(0, min(idx, len(self._x) - 1))]


#: Quantiles every signal tracks by default (the serving SLO surface).
DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


class StreamingPercentiles:
    """A signal's bounded-memory distribution sketch: one P² marker set
    per tracked quantile plus count/mean/min/max."""

    def __init__(self, quantiles: Sequence[float] = DEFAULT_QUANTILES):
        self._q = {q: P2Quantile(q) for q in quantiles}
        self.count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x):
            return
        self.count += 1
        self._sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        for est in self._q.values():
            est.observe(x)

    def quantile(self, q: float) -> Optional[float]:
        est = self._q.get(q)
        return est.value if est is not None else None

    def summary(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": self.count}
        if self.count:
            out["mean"] = self._sum / self.count
            out["min"] = self._min
            out["max"] = self._max
            for q, est in sorted(self._q.items()):
                out[f"p{round(q * 100)}"] = est.value
        return out


@dataclasses.dataclass(frozen=True)
class SLORule:
    """``observation > target`` counted over the last ``window``
    observations of ``signal``; burning when the violating fraction
    exceeds ``budget * burn_threshold``.  ``min_count`` is the warmup —
    a rule never breaches on the first unlucky sample."""

    name: str
    signal: str          # e.g. "ttft_s", "itl_s", "step_time_s"
    target: float        # per-observation upper bound (seconds, ratio..)
    budget: float = 0.01         # allowed violating fraction
    window: int = 256            # sliding-window length (observations)
    min_count: int = 32          # observations before breach can fire
    burn_threshold: float = 1.0  # breach at burn_rate >= this

    def __post_init__(self) -> None:
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"budget must be in (0, 1], got {self.budget}")
        if self.window < 1 or self.min_count < 1:
            raise ValueError("window and min_count must be >= 1")
        if self.min_count > self.window:
            raise ValueError("min_count cannot exceed window")
        if self.burn_threshold <= 0.0:
            raise ValueError("burn_threshold must be > 0")


def default_serve_rules(ttft_target_s: float = 2.0,
                        itl_target_s: float = 0.25) -> Tuple[SLORule, ...]:
    """The serving defaults the CLI/bench install: generous enough that
    a healthy engine never trips them, tight enough that a degrading
    engine (slow-but-completing requests) does.  TTFT/ITL are observed
    at retirement, so a FULLY wedged loop emits no observations — that
    failure mode is the anomaly watcher's / supervisor's territory, not
    a latency SLO's."""
    return (
        SLORule("ttft", signal="ttft_s", target=ttft_target_s,
                budget=0.05, window=128, min_count=16),
        SLORule("itl", signal="itl_s", target=itl_target_s,
                budget=0.01, window=512, min_count=64),
    )


class _RuleState:
    __slots__ = ("rule", "window", "violations", "burn", "active")

    def __init__(self, rule: SLORule):
        self.rule = rule
        self.window: deque = deque(maxlen=rule.window)
        self.violations = 0
        self.burn = 0.0
        self.active = False


class SLOWatcher:
    """Evaluates :class:`SLORule`\\ s on every observation and keeps the
    per-signal percentile sketches.

    ``dump`` is a callable ``(reason, step=None, extra=None) -> path``
    (``ObsSession.dump_flight``); it fires once per breach *episode*
    (the transition into any-rule-breached), not per breached
    observation — post-mortems stay bounded.
    """

    def __init__(self, rules: Sequence[SLORule] = (), *,
                 registry: Any = None, trace: Any = None,
                 dump: Optional[Callable[..., Any]] = None,
                 quantiles: Sequence[float] = DEFAULT_QUANTILES):
        self._lock = threading.Lock()
        self._quantiles = tuple(quantiles)
        self._signals: Dict[str, StreamingPercentiles] = {}
        self._by_signal: Dict[str, List[_RuleState]] = {}
        self._states: Dict[str, _RuleState] = {}
        self.trace = trace
        self.dump = dump
        self._callbacks: List[Callable[[str, Dict[str, Any]], None]] = []
        self.breach_total = 0
        self._burn_gauge = None
        self._breach_counter = None
        if registry is not None:
            self._burn_gauge = registry.gauge(
                "tddl_slo_burn_rate",
                "Error-budget burn rate per SLO rule (1.0 = consuming "
                "budget exactly; breach at the rule's threshold)",
                labels=("slo",),
            )
            self._breach_counter = registry.counter(
                "tddl_slo_breaches_total", "SLO breach onsets, by rule",
                labels=("slo",),
            )
        for rule in rules:
            self.add_rule(rule)

    def add_rule(self, rule: SLORule) -> None:
        with self._lock:
            if rule.name in self._states:
                raise ValueError(f"duplicate SLO rule {rule.name!r}")
            state = _RuleState(rule)
            self._states[rule.name] = state
            self._by_signal.setdefault(rule.signal, []).append(state)
        if self._burn_gauge is not None:
            self._burn_gauge.set(0.0, slo=rule.name)

    def on_breach(self, callback: Callable[[str, Dict[str, Any]], None]
                  ) -> None:
        """Register ``callback(rule_name, info)`` fired at breach onset
        — the host-side hook the engine's admission shedding uses."""
        self._callbacks.append(callback)

    # -- observation -------------------------------------------------------

    def observe(self, signal: str, value: float,
                step: Optional[int] = None) -> None:
        onsets: List[Tuple[str, Dict[str, Any]]] = []
        episode_start = False
        with self._lock:
            est = self._signals.get(signal)
            if est is None:
                est = StreamingPercentiles(self._quantiles)
                self._signals[signal] = est
            est.observe(value)
            for st in self._by_signal.get(signal, ()):
                rule = st.rule
                bad = 1 if (not math.isfinite(float(value))
                            or float(value) > rule.target) else 0
                if len(st.window) == st.window.maxlen:
                    st.violations -= st.window[0]
                st.window.append(bad)
                st.violations += bad
                st.burn = (st.violations / len(st.window)) / rule.budget
                warm = len(st.window) >= rule.min_count
                breached = warm and st.burn >= rule.burn_threshold
                if breached and not st.active:
                    was_any = any(s.active for s in self._states.values())
                    st.active = True
                    self.breach_total += 1
                    episode_start = episode_start or not was_any
                    onsets.append((rule.name, {
                        "signal": signal, "burn_rate": st.burn,
                        "target": rule.target, "value": float(value),
                        "step": step,
                    }))
                elif not breached and st.active:
                    st.active = False
            if self._burn_gauge is not None:
                for st in self._by_signal.get(signal, ()):
                    self._burn_gauge.set(st.burn, slo=st.rule.name)
        for name, info in onsets:
            if self._breach_counter is not None:
                self._breach_counter.inc(slo=name)
            if self.trace is not None:
                from trustworthy_dl_tpu_torch.obs.events import EventType

                self.trace.emit(EventType.SLO_BREACH, step=step,
                                slo=name, signal=info["signal"],
                                burn_rate=info["burn_rate"],
                                target=info["target"])
            for cb in self._callbacks:
                cb(name, info)
        if onsets and episode_start and self.dump is not None:
            self.dump("slo_breach", step=step,
                      extra={"slo_rules": [n for n, _ in onsets]})

    # -- reads -------------------------------------------------------------

    @property
    def active(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._states.items() if st.active)

    @property
    def breached(self) -> bool:
        """True while ANY rule is in breach — the shed hook's condition."""
        with self._lock:
            return any(st.active for st in self._states.values())

    def burn_rate(self, name: str) -> float:
        with self._lock:
            return self._states[name].burn

    def percentiles(self, signal: str) -> Dict[str, Any]:
        with self._lock:
            est = self._signals.get(signal)
            return est.summary() if est is not None else {"count": 0}

    def quantile(self, signal: str, q: float) -> Optional[float]:
        with self._lock:
            est = self._signals.get(signal)
            return est.quantile(q) if est is not None else None

    def status(self) -> Dict[str, Any]:
        """JSON-serialisable rollup: per-rule burn + per-signal sketch
        (what the CLI prints and the bench stamps)."""
        with self._lock:
            return {
                "rules": [{
                    "name": st.rule.name, "signal": st.rule.signal,
                    "target": st.rule.target, "budget": st.rule.budget,
                    "window": st.rule.window,
                    "burn_rate": st.burn, "active": st.active,
                } for st in self._states.values()],
                "active": sorted(n for n, st in self._states.items()
                                 if st.active),
                "breach_total": self.breach_total,
                "signals": {s: est.summary()
                            for s, est in sorted(self._signals.items())},
            }
