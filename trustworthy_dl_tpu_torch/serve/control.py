"""Fleet control plane primitives: SLO classes, tenant quotas, the
autoscaler.

Counterpart of ``trustworthy_dl_tpu/serve/control.py``, a copy of its
host-only code: nothing here imports torch (as JAX's imports no jax), and
everything is deterministic in fleet ticks, so drills pin exact scale and
throttle counts (``FaultPlan.predict_fleet``).  ``serve.fleet.ServingFleet``
wires it in, every piece opt-in through ``FleetConfig``:

* **SLO classes and deficit round robin** -- requests map to a small set of
  :class:`SLOClass`es (per-class TTFT/ITL targets, a shed-order priority
  and a DRR weight).  :class:`ClassQueues` dequeues by token cost (prompt
  + max_new): each round a class earns ``quantum * weight`` deficit, so a
  heavy class cannot starve a light one.  Under a per-class latency breach
  (:class:`ClassLatencyTracker`) the fleet sheds from the lowest class
  first.
* **Per-tenant token buckets** -- :class:`TenantBuckets`: a submission
  spends ``prompt + max_new`` tokens from its tenant's bucket, refilled
  lazily per tick; a flooding tenant throttles itself, loudly.
* **Autoscaler** -- :func:`autoscale_pressure` is the one pure decision
  predicate (queue depth per replica, pool occupancy, ITL p99, SLO burn,
  the predictive arm's demand); :class:`Autoscaler` adds the hysteresis:
  separate up/down thresholds, per-direction cool-downs and a sustained
  idle streak before a scale-down.  A scale-down always drains.
* **Predictive arm** -- :func:`diurnal_rate` is the envelope
  ``serve.workload.generate_workload`` modulates its arrivals with (the
  one spelling; the workload imports it from here), so
  :func:`predicted_replicas` can anticipate a seeded burst ``lead_s``
  ahead of it.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Callable, Deque, Dict, List, Mapping, Optional, \
    Sequence, Tuple


# --------------------------------------------------------------------------
# SLO classes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One serving class.  ``priority`` orders shedding (HIGHER sheds
    last — the same convention as ``ServeRequest.priority``, which is
    how requests map to classes); ``weight`` scales the class's
    deficit-round-robin quantum; the latency targets (None = untracked)
    feed :class:`ClassLatencyTracker`'s breach predicate."""

    name: str
    priority: int
    weight: float = 1.0
    ttft_target_s: Optional[float] = None
    itl_target_s: Optional[float] = None

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("SLOClass needs a name")
        if self.weight <= 0.0:
            raise ValueError("SLOClass weight must be > 0")
        for field in ("ttft_target_s", "itl_target_s"):
            val = getattr(self, field)
            if val is not None and val <= 0.0:
                raise ValueError(f"SLOClass {field} must be > 0 or None")


#: Default three-class ladder, matching ``workload.DEFAULT_TENANTS``'s
#: priorities: bulk traffic (no latency contract, sheds first), an
#: interactive tier, and a premium tier that sheds last and earns the
#: largest DRR share.
DEFAULT_SLO_CLASSES: Tuple[SLOClass, ...] = (
    SLOClass("batch", priority=0, weight=1.0),
    SLOClass("standard", priority=1, weight=2.0,
             ttft_target_s=5.0, itl_target_s=0.5),
    SLOClass("premium", priority=2, weight=4.0,
             ttft_target_s=2.0, itl_target_s=0.25),
)


def class_for_priority(classes: Sequence[SLOClass],
                       priority: int) -> SLOClass:
    """Map a request priority onto a class: the highest class whose
    priority does not exceed the request's (so priority 7 traffic rides
    the top class of a 0/1/2 ladder, and anything below the ladder's
    floor rides the floor)."""
    ordered = sorted(classes, key=lambda c: c.priority)
    chosen = ordered[0]
    for cls in ordered:
        if cls.priority <= priority:
            chosen = cls
    return chosen


class ClassQueues:
    """Deficit-round-robin admission queues, one per SLO class.

    DRR in token cost: each round a non-empty class earns
    ``quantum_tokens * weight`` deficit and releases queued requests
    while the head's cost fits; an empty class's deficit resets (the
    classic DRR rule — idle classes bank nothing).  Entries are
    ``(fid, cost)``; stale entries (the fleet finalized the request
    while it queued — deadline expiry, shed) are skipped lazily via the
    ``alive`` predicate, so the fleet never has to search a queue."""

    def __init__(self, classes: Sequence[SLOClass],
                 quantum_tokens: int = 32,
                 per_class_limit: int = 256):
        if quantum_tokens < 1 or per_class_limit < 1:
            raise ValueError(
                "quantum_tokens and per_class_limit must be >= 1")
        # Dequeue order: highest priority first (premium drains ahead
        # of batch inside one round; the deficit weights keep it fair
        # across rounds).
        self._order = [c.name for c in
                       sorted(classes, key=lambda c: -c.priority)]
        self._weight = {c.name: float(c.weight) for c in classes}
        self._shed_order = [c.name for c in
                            sorted(classes, key=lambda c: c.priority)]
        self.quantum = int(quantum_tokens)
        self.limit = int(per_class_limit)
        self._q: Dict[str, Deque[Tuple[int, int]]] = {
            c.name: deque() for c in classes}
        self._deficit: Dict[str, float] = {c.name: 0.0 for c in classes}

    def push(self, name: str, fid: int, cost: int) -> bool:
        """Enqueue; False = that class's queue is full (backpressure —
        the CLASS is full, so a flooding class rejects its own tail)."""
        q = self._q[name]
        if len(q) >= self.limit:
            return False
        q.append((fid, int(cost)))
        return True

    def push_front(self, name: str, fid: int, cost: int) -> None:
        """Return an entry the fleet could not place (engine
        backpressure) to the head of its queue — it keeps its turn."""
        self._q[name].appendleft((fid, int(cost)))

    def _drop_stale(self, q: Deque[Tuple[int, int]],
                    alive: Callable[[int], bool]) -> None:
        while q and not alive(q[0][0]):
            q.popleft()

    def take(self, max_n: int, alive: Callable[[int], bool]
             ) -> List[Tuple[str, int, int]]:
        """Dequeue up to ``max_n`` requests by DRR; returns
        ``(class, fid, cost)`` tuples in release order."""
        out: List[Tuple[str, int, int]] = []
        if max_n <= 0:
            return out
        # Round bound: a head costing C needs at most
        # ceil(C / (quantum * min_weight)) rounds of deficit to clear;
        # request cost is bounded by the serve geometry, so a generous
        # constant keeps this loop provably terminating.
        for _ in range(256):
            if len(out) >= max_n or not any(self._q.values()):
                break
            for name in self._order:
                q = self._q[name]
                self._drop_stale(q, alive)
                if not q:
                    self._deficit[name] = 0.0
                    continue
                self._deficit[name] += self.quantum * self._weight[name]
                while q and len(out) < max_n \
                        and q[0][1] <= self._deficit[name]:
                    fid, cost = q.popleft()
                    if not alive(fid):
                        self._drop_stale(q, alive)
                        continue
                    self._deficit[name] -= cost
                    out.append((name, fid, cost))
                    self._drop_stale(q, alive)
        return out

    def shed_candidate(self, alive: Callable[[int], bool]
                       ) -> Optional[Tuple[str, int]]:
        """The request an over-pressure shed should drop: the NEWEST
        entry of the LOWEST-priority non-empty class — the tail of the
        least-protected class, mirroring the engine's ties-newest
        rule."""
        for name in self._shed_order:
            q = self._q[name]
            while q and not alive(q[-1][0]):
                q.pop()
            if q:
                fid, _cost = q.pop()
                return name, fid
        return None

    def depth(self) -> int:
        return sum(len(q) for q in self._q.values())

    def depth_by_class(self) -> Dict[str, int]:
        return {name: len(q) for name, q in self._q.items()}


class ClassLatencyTracker:
    """Per-class streaming TTFT/ITL percentiles + the breach predicate
    the lowest-class-first shed keys on: a class is BREACHED while its
    p99 exceeds its target (after ``min_count`` observations — one slow
    request is noise, a pattern is a breach).  Built on the same P²
    estimators as the SLO watcher (``obs.slo.StreamingPercentiles``),
    so tracking a million retirements is O(classes), not O(requests)."""

    def __init__(self, classes: Sequence[SLOClass], min_count: int = 8):
        from trustworthy_dl_tpu_torch.obs.slo import StreamingPercentiles

        if min_count < 1:
            raise ValueError("min_count must be >= 1")
        self.min_count = int(min_count)
        self._cls = {c.name: c for c in classes}
        self._ttft = {c.name: StreamingPercentiles() for c in classes}
        self._itl = {c.name: StreamingPercentiles() for c in classes}

    def observe(self, name: str, ttft_s: Optional[float] = None,
                itl_s: Sequence[float] = ()) -> None:
        if name not in self._cls:
            return
        if ttft_s is not None:
            self._ttft[name].observe(float(ttft_s))
        for dt in itl_s:
            self._itl[name].observe(float(dt))

    def _over(self, est, target: Optional[float]) -> bool:
        if target is None or est.count < self.min_count:
            return False
        p99 = est.quantile(0.99)
        return p99 is not None and p99 > target

    def breached(self, name: str) -> bool:
        cls = self._cls[name]
        return (self._over(self._ttft[name], cls.ttft_target_s)
                or self._over(self._itl[name], cls.itl_target_s))

    def any_breached(self) -> bool:
        return any(self.breached(name) for name in self._cls)

    def summary(self, name: str) -> Dict[str, object]:
        cls = self._cls[name]
        out: Dict[str, object] = {"breached": self.breached(name)}
        for label, est, target in (
                ("ttft", self._ttft[name], cls.ttft_target_s),
                ("itl", self._itl[name], cls.itl_target_s)):
            out[f"{label}_count"] = est.count
            out[f"{label}_target_ms"] = (target * 1e3
                                         if target is not None else None)
            p99 = est.quantile(0.99) if est.count else None
            out[f"{label}_p99_ms"] = (float(p99 * 1e3)
                                      if p99 is not None else None)
        return out


# --------------------------------------------------------------------------
# Per-tenant token buckets
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantQuotaConfig:
    """Token-bucket admission: a submission costs ``prompt + max_new``
    tokens against its tenant's bucket.  ``capacity_tokens`` is the
    burst allowance, ``refill_per_tick`` the sustained rate (fleet
    TICKS, never wall time — drills must pin throttle counts).
    ``per_tenant`` overrides (capacity, refill) for named tenants —
    production quotas are never one-size-fits-all."""

    capacity_tokens: float
    refill_per_tick: float = 0.0
    per_tenant: Mapping[str, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.capacity_tokens <= 0:
            raise ValueError("capacity_tokens must be > 0")
        if self.refill_per_tick < 0:
            raise ValueError("refill_per_tick must be >= 0")
        for tenant, (cap, refill) in self.per_tenant.items():
            if cap <= 0 or refill < 0:
                raise ValueError(
                    f"per_tenant[{tenant!r}] needs capacity > 0 "
                    "and refill >= 0")

    def limits(self, tenant: str) -> Tuple[float, float]:
        return tuple(self.per_tenant.get(
            tenant, (self.capacity_tokens, self.refill_per_tick)))


class TenantBuckets:
    """Lazily-refilled per-tenant buckets.  A bucket materialises at
    capacity on first sight and refills ``refill_per_tick * elapsed``
    on each touch — O(1) per submission, O(tenants) memory, and exactly
    reproducible from the tick sequence alone."""

    def __init__(self, cfg: TenantQuotaConfig):
        self.cfg = cfg
        #: tenant -> (level, last_refill_tick)
        self._b: Dict[str, Tuple[float, int]] = {}

    def level(self, tenant: str, tick: int) -> float:
        cap, refill = self.cfg.limits(tenant)
        lvl, last = self._b.get(tenant, (cap, tick))
        lvl = min(cap, lvl + refill * max(tick - last, 0))
        self._b[tenant] = (lvl, tick)
        return lvl

    def try_spend(self, tenant: str, tokens: float, tick: int) -> bool:
        lvl = self.level(tenant, tick)
        if lvl < tokens:
            return False
        self._b[tenant] = (lvl - tokens, tick)
        return True

    def refund(self, tenant: str, tokens: float, tick: int) -> None:
        """Return a spend whose submission was subsequently REJECTED
        (class queue full, fleet-wide backpressure): the fleet did no
        work for it, so the tenant's budget must not shrink — rejected
        bursts would otherwise silently throttle the tenant's next
        legitimate requests."""
        cap, _refill = self.cfg.limits(tenant)
        lvl = self.level(tenant, tick)
        self._b[tenant] = (min(cap, lvl + tokens), tick)


# --------------------------------------------------------------------------
# Autoscaler
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PredictiveArmConfig:
    """The predictive arm's knowledge of the diurnal envelope — the
    SAME three numbers ``serve.workload.WorkloadConfig`` modulates its
    Poisson arrivals with — plus the deployment's service capacity and
    how far ahead to look.  ``tick_duration_s`` maps fleet ticks onto
    the workload's clock (drills pin it; production estimates it)."""

    mean_rps: float
    burstiness: float
    burst_period_s: float
    per_replica_rps: float
    lead_s: float = 0.0
    tick_duration_s: float = 0.05
    #: Per-role demand envelopes for the disaggregated prefill/decode
    #: split: role -> the FRACTION of fleet-wide demand that pool
    #: serves (e.g. ``{"prefill": 0.4, "decode": 0.6}``).  None keeps
    #: the predictive arm fleet-wide only (pool scalers run reactive) —
    #: the pre-split behaviour.  Shares must sum to <= 1.0: the roles
    #: PARTITION the demand, which is exactly what makes per-pool
    #: prediction safe from double-provisioning.
    role_share: Optional[Mapping[str, float]] = None

    def __post_init__(self) -> None:
        if not 0.0 <= self.burstiness < 1.0:
            raise ValueError("burstiness must be in [0, 1)")
        if self.mean_rps <= 0 or self.burst_period_s <= 0 \
                or self.per_replica_rps <= 0:
            raise ValueError("mean_rps, burst_period_s and "
                             "per_replica_rps must be > 0")
        if self.lead_s < 0 or self.tick_duration_s <= 0:
            raise ValueError("lead_s must be >= 0 and tick_duration_s "
                             "> 0")
        if self.role_share is not None:
            shares = dict(self.role_share)
            if not shares or any(not 0.0 < s <= 1.0
                                 for s in shares.values()):
                raise ValueError("role_share fractions must be in (0, 1]")
            if sum(shares.values()) > 1.0 + 1e-9:
                raise ValueError(
                    "role_share fractions must sum to <= 1.0 (the roles "
                    f"partition fleet demand), got {shares}")
            # Freeze for hashability of the frozen dataclass.
            object.__setattr__(self, "role_share",
                               tuple(sorted(shares.items())))


def diurnal_rate(mean_rps: float, burstiness: float,
                 burst_period_s: float, t_s: float) -> float:
    """The workload generator's arrival-rate envelope at time ``t_s``
    (one spelling — ``generate_workload`` modulates with exactly this,
    so anticipating it is anticipating the seeded traffic)."""
    rate = mean_rps * (1.0 + burstiness * math.sin(
        2.0 * math.pi * t_s / burst_period_s))
    return max(rate, mean_rps * (1.0 - burstiness), 1e-6)


def predicted_replicas(cfg: PredictiveArmConfig, tick: int,
                       role: Optional[str] = None) -> int:
    """Replicas the diurnal envelope will demand ``lead_s`` from now:
    the predictive arm's scale-ahead estimate, a pure function of the
    tick (deterministic drills).

    ``role`` asks for ONE disaggregated pool's slice of that demand:
    the fleet-wide rate is scaled by the pool's declared
    ``role_share`` fraction before dividing by per-replica capacity.
    Because the shares partition the demand (they sum to <= 1), the
    pools' predictions can never jointly exceed what the fleet-wide
    arm would have asked for — the double-provisioning hazard that
    used to force pool-mode scalers to run reactive-only.  Returns
    a role estimate only when the config declares a share for it;
    asking for an undeclared role raises (a silently-fleet-wide
    number would quietly double-provision)."""
    t_s = tick * cfg.tick_duration_s + cfg.lead_s
    rate = diurnal_rate(cfg.mean_rps, cfg.burstiness,
                        cfg.burst_period_s, t_s)
    if role is not None:
        shares = dict(cfg.role_share or ())
        if role not in shares:
            raise ValueError(
                f"predictive role_share declares no share for role "
                f"{role!r} (declared: {sorted(shares)})")
        rate *= shares[role]
    return max(int(math.ceil(rate / cfg.per_replica_rps)), 1)


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Scale bounds + the hysteresis band.  The up thresholds must sit
    strictly above the down thresholds (the band IS the hysteresis —
    without it a fleet at the boundary flaps every tick), the
    per-direction cool-downs bound action frequency, and a scale-down
    additionally requires ``scale_down_idle_ticks`` CONSECUTIVE
    low-pressure ticks — one quiet tick between bursts must not shed
    capacity the next burst needs."""

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_queue_per_replica: float = 4.0
    scale_up_occupancy: float = 0.85
    scale_down_queue_per_replica: float = 0.5
    scale_down_occupancy: float = 0.30
    itl_p99_target_s: Optional[float] = None
    scale_up_cooldown_ticks: int = 16
    scale_down_cooldown_ticks: int = 32
    scale_down_idle_ticks: int = 16
    predictive: Optional[PredictiveArmConfig] = None

    def __post_init__(self) -> None:
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if self.scale_down_queue_per_replica >= \
                self.scale_up_queue_per_replica:
            raise ValueError(
                "scale_down_queue_per_replica must be < "
                "scale_up_queue_per_replica (the gap is the hysteresis)")
        if self.scale_down_occupancy >= self.scale_up_occupancy:
            raise ValueError(
                "scale_down_occupancy must be < scale_up_occupancy "
                "(the gap is the hysteresis)")
        if self.itl_p99_target_s is not None \
                and self.itl_p99_target_s <= 0:
            raise ValueError("itl_p99_target_s must be > 0 or None")
        if min(self.scale_up_cooldown_ticks,
               self.scale_down_cooldown_ticks,
               self.scale_down_idle_ticks) < 1:
            raise ValueError("cooldown/idle tick counts must be >= 1")


@dataclasses.dataclass(frozen=True)
class ScaleSignals:
    """One tick's control inputs, as the fleet gathers them: queue
    depth per in-service replica (class queues + engine queues),
    KV-pool occupancy, the fleet-wide ITL p99, whether any replica's
    SLO watcher is burning budget, and the predictive arm's demand
    estimate (None = reactive only)."""

    tick: int
    in_service: int
    queue_per_replica: float
    occupancy: float
    itl_p99: Optional[float] = None
    slo_burning: bool = False
    predicted_replicas: Optional[int] = None
    #: False while no replica can safely be drained (everything mid-
    #: chaos: draining/restarting/quarantined) — a down DECISION must
    #: not be consumed (cool-down armed, streak reset) by a no-op.
    down_candidates: bool = True


def autoscale_pressure(cfg: AutoscalerConfig, sig: ScaleSignals) -> int:
    """The ONE pure decision predicate: +1 (demand exceeds capacity),
    -1 (capacity comfortably exceeds demand), 0 (inside the hysteresis
    band).  Stateless — cool-downs, idle streaks and the replica bounds
    live in :class:`Autoscaler`; sharing this function is what lets a
    drill replay recorded signals and pin the controller exactly."""
    up = (sig.queue_per_replica >= cfg.scale_up_queue_per_replica
          or sig.occupancy >= cfg.scale_up_occupancy
          or (cfg.itl_p99_target_s is not None
              and sig.itl_p99 is not None
              and sig.itl_p99 > cfg.itl_p99_target_s)
          or sig.slo_burning
          or (sig.predicted_replicas is not None
              and sig.predicted_replicas > sig.in_service))
    if up:
        return 1
    down = (sig.queue_per_replica <= cfg.scale_down_queue_per_replica
            and sig.occupancy <= cfg.scale_down_occupancy
            and not sig.slo_burning
            and (sig.predicted_replicas is None
                 or sig.predicted_replicas < sig.in_service))
    return -1 if down else 0


def choose_scale_action(cfg: AutoscalerConfig, sig: ScaleSignals,
                        tp_size: int, tp_max: int) -> str:
    """Scale-OUT vs scale-UP: once the autoscaler has decided to add
    capacity, choose its SHAPE.  Pure, like :func:`autoscale_pressure`,
    and sharing its thresholds so the two predicates cannot drift.

    * ``"up"`` — grow the model-shard dimension: the next replica is
      built with a DOUBLED tensor-parallel group (bounded by
      ``tp_max``).  Chosen when the pressure is occupancy-driven while
      the queue stays quiet: each replica's KV pool is the bottleneck,
      and a larger TP group shards the per-token KV bytes across more
      chips, so the same per-device HBM budget holds proportionally
      more blocks (the headroom gate sizes per SHARD —
      serve/engine.py).
    * ``"out"`` — add another replica of the current shape.  Chosen
      for queue-driven pressure (demand exceeds aggregate service
      rate: more independent engines beat bigger ones) and whenever
      the TP dimension is already at ``tp_max``.
    """
    if (tp_size < tp_max
            and sig.occupancy >= cfg.scale_up_occupancy
            and sig.queue_per_replica < cfg.scale_up_queue_per_replica):
        return "up"
    return "out"


class Autoscaler:
    """Stateful hysteresis around :func:`autoscale_pressure`: one
    decision per ``observe`` (the fleet calls it once per tick), bounded
    by [min, max] replicas, per-direction cool-downs, and the sustained
    low-pressure streak a scale-down requires."""

    def __init__(self, cfg: AutoscalerConfig):
        self.cfg = cfg
        self._last_up = -(10 ** 9)
        self._last_down = -(10 ** 9)
        self._low_streak = 0
        self.decisions = {"up": 0, "down": 0}

    def observe(self, sig: ScaleSignals) -> int:
        """Returns +1 (scale up now), -1 (scale down now) or 0."""
        cfg = self.cfg
        pressure = autoscale_pressure(cfg, sig)
        if pressure > 0:
            self._low_streak = 0
            if (sig.in_service < cfg.max_replicas
                    and sig.tick - self._last_up
                    >= cfg.scale_up_cooldown_ticks):
                self._last_up = sig.tick
                self.decisions["up"] += 1
                return 1
            return 0
        if pressure < 0:
            self._low_streak += 1
            if (sig.down_candidates
                    and sig.in_service > cfg.min_replicas
                    and self._low_streak >= cfg.scale_down_idle_ticks
                    and sig.tick - self._last_down
                    >= cfg.scale_down_cooldown_ticks):
                self._last_down = sig.tick
                self._low_streak = 0
                self.decisions["down"] += 1
                return -1
            return 0
        self._low_streak = 0
        return 0


__all__ = ["Autoscaler", "AutoscalerConfig", "ClassLatencyTracker",
           "ClassQueues", "DEFAULT_SLO_CLASSES", "PredictiveArmConfig",
           "SLOClass", "ScaleSignals", "TenantBuckets", "TenantQuotaConfig",
           "autoscale_pressure", "choose_scale_action",
           "class_for_priority", "diurnal_rate", "predicted_replicas"]
