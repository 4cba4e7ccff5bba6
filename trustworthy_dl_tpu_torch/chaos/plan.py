"""Deterministic fault plans: the chaos counterpart of
``attacks.adversarial.AttackPlan``.

Counterpart of ``trustworthy_dl_tpu/chaos/plan.py``, numpy only and whole:
the same kinds in the same declaration order, the same seeded draw, so the
same ``(seed, horizon, rates)`` gives the same events as the JAX package's
plan.  An ``AttackPlan`` schedules adversarial behaviour (a node lying
about its gradients); a ``FaultPlan`` schedules infrastructure failure:
non-finite state, wedged hosts, preemptions, truncated or bit-rotten
checkpoints, data-iterator failures and poisoned serving replicas.  The
plan is pure, so a survival drill can assert the exact retries, rollbacks
and restarts the supervisor performs (:meth:`FaultPlan.predict`).

Events are consumed by ``chaos.injector.FaultInjector`` at the hook points
of ``DistributedTrainer.train_epoch`` and ``CheckpointManager``.  Each
event fires once, so a post-rollback replay of the same global steps does
not re-trigger the fault that caused the rollback.  The serving-fleet
kinds are planned and predicted here; their hooks wait for the port's
serving fleet.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


class FaultKind(str, enum.Enum):
    """What breaks.  ``step`` semantics per kind are documented on
    ``FaultEvent``."""

    #: Corrupt live parameters with NaN after step ``step`` completes —
    #: every subsequent loss is genuinely non-finite until state is
    #: restored from a checkpoint (the "silently corrupted optimizer
    #: state" failure the supervisor's rollback path exists for).
    GRAD_NAN = "grad_nan"
    #: Host stall / straggler: sleep ``severity`` seconds before the step.
    STALL = "stall"
    #: Simulated preemption signal raised before the step runs — the
    #: supervisor must save-on-signal and auto-resume.
    PREEMPT = "preempt"
    #: Flip bytes in a committed checkpoint's payload (bit-rot): fires on
    #: the first checkpoint committed at global step >= ``step``.
    CKPT_CORRUPT = "ckpt_corrupt"
    #: Die between payload write and COMMIT marker: the first save at
    #: global step >= ``step`` is left uncommitted on disk.
    CKPT_CRASH = "ckpt_crash"
    #: Data-iterator failure: the batch at ``step`` is lost (the loader
    #: "raised"); training must continue on the next batch.
    DATA_LOSS = "data_loss"
    #: Poison a serving slot's output signals for request id ``step`` —
    #: the engine's output monitor must flag and quarantine the slot.
    #: With ``target >= 0`` the poison is replica-addressed: it only
    #: fires on the engine whose ``replica_id`` matches (fleet request
    #: ids are namespaced replica-locally, so an unaddressed poison
    #: would be ambiguous once N replicas share the id space).
    SERVE_POISON = "serve_poison"
    # -- fleet-granularity kinds (serve/fleet.py).  ``step`` is the
    # fleet TICK the event fires on; ``target`` the replica index. --
    #: Kill replica ``target`` at tick ``step``: its engine (and KV
    #: pool, allocator journal, in-flight work) is gone.  The fleet must
    #: fail over every accepted request it held and restart the replica.
    REPLICA_CRASH = "replica_crash"
    #: Wedge replica ``target`` for ``severity`` ticks (its engine stops
    #: making progress) — the missed-tick heartbeat must catch it, drain
    #: it, and migrate its in-flight requests.
    REPLICA_STALL = "replica_stall"
    #: Compromise replica ``target`` from tick ``step`` on: every
    #: request retiring there gets a collapsed-entropy/inflated-margin
    #: signal profile, so its monitor flag-rate must cross the
    #: quarantine threshold → drain → quarantine.  Persists until the
    #: injector's :meth:`FaultInjector.heal_replica` (a readmission
    #: probe of a still-poisoned replica must fail again).
    REPLICA_POISON = "replica_poison"
    #: Replica ``target`` restarts slowly: after tick ``step`` it takes
    #: ``severity`` extra ticks of warmup during which it accepts no new
    #: admissions (goodput dip, no failover/drain).
    REPLICA_SLOWSTART = "replica_slowstart"
    #: Compromise replica ``target`` ADAPTIVELY from tick ``step`` on:
    #: corruption is driven by a ``chaos.adversary.AdaptivePoisonAttacker``
    #: (``FaultInjector(adversary=...)``) that corrupts the served token
    #: stream and tunes its signal shaping to hold the replica's public
    #: flag rate just below ``FleetConfig.flag_rate_quarantine`` — the
    #: PR 8 ladder never trips.  Caught by the fleet's cross-replica
    #: verdict voting (``FleetConfig.vote_k``): corrupted streams
    #: disagree with their bit-identical replays.  Persists until
    #: :meth:`FaultInjector.heal_replica`.
    REPLICA_ADAPTIVE_POISON = "replica_adaptive_poison"
    #: Overload-as-a-fault: at fleet tick ``step``, tenant ``tenant``
    #: (default "flood") bursts ``severity`` requests through the
    #: fleet's admission path in one tick.  With a per-tenant token
    #: bucket configured (``FleetConfig.tenant_quota``) the bucket
    #: admits what it can pay for and THROTTLES the rest — loudly
    #: (``tenant_throttle`` events +
    #: ``tddl_fleet_tenant_throttled_total{tenant=}``) — so the flood
    #: backpressures itself, not the fleet; admitted flood requests are
    #: real accepted work and drive the autoscaler like any burst.  The
    #: replica ``target`` is meaningless for this kind (-1).
    TENANT_FLOOD = "tenant_flood"
    #: Compromise ADAPTER ``tenant`` from tick ``step`` on (the adapter
    #: id rides the ``tenant`` field — like TENANT_FLOOD the fault is
    #: artifact-addressed, not replica-addressed: a poisoned adapter is
    #: wherever its pool page is resident).  Every request retiring
    #: UNDER that adapter — on any replica — gets the collapsed-entropy
    #: poison signal profile, so the fleet's per-ADAPTER flag-rate
    #: window must trip and quarantine the adapter fleet-wide while the
    #: replicas that hosted it stay HEALTHY (zero drains, zero replica
    #: quarantines).  Persists until
    #: :meth:`FaultInjector.heal_adapter`.
    ADAPTER_POISON = "adapter_poison"
    #: Preempt replica ``target`` at tick ``step`` — the serving twin of
    #: the training-side ``PREEMPT``: the capacity is GOING AWAY (spot
    #: reclaim, eviction) but the fleet gets one tick of warning, so
    #: every in-flight request it holds must MIGRATE (live KV
    #: block-table copy, ``serve/migrate.py``) to a surviving replica
    #: instead of replaying from scratch; queued work re-queues.  The
    #: replica then restarts like a crash (``restart_ticks`` warmup) but
    #: with zero lost decode work and zero failover episodes.
    #: Declared LAST so generated plans' seeded draw streams for the
    #: older kinds are unchanged (``generate`` iterates in enum order).
    REPLICA_PREEMPT = "replica_preempt"


#: The serving-fleet kinds (consumed by ``FaultInjector.on_fleet_tick``
#: / ``on_serve_retire`` rather than the trainer hooks).
FLEET_KINDS = (FaultKind.REPLICA_CRASH, FaultKind.REPLICA_STALL,
               FaultKind.REPLICA_POISON, FaultKind.REPLICA_SLOWSTART,
               FaultKind.REPLICA_ADAPTIVE_POISON,
               FaultKind.TENANT_FLOOD, FaultKind.ADAPTER_POISON,
               FaultKind.REPLICA_PREEMPT)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``step`` is the trainer's *global step* for
    training-side kinds, the minimum save step for checkpoint kinds, the
    request id for ``SERVE_POISON`` and the fleet tick for the
    ``REPLICA_*`` kinds.  ``severity`` is kind-specific (stall
    seconds/ticks, poison magnitude, slow-start warmup ticks); unused
    kinds ignore it.  ``target`` addresses a replica (fleet kinds and
    replica-gated serve poison); ``-1`` = unaddressed (any replica).
    ``tenant`` names the flooding tenant for ``TENANT_FLOOD`` (None =
    the fleet's default flood tenant); other kinds ignore it."""

    step: int
    kind: FaultKind
    severity: float = 1.0
    target: int = -1
    tenant: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable, seeded schedule of ``FaultEvent``s.

    Build with :meth:`generate` (seeded rates over a step horizon) or
    :meth:`scripted` (explicit events, for drills that must predict exact
    recovery counts).  The plan itself is pure; all firing state lives in
    the injector.
    """

    seed: int
    events: Tuple[FaultEvent, ...]

    @classmethod
    def scripted(cls, events: Sequence[FaultEvent], seed: int = 0
                 ) -> "FaultPlan":
        return cls(seed=seed,
                   events=tuple(sorted(events, key=lambda e: e.step)))

    @classmethod
    def generate(cls, seed: int, num_steps: int,
                 rates: Mapping[FaultKind, float],
                 severity: float = 1.0,
                 num_replicas: Optional[int] = None) -> "FaultPlan":
        """Seeded Bernoulli draw per (step, kind): the same arguments
        always produce the same plan, so a drill is reproducible from its
        seed alone.  ``rates`` maps kind -> per-step probability.
        ``num_replicas`` seeds a replica ``target`` for the fleet kinds
        (drawn from the same stream — required when their rates are
        nonzero, since an unaddressed fleet fault has no victim)."""
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        # Fixed kind order (enum declaration order) keeps the draw stream
        # stable across python versions / dict orderings.
        kinds = [k for k in FaultKind if rates.get(k, 0.0) > 0.0]
        # TENANT_FLOOD and ADAPTER_POISON are fleet-granularity but
        # tenant-/adapter-addressed, not replica-addressed — they need
        # no target draw.
        addressed = [k for k in kinds
                     if k in FLEET_KINDS
                     and k not in (FaultKind.TENANT_FLOOD,
                                   FaultKind.ADAPTER_POISON)]
        if num_replicas is None and addressed:
            raise ValueError(
                "fleet fault rates need num_replicas to draw targets"
            )
        for step in range(num_steps):
            for kind in kinds:
                if rng.random() < rates[kind]:
                    target = (int(rng.integers(num_replicas))
                              if kind in addressed else -1)
                    events.append(FaultEvent(
                        step=step, kind=kind,
                        severity=float(severity * (0.5 + rng.random())),
                        target=target,
                    ))
        return cls(seed=seed, events=tuple(events))

    def of_kind(self, kind: FaultKind) -> List[FaultEvent]:
        return [e for e in self.events if e.kind is kind]

    def count(self, kind: FaultKind) -> int:
        return len(self.of_kind(kind))

    def at(self, step: int, kind: Optional[FaultKind] = None
           ) -> List[FaultEvent]:
        """Events scheduled exactly at ``step`` (optionally one kind)."""
        return [e for e in self.events
                if e.step == step and (kind is None or e.kind is kind)]

    def predict(self, max_retries: int, rollback_after: int
                ) -> Dict[str, int]:
        """Expected supervisor recovery counts for this plan under a
        ``TrainingSupervisor(max_retries=..., rollback_after=...)``.

        Valid when events are *isolated*: GRAD_NAN events spaced further
        apart than the rollback window, and a verified checkpoint existing
        before each (the supervisor writes one at start, so this holds for
        any plan whose first GRAD_NAN is after step 0).  Each GRAD_NAN
        corrupts state persistently, so every retry of a bad step fails:
        the supervisor burns ``max_retries`` retries on each of
        ``rollback_after`` consecutive bad steps, then rolls back once.
        """
        n_nan = self.count(FaultKind.GRAD_NAN)
        return {
            "retries": n_nan * rollback_after * max_retries,
            "rollbacks": n_nan,
            "restarts": self.count(FaultKind.PREEMPT),
            "preemptions": self.count(FaultKind.PREEMPT),
            "dropped_batches": self.count(FaultKind.DATA_LOSS),
            "stalls": self.count(FaultKind.STALL),
        }

    def predict_fleet(self, vote_k: int = 0, vote_outvote_limit: int = 2,
                      horizon: Optional[int] = None,
                      cooloff_ticks: Optional[int] = None,
                      autoscale: bool = False,
                      quota_tokens: Optional[float] = None,
                      flood_request_tokens: Optional[int] = None,
                      preempt_inflight: Optional[int] = None
                      ) -> Dict[str, int]:
        """Expected ``ServingFleet`` recovery counts for this plan's
        REPLICA_* events (the serving mirror of :meth:`predict`).
        ``vote_k``/``vote_outvote_limit`` mirror the drill's
        ``FleetConfig`` verdict-voting knobs (0 = voting off).

        Valid when events are *isolated* — at most one fleet fault per
        replica, each given room to complete its recovery arc: a STALL's
        severity (ticks) exceeds the fleet's heartbeat-miss limit, a
        poisoned replica retires at least ``flag_min_count`` requests
        while poisoned, and the drill runs long enough for every drain
        to complete — but ENDS before any quarantined replica's
        cool-off expires (or the poison is healed first): an unhealed
        replica re-trips on every readmission probe by design, adding a
        drain + quarantine per probe beyond the first.  Drills pin
        ``quarantine_cooloff_ticks`` past their horizon — pass
        ``horizon`` (the drill's tick budget) and ``cooloff_ticks``
        (the config's first cool-off) and this method ENFORCES the
        bound, raising instead of silently producing counts the probe
        churn would falsify.  Under those conditions each event's
        recovery arc is exact:

        * CRASH  → 1 failover episode (everything the replica held
          migrates at once) + 1 restart;
        * STALL  → 1 drain (heartbeat trips) + 1 failover episode;
        * POISON → 1 suspicion episode + 1 drain (monitor flag-rate
          crosses the quarantine threshold) + 1 quarantine (the
          suspicion EWMA crosses on the way to the trip — valid at the
          fleet defaults, where ``suspicion_threshold`` <= the EWMA of
          ``flag_min_count`` consecutive flags);
        * SLOWSTART → 1 slow-start warmup (goodput only — no failover,
          drain or quarantine);
        * ADAPTIVE_POISON → 1 suspicion episode always; with
          ``vote_k >= 2``: exactly ``vote_outvote_limit`` verdict votes
          (sequential per suspect, every one outvoted — the attacker
          corrupts every stream while active) then 1 drain +
          1 quarantine; with ``vote_k == 0`` NOTHING else — the
          sub-threshold attacker is the ladder's documented blind spot.
          Additional validity: >= ``vote_k`` other replicas stay
          admitting and the suspect keeps retiring requests until the
          outvote limit lands.  ``vote_k == 1`` is rejected: a lone
          voter can never outvote anyone (majority needs two agreeing
          dissenters), so vote counts are traffic-bound, not pinnable.
        * TENANT_FLOOD → 1 tenant_flood; with a token bucket
          (``quota_tokens`` = the flooding tenant's bucket capacity,
          ``flood_request_tokens`` = the fleet's per-flood-request cost
          ``flood_prompt_len + flood_new_tokens``) each event throttles
          exactly ``severity - quota_tokens // flood_request_tokens``
          submissions (floored at 0).  Valid when flood events are
          *isolated*: the bucket sits at capacity when each fires
          (events spaced >= capacity / refill ticks apart) and no other
          traffic spends the flooding tenant's bucket.  With
          ``autoscale=True`` each flood additionally trips exactly ONE
          scale-up and ONE scale-down — valid when the admitted burst
          crosses the scale-up predicate (and the background traffic
          never does), ``max_replicas - min_replicas`` equals the flood
          count (the bound absorbs repeat pressure), and the run idles
          past the drain + ``scale_down_idle_ticks`` + cool-down so
          every extra replica retires back to the floor.  Scale-downs
          drain, so they are COUNTED in ``drains`` too.
        * ADAPTER_POISON → 1 adapter_poison + 1 adapter_quarantine (the
          fleet-wide per-ADAPTER flag window trips once the adapter
          retires ``flag_min_count`` requests while poisoned) — and
          NOTHING on the replica side: zero drains, zero replica
          quarantines, zero suspicions.  The replicas hosting the
          poisoned page stay HEALTHY by design; the quarantine lands on
          the artifact.  Valid when at least ``flag_min_count``
          adapter-attributed requests retire after the event and the
          adapter is not released before the drill ends.
        * REPLICA_PREEMPT → 1 preempt + 1 restart, and with
          ``preempt_inflight`` (the number of LIVE in-flight requests
          each preempted replica holds when its event fires) exactly
          ``preempt_inflight`` live KV migrations per event — the
          ``migrations`` key is emitted ONLY when the caller pins that
          number, since it is traffic-determined.  Valid when every
          migration finds a destination (surviving admitting capacity
          with pool headroom for every block table) — then the arc is
          a block copy, not a recovery: zero failover episodes, zero
          drains, zero lost accepted requests.
        """
        if vote_k == 1:
            raise ValueError(
                "vote_k=1 is not predictable (a lone voter can never "
                "outvote — votes recur per suspect retirement); use "
                "vote_k >= 2 for verdict quarantines or 0 for off"
            )
        crashes = self.count(FaultKind.REPLICA_CRASH)
        preempts = self.count(FaultKind.REPLICA_PREEMPT)
        stalls = self.count(FaultKind.REPLICA_STALL)
        poisons = self.count(FaultKind.REPLICA_POISON)
        adaptive = self.count(FaultKind.REPLICA_ADAPTIVE_POISON)
        if horizon is not None and cooloff_ticks is not None:
            for event in self.events:
                if event.kind not in (FaultKind.REPLICA_POISON,
                                      FaultKind.REPLICA_ADAPTIVE_POISON):
                    continue
                # Conservative earliest quarantine = the event's own
                # tick; if even that cool-off expires inside the
                # horizon, the readmission probe of a still-poisoned
                # replica re-trips and every pinned count below is
                # wrong.  Loud, not silently off-by-a-probe.
                if event.step + cooloff_ticks < horizon:
                    raise ValueError(
                        f"predict_fleet validity bound: {event.kind.value}"
                        f" at tick {event.step} with cooloff_ticks="
                        f"{cooloff_ticks} expires at tick "
                        f"{event.step + cooloff_ticks}, inside the "
                        f"horizon {horizon} — the readmission probe "
                        "re-trips and adds a drain + quarantine per "
                        "probe; pin quarantine_cooloff_ticks past the "
                        "drill or heal the replica first"
                    )
        caught = adaptive if vote_k >= 2 else 0
        floods = self.of_kind(FaultKind.TENANT_FLOOD)
        throttles = 0
        if quota_tokens is not None:
            if not flood_request_tokens or flood_request_tokens < 1:
                raise ValueError(
                    "quota_tokens needs flood_request_tokens (the "
                    "fleet's flood_prompt_len + flood_new_tokens) to "
                    "pin throttle counts"
                )
            per_event = int(quota_tokens) // int(flood_request_tokens)
            for event in floods:
                # Same floor as the fleet's _run_flood: a sub-1
                # severity still bursts one request.
                n = max(int(event.severity), 1)
                throttles += max(0, n - per_event)
        scale_events = len(floods) if autoscale else 0
        counts = {
            "crashes": crashes,
            "preempts": preempts,
            "restarts": crashes + preempts,
            "stalls": stalls,
            "poisons": poisons,
            "adaptive_poisons": adaptive,
            "slowstarts": self.count(FaultKind.REPLICA_SLOWSTART),
            "failover_episodes": crashes + stalls,
            "suspicions": poisons + adaptive,
            "votes": caught * vote_outvote_limit,
            "outvotes": caught * vote_outvote_limit,
            "drains": stalls + poisons + caught + scale_events,
            "quarantines": poisons + caught,
            "tenant_floods": len(floods),
            "throttles": throttles,
            "scale_ups": scale_events,
            "scale_downs": scale_events,
            "adapter_poisons": self.count(FaultKind.ADAPTER_POISON),
            "adapter_quarantines": self.count(FaultKind.ADAPTER_POISON),
            "adapter_throttles": 0,
        }
        if preempt_inflight is not None:
            counts["migrations"] = preempts * int(preempt_inflight)
        return counts
