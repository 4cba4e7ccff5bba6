"""Trust-aware serving fleet: N engine replicas behind one ``submit()``.

Counterpart of ``trustworthy_dl_tpu/serve/fleet.py``: every replica is a
``ServingEngine`` in this process on the one card, stepped by a
synchronous tick loop.  One engine is one failure domain; the fleet
reuses the training trust stack at replica granularity:

* **Replica lifecycle** -- ``healthy -> degraded -> draining ->
  quarantined -> restarting`` -- driven by the signals the engines already
  produce (monitor flag rate, missed-tick heartbeat, per-replica SLO and
  anomaly watchers).  A replica whose flag rate crosses the quarantine
  threshold is drained and quarantined with a cool-off readmission probe;
  a still-poisoned replica re-flags during its probe and goes back with a
  doubled cool-off.
* **Fail-over** -- a request on a crashed, stalled or draining replica is
  resubmitted elsewhere with bounded retries and exponential backoff,
  keeping its first submission's age (``ServeRequest.first_submit_id``).
  A request near its deadline can launch a **hedged duplicate**; the
  first completed attempt wins, the others are cancelled and recorded
  ``admitted: false, status: "hedge_lost"``.
* **Fleet chaos** -- the plan's REPLICA_* kinds (crash, stall, poison,
  slow-start, preempt), ADAPTER_POISON and TENANT_FLOOD drive drills whose
  counts ``FaultPlan.predict_fleet()`` pins.  A preemption and a stalled
  or draining replica move their in-flight requests as live KV block
  copies (``serve/migrate.py``); what cannot move replays from the prompt.
* **Suspicion and votes** -- below the quarantine threshold an EWMA
  suspicion score over monitor verdicts (plus watcher episodes and
  :meth:`ServingFleet.note_suspicion`) emits ``fleet_suspicion`` and the
  ``tddl_fleet_suspicion{replica=}`` gauge.  With ``vote_k >= 1`` a
  request completed on a suspected replica is replayed on K others and
  the streams are majority-voted by ``token_hash``; ``vote_outvote_limit``
  outvotes send the replica down the same drain -> quarantine ladder.
* **Adapter trust** -- an adapter's flags pool fleet-wide; a trip
  quarantines the adapter on every replica while the replicas stay in
  service.
* **The control plane** (``serve/control.py``, every piece opt-in through
  ``FleetConfig``) -- SLO classes: submissions queue at the fleet in
  per-class deficit-round-robin queues dispatched each tick, and under a
  per-class latency breach the lowest class sheds first.  Tenant and
  adapter token buckets: a submission costs prompt + max_new tokens
  against its tenant's bucket (and its adapter's); a flooding tenant
  throttles itself, loudly, and a submission the fleet rejects afterwards,
  or a request that dies unserved, is refunded once.  The autoscaler:
  queue depth per replica, pool occupancy, the fleet-wide ITL p99, SLO
  burn and the predictive arm drive the replica count between its bounds;
  a scale-up builds a replica mid-run and warms it through RESTARTING, a
  scale-down drains its replica (the queue moves, in-flight work moves as
  live copies or runs out) into RETIRED, whose journal is kept and whose
  index the next scale-up revives as a new generation.  Disaggregated
  pools (``pool_roles``): submissions prefer prefill replicas, and a
  request that has emitted its first decode token moves to a decode
  replica as a live block copy; each pool scales on its own signals.
* **Tensor-parallel replicas** -- ``FleetConfig.tp_size`` is every initial
  replica's TP width (an engine with a TP mesh, ``serve/engine.py``), so
  capacity is a replicas x model-shards grid (``chips_in_service``).  With
  ``tp_max`` above it the autoscaler chooses the shape of each scale-up
  (``control.choose_scale_action``): occupancy pressure under a quiet
  queue brings the new replica with a doubled TP group, queue pressure
  adds one of the current width.  A rebuild keeps its replica's width.
  Each replica takes a contiguous slice of the local cards where there
  are enough; on one card every group's positions share it.

Time is counted in ticks (``step()`` = chaos -> step each live replica ->
retirements -> supervision -> retries and hedges), so drills are
deterministic; request deadlines stay wall-clock.

Attribution: each engine runs ledger-less; the fleet writes one canonical
record per request at its final retirement, with an ``attempts`` list
(placement and journal key per attempt), so one record's blocks can span
two replicas' allocators.  ``verify_attribution`` checks each attempt
against its replica generation's block journal (``journals``; a crashed
replica's journal is kept).  Streaming is at-least-once: after a
fail-over the new attempt streams from token 0.

How a replica gets its telemetry.  The fleet takes JAX's separate
attachments (``trace``, ``registry``, ``spans``, ``ledger``,
``forensics``) or an ``ObsSession`` (``obs=``) whose enabled parts fill
the ones not given.  Each replica engine is built with ``obs=`` a
:class:`ReplicaObs` view: the fleet's trace, registry and spans, the
session's HBM monitor and compile watcher, its own SLO and anomaly
watchers when ``attach_watchers`` or ``slo_rules`` asks for them, and no
ledger.  Its ``tddl_serve_*`` series carry ``replica=``.

Random numbers.  JAX hands each fleet request one rng key that every
attempt, hedge and vote replay reuses.  Here each fleet request gets one
sampling seed, its own ``ServeRequest.seed`` or a SplitMix64 mix of the
fleet ``seed`` and its fleet id, passed as ``ServeRequest.seed`` on every
attempt, hedge and vote replay, so a survivor's stream equals a single
engine's given that seed; replica engines take seeds mixed from the fleet
seed and their index.  Greedy streams equal JAX's bit for bit.

"""

from __future__ import annotations

import dataclasses
import enum
import logging
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

import torch

from trustworthy_dl_tpu_torch.chaos.plan import FaultKind
from trustworthy_dl_tpu_torch.obs import attribution
from trustworthy_dl_tpu_torch.obs.events import EventType
from trustworthy_dl_tpu_torch.obs.registry import get_registry
from trustworthy_dl_tpu_torch.obs.slo import StreamingPercentiles
from trustworthy_dl_tpu_torch.serve.control import (Autoscaler,
                                                    ClassLatencyTracker,
                                                    ClassQueues,
                                                    ScaleSignals,
                                                    TenantBuckets,
                                                    choose_scale_action,
                                                    class_for_priority,
                                                    predicted_replicas)
from trustworthy_dl_tpu_torch.serve.engine import (ServeRequest, ServeResult,
                                                   ServingEngine,
                                                   resolve_device)
from trustworthy_dl_tpu_torch.serve.migrate import can_migrate, \
    migrate_request
from trustworthy_dl_tpu_torch.serve.scheduler import draw_seed

logger = logging.getLogger(__name__)


class ReplicaState(str, enum.Enum):
    """The replica lifecycle ladder."""

    HEALTHY = "healthy"          # admitting and serving
    DEGRADED = "degraded"        # admitting, under suspicion
    DRAINING = "draining"        # no admissions; work runs out or moves
    QUARANTINED = "quarantined"  # out of service, cool-off running
    RESTARTING = "restarting"    # warming up (restart, probe, slow-start)
    RETIRED = "retired"          # scaled in: pool released, journal kept


#: States the router may place new work on.
ADMITTING = (ReplicaState.HEALTHY, ReplicaState.DEGRADED)

#: Statuses that end a fleet request (every other status is an attempt
#: outcome the fleet recovers from).
TERMINAL_STATUSES = ("completed", "deadline_exceeded", "shed_slo",
                     "no_capacity", "failover_exhausted")


@dataclasses.dataclass
class FleetConfig:
    """Host-side fleet knobs, JAX's fields, defaults and validation.
    Tick-denominated fields follow the fleet clock (one ``step()`` = one
    tick).  ``tp_size`` is every initial replica's tensor-parallel width;
    ``tp_max`` (0: ``tp_size``) bounds the autoscaler's scale-up to a
    doubled TP group."""

    num_replicas: int = 2
    # trust: the monitor's flag rate over a window of retirements
    flag_window: int = 16
    flag_min_count: int = 2
    flag_rate_quarantine: float = 0.25
    # heartbeat: missed fleet ticks without replica progress
    heartbeat_miss_degraded: int = 2
    heartbeat_miss_limit: int = 4
    # fail-over
    max_retries: int = 3
    backoff_base_ticks: int = 1
    backoff_mult: float = 2.0
    # hedging (None = off): duplicate a request whose remaining deadline
    # drops below this
    hedge_deadline_s: Optional[float] = None
    # lifecycle timing (ticks)
    restart_ticks: int = 2
    quarantine_cooloff_ticks: int = 32
    drain_grace_ticks: int = 8
    # per-replica SLO and anomaly watchers as extra degraded signals
    attach_watchers: bool = False
    # the suspicion tier below the quarantine threshold
    suspicion_ewma_alpha: float = 0.2
    suspicion_threshold: float = 0.1
    suspicion_min_flags: int = 2
    # cross-replica verdict voting (0 = off)
    vote_k: int = 0
    vote_outvote_limit: int = 2
    # the control plane (serve/control.py), every piece opt-in:
    # SLO classes (control.SLOClass): submissions queue at the fleet in
    # per-class DRR queues; None submits straight to a replica
    slo_classes: Optional[Tuple[Any, ...]] = None
    class_queue_limit: int = 256
    drr_quantum_tokens: int = 32
    class_latency_min_count: int = 8
    # token-bucket admission (control.TenantQuotaConfig), by tenant and by
    # adapter id; tenant None and unadapted requests bypass them
    tenant_quota: Optional[Any] = None
    adapter_quota: Optional[Any] = None
    # the autoscaler (control.AutoscalerConfig); None = a static fleet
    autoscale: Optional[Any] = None
    # TENANT_FLOOD request shape: prompt [0] * flood_prompt_len,
    # flood_new_tokens new tokens
    flood_prompt_len: int = 4
    flood_new_tokens: int = 4
    # disaggregated pools: one role per initial replica, "prefill" or
    # "decode", at least one of each; None = a unified fleet
    pool_roles: Optional[Tuple[str, ...]] = None
    # False: no live migration anywhere (drains run out or replay,
    # preemptions replay)
    live_migration: bool = True
    # tensor-parallel width of every initial replica, and the widest group
    # a scale-up may build (0: tp_size, no scale-up dimension)
    tp_size: int = 1
    tp_max: int = 0

    def __post_init__(self) -> None:
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")
        if self.tp_max and self.tp_max < self.tp_size:
            raise ValueError(
                f"tp_max={self.tp_max} must be 0 (= tp_size) or >= "
                f"tp_size={self.tp_size}")
        if self.num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        if not 0.0 < self.flag_rate_quarantine <= 1.0:
            raise ValueError("flag_rate_quarantine must be in (0, 1]")
        if self.flag_min_count < 1 or self.flag_window < self.flag_min_count:
            raise ValueError("need 1 <= flag_min_count <= flag_window")
        if self.heartbeat_miss_limit < self.heartbeat_miss_degraded:
            raise ValueError("heartbeat_miss_limit must be >= "
                             "heartbeat_miss_degraded")
        if self.max_retries < 0 or self.backoff_base_ticks < 0:
            raise ValueError("max_retries/backoff_base_ticks must be >= 0")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1")
        if not 0.0 < self.suspicion_ewma_alpha <= 1.0:
            raise ValueError("suspicion_ewma_alpha must be in (0, 1]")
        if not 0.0 < self.suspicion_threshold < 1.0:
            raise ValueError("suspicion_threshold must be in (0, 1)")
        if self.suspicion_min_flags < 1:
            raise ValueError("suspicion_min_flags must be >= 1")
        if self.vote_k < 0 or self.vote_outvote_limit < 1:
            raise ValueError("vote_k must be >= 0 and "
                             "vote_outvote_limit >= 1")
        if self.class_queue_limit < 1 or self.drr_quantum_tokens < 1 \
                or self.class_latency_min_count < 1:
            raise ValueError("class_queue_limit, drr_quantum_tokens and "
                             "class_latency_min_count must be >= 1")
        if self.flood_prompt_len < 1 or self.flood_new_tokens < 1:
            raise ValueError("flood_prompt_len and flood_new_tokens "
                             "must be >= 1")
        if self.autoscale is not None and not (
                self.autoscale.min_replicas <= self.num_replicas
                <= self.autoscale.max_replicas):
            raise ValueError(
                f"num_replicas={self.num_replicas} must start inside "
                f"the autoscale bounds [{self.autoscale.min_replicas}, "
                f"{self.autoscale.max_replicas}]")
        if self.pool_roles is not None:
            roles = tuple(self.pool_roles)
            if len(roles) != self.num_replicas:
                raise ValueError(
                    f"pool_roles needs one role per replica: got "
                    f"{len(roles)} for num_replicas={self.num_replicas}")
            bad = sorted(set(roles) - {"prefill", "decode"})
            if bad:
                raise ValueError(f"pool_roles must be 'prefill' or "
                                 f"'decode', got {bad}")
            if not ({"prefill", "decode"} <= set(roles)):
                raise ValueError("pool_roles needs at least one prefill "
                                 "AND one decode replica")


def backoff_ticks(cfg: FleetConfig, attempt: int) -> int:
    """Ticks resubmission number ``attempt`` (1-based) waits:
    ``base * mult**(attempt-1)``."""
    if attempt < 1:
        raise ValueError("attempt is 1-based")
    return int(cfg.backoff_base_ticks * cfg.backoff_mult ** (attempt - 1))


@dataclasses.dataclass
class FleetResult:
    """Terminal record of one fleet request (the canonical stream)."""

    request_id: int                # fleet id
    tokens: List[int]
    status: str                    # see TERMINAL_STATUSES
    replica: Optional[int]         # replica that produced the stream
    attempts: int                  # submissions it took (1 = no fail-over)
    ttft_s: Optional[float]        # first fleet submit -> first token
    flagged: bool = False
    monitor_z: float = 0.0
    tenant: Optional[str] = None
    slo_class: Optional[str] = None  # class it was scheduled under
    adapter: Optional[str] = None


@dataclasses.dataclass
class ReplicaObs:
    """A replica engine's telemetry view (its ``obs=``): the fleet's trace,
    registry and spans, the session's HBM monitor and compile watcher, the
    replica's own watchers, and no ledger (the fleet writes the
    records)."""

    trace: Any = None
    registry: Any = None
    spans: Any = None
    slo: Any = None
    anomaly: Any = None
    hbm: Any = None
    compilewatch: Any = None
    ledger: Any = None


@dataclasses.dataclass
class _Attempt:
    replica: int
    gen: int
    local_id: int
    submit_t: float
    span: Optional[int] = None     # fleet.attempt span id
    loser: bool = False            # cancelled as a hedge or dedup loser


@dataclasses.dataclass
class _Vote:
    """One in-flight verdict vote (one per suspect at a time):
    ``ballots`` maps voter -> replay token_hash (None: abstained), and the
    vote resolves once ``pending`` empties."""

    fid: int
    target: int
    original_hash: str
    ballots: Dict[int, Optional[str]] = dataclasses.field(
        default_factory=dict)
    pending: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _FleetRequest:
    fid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float
    eos_id: Optional[int]
    priority: int
    seed: int                      # every attempt reuses it
    on_token: Optional[Callable[[int, int], None]]
    deadline_at: Optional[float]   # absolute perf_counter deadline
    submit_t: float = 0.0
    live: Dict[int, _Attempt] = dataclasses.field(default_factory=dict)
    closed: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    submissions: int = 0
    retry_due: Optional[int] = None   # tick a pending resubmit is due
    excluded: Set[int] = dataclasses.field(default_factory=set)
    hedged: bool = False
    done: bool = False
    span_root: Optional[int] = None
    tenant: Optional[str] = None
    slo_class: Optional[str] = None
    adapter: Optional[str] = None  # resolved at the fleet boundary
    cost: int = 0                  # prompt + max_new (bucket and DRR tokens)


class _Replica:
    """One replica's supervision state (host only)."""

    def __init__(self, index: int, engine: Any, flag_window: int):
        self.index = index
        self.engine = engine
        self.gen = 0
        self.role = "mixed"         # pool role; "mixed" = a unified fleet
        self.tp = 1                 # tensor-parallel group width
        self.state = ReplicaState.HEALTHY
        self.last_progress_tick = 0
        self.stalled_until = -1     # chaos wedge: step() skipped until
        self.warm_until = -1        # RESTARTING exits at this tick
        self.cooloff_until = -1     # QUARANTINED exits at this tick
        self.cooloff_ticks = 0      # current cool-off length (doubles)
        self.drain_deadline = -1
        self.quarantine_pending = False
        self.retire_pending = False  # scale-down drain: retire when empty
        self.reason = ""
        self.flags: Deque[int] = deque(maxlen=flag_window)
        self.suspicion = 0.0
        self.total_flags = 0        # lifetime flags this generation
        self.suspicion_noted = False  # a note_suspicion boost received
        self.suspicion_episode = False
        self.outvotes = 0
        self.vote_open = False      # one vote in flight per suspect

    def reset_trust_window(self) -> None:
        """A fresh generation's evidence starts over: the window, the
        suspicion score and the outvote tally."""
        self.flags.clear()
        self.suspicion = 0.0
        self.total_flags = 0
        self.suspicion_noted = False
        self.suspicion_episode = False
        self.outvotes = 0
        self.vote_open = False

    @property
    def journal_key(self) -> str:
        return f"{self.index}:{self.gen}"

    @property
    def flag_count(self) -> int:
        return sum(self.flags)

    @property
    def flag_rate(self) -> float:
        return self.flag_count / len(self.flags) if self.flags else 0.0

    def ladder_tripped(self, cfg: FleetConfig) -> bool:
        """The flag-rate trip predicate (supervision and the vote tier's
        guard)."""
        return (self.flag_count >= cfg.flag_min_count
                and self.flag_rate >= cfg.flag_rate_quarantine)


class ServingFleet:
    """N ``ServingEngine`` replicas behind one ``submit()`` (module
    docstring).  ``engine_kwargs`` pass through to every engine build;
    ``chaos`` is a ``chaos.FaultInjector``; ``seed`` seeds the requests
    and replicas; ``device`` defaults to CUDA and raises without it unless
    ``device="cpu"`` is passed.  ``engine_factory(replica_index,
    **kwargs)`` is the test seam: it must honour the ``replica_id``,
    ``retire_hook``, ``obs`` and ``chaos`` kwargs."""

    def __init__(self, params: Any = None, cfg: Any = None, *,
                 fleet_config: Optional[FleetConfig] = None,
                 num_replicas: Optional[int] = None,
                 chaos: Any = None, obs: Any = None, trace: Any = None,
                 registry: Any = None, spans: Any = None,
                 ledger: Any = None, forensics: Any = None,
                 seed: int = 0,
                 engine_factory: Optional[Callable[..., Any]] = None,
                 slo_rules: Any = None, device: Any = "cuda",
                 **engine_kwargs: Any):
        self.config = fleet_config or FleetConfig(
            num_replicas=num_replicas or 2)
        if num_replicas is not None:
            self.config = dataclasses.replace(self.config,
                                              num_replicas=num_replicas)
        # The replicas' TP width: the fleet config's, or a wider tp_size
        # riding the engine kwargs (from_config passes the ServeConfig's);
        # popped, since a scale-up may widen one replica past it.
        self._base_tp = max(int(engine_kwargs.pop("tp_size", 1) or 1),
                            self.config.tp_size)
        self.device = resolve_device(device)
        self.obs = obs
        pick = (lambda given, name: given if given is not None
                else getattr(obs, name, None))
        self.chaos = chaos
        self.trace = pick(trace, "trace")
        self.spans = pick(spans, "spans")
        self.ledger = pick(ledger, "ledger")
        # Quarantines, adapter impounds, preemptions and refused
        # migrations each assemble an incident; the assembler's verdict
        # store gets the suspicion, vote and quarantine history.
        self.forensics = pick(forensics, "forensics")
        self.verdicts = getattr(self.forensics, "verdicts", None)
        #: Per-destination refusals of the last failed _live_migrate walk.
        self._last_migration_refusals: List[Dict[str, Any]] = []
        self._params = params
        self._cfg = cfg
        self._engine_kwargs = dict(engine_kwargs, device=self.device)
        # Watchers are built per replica: a breach is a replica-local
        # signal (one slow replica must not shed the fleet's admissions).
        self._slo_rules = slo_rules
        self._factory = engine_factory or self._default_factory
        self.seed = int(seed)
        registry = pick(registry, "registry")
        self.registry = registry if registry is not None else get_registry()
        reg = self.registry
        self._replicas_gauge = reg.gauge(
            "tddl_fleet_replicas", "Replicas per lifecycle state",
            labels=("state",))
        self._failover_counter = reg.counter(
            "tddl_fleet_failovers_total",
            "Requests resubmitted after a replica failure/drain")
        self._hedge_counter = reg.counter(
            "tddl_fleet_hedges_total",
            "Hedged duplicates launched for deadline-pressed requests")
        self._transition_counter = reg.counter(
            "tddl_fleet_transitions_total",
            "Replica lifecycle transitions, by destination state",
            labels=("to_state",))
        self._suspicion_gauge = reg.gauge(
            "tddl_fleet_suspicion",
            "EWMA suspicion score per replica (sub-threshold tier)",
            labels=("replica",))
        self._suspicion_counter = reg.counter(
            "tddl_fleet_suspicions_total",
            "Suspicion episodes opened (score crossed the threshold)")
        self._vote_counter = reg.counter(
            "tddl_fleet_votes_total",
            "Cross-replica verdict votes resolved, by outcome",
            labels=("outcome",))
        # Deployment-level sums beside the replica-labelled serve gauges.
        self._tif_gauge = reg.gauge(
            "tddl_fleet_tokens_in_flight",
            "Cached tokens backing live sequences, summed over replicas")
        self._queue_gauge = reg.gauge(
            "tddl_fleet_queue_depth",
            "Queued + in-flight requests, summed over live replicas")
        # The control plane: throttles by tenant and adapter, scale events
        # by direction, per-class fleet queue depth.
        self._throttle_counter = reg.counter(
            "tddl_fleet_tenant_throttled_total",
            "Submissions throttled by the per-tenant token bucket",
            labels=("tenant",))
        self._adapter_throttle_counter = reg.counter(
            "tddl_fleet_adapter_throttled_total",
            "Submissions throttled by the per-adapter token bucket",
            labels=("adapter",))
        self._scale_counter = reg.counter(
            "tddl_fleet_scale_events_total",
            "Autoscaler replica-count changes, by direction",
            labels=("direction",))
        self._migration_counter = reg.counter(
            "tddl_fleet_migrations_total",
            "In-flight requests live-migrated as KV block copies",
            labels=("reason",))
        self._pool_gauge = reg.gauge(
            "tddl_fleet_pool_replicas",
            "In-service replicas per disaggregated pool role",
            labels=("role",))
        self._chips_gauge = reg.gauge(
            "tddl_fleet_chips",
            "Devices occupied: in-service replicas weighted by their "
            "tensor-parallel group width")
        self._classq_gauge = reg.gauge(
            "tddl_fleet_class_queue_depth",
            "Fleet admission-queue depth, by SLO class",
            labels=("slo_class",))
        self.tick = 0
        self._next_fid = 0
        self.rejected = 0
        self._max_seq: Optional[int] = None
        self._max_bucket: Optional[int] = None
        self.requests: Dict[int, _FleetRequest] = {}
        # The fid whose terminal is being processed: an adapter conviction
        # fired from inside its own retirement must not finalize it.
        self._terminal_fid: Optional[int] = None
        self.results: Dict[int, FleetResult] = {}
        self._local2fleet: Dict[Tuple[int, int], int] = {}
        self._terminal: Deque[Tuple[int, ServeResult, Optional[dict]]] = \
            deque()
        #: journal key ("replica:gen") -> block allocator, kept across
        #: restarts so records naming a dead generation's blocks reconcile.
        self.journals: Dict[str, Any] = {}
        # Drill counters (diffed against predict_fleet), JAX's keys.
        self.counters: Dict[str, int] = {
            "crashes": 0, "restarts": 0, "stalls": 0, "poisons": 0,
            "adaptive_poisons": 0, "slowstarts": 0,
            "failover_episodes": 0, "drains": 0,
            "quarantines": 0, "readmissions": 0, "failovers": 0,
            "hedges": 0, "hedge_lost": 0,
            "suspicions": 0, "votes": 0, "outvotes": 0,
            "tenant_floods": 0, "throttles": 0,
            "scale_ups": 0, "scale_downs": 0, "tp_scale_ups": 0,
            "adapter_poisons": 0, "adapter_quarantines": 0,
            "adapter_throttles": 0,
            "preempts": 0, "migrations": 0,
        }
        # (voter replica, engine-local id) -> the vote its replay ballots
        # into.  Replays never enter _local2fleet: they are audits.
        self._vote_ballots: Dict[Tuple[int, int], _Vote] = {}
        # Deferred drain resubmissions: a vote-triggered drain queues
        # moves from terminal processing, so the list outlives one pass.
        self._drain_moves: List[Tuple[int, int, str]] = []
        # -- the control plane (serve/control.py; every piece opt-in) --
        cfgc = self.config
        self._classes = (tuple(cfgc.slo_classes) if cfgc.slo_classes
                         else None)
        self._classq: Optional[ClassQueues] = None
        self._class_latency: Optional[ClassLatencyTracker] = None
        self._class_stats: Dict[str, Dict[str, int]] = {}
        if self._classes:
            self._classq = ClassQueues(
                self._classes, quantum_tokens=cfgc.drr_quantum_tokens,
                per_class_limit=cfgc.class_queue_limit)
            self._class_latency = ClassLatencyTracker(
                self._classes, min_count=cfgc.class_latency_min_count)
            self._class_stats = {
                c.name: {"completed": 0, "tokens": 0, "shed": 0}
                for c in self._classes}
        self._buckets = (TenantBuckets(cfgc.tenant_quota)
                         if cfgc.tenant_quota is not None else None)
        # The same buckets keyed by adapter id: QoS follows the artifact
        # served, not only who asked.
        self._adapter_buckets = (TenantBuckets(cfgc.adapter_quota)
                                 if cfgc.adapter_quota is not None else None)
        self.autoscaler = (Autoscaler(cfgc.autoscale)
                           if cfgc.autoscale is not None else None)
        self._roles_active = cfgc.pool_roles is not None
        #: role -> Autoscaler: each pool keeps its own hysteresis and
        #: cool-downs; the config's bounds apply per pool.
        self._pool_scalers: Dict[str, Autoscaler] = {}
        if self._roles_active and cfgc.autoscale is not None:
            self._pool_scalers = {role: Autoscaler(cfgc.autoscale)
                                  for role in ("prefill", "decode")}
        # Completed requests' ITL sketch: the autoscaler's latency signal.
        self._itl_est = StreamingPercentiles()
        #: (tick, in-service replicas) at every change, bounded.
        self.replica_trace: List[Tuple[int, int]] = []
        # -- adapter trust plane --
        #: tenant -> adapter, mirroring the engines' map so submit() can
        #: refuse a quarantined adapter before picking a replica.
        self._adapter_map: Dict[str, str] = dict(
            engine_kwargs.get("adapter_map") or {})
        #: Fleet-wide per-adapter flag windows (the replica ladder's
        #: window and thresholds, pooled over every replica).
        self._adapter_flags: Dict[str, Deque[int]] = {}
        self.quarantined_adapters: Set[str] = set()
        #: Engine-side slot impounds whose flags the adapter earned
        #: (adapter -> [(replica, gen, slot)]), released at conviction.
        self._adapter_impounds: Dict[str, List[Tuple[int, int, int]]] = {}
        self.replicas: List[_Replica] = []
        for i in range(self.config.num_replicas):
            self.replicas.append(self._build_replica(i))
        self._note_replica_trace()
        self._set_state_gauge()

    @classmethod
    def from_config(cls, params: Any, cfg: Any, serve_config: Any,
                    **kwargs: Any) -> "ServingFleet":
        """A fleet whose replicas all use one validated
        ``core.config.ServeConfig`` (``kwargs``: the fleet's own surfaces
        and extra engine kwargs)."""
        return cls(params, cfg,
                   max_slots=serve_config.max_slots,
                   max_seq=serve_config.max_seq,
                   queue_limit=serve_config.queue_limit,
                   paged=serve_config.paged,
                   block_size=serve_config.block_size,
                   num_blocks=serve_config.num_blocks,
                   prefix_cache=serve_config.prefix_cache,
                   prefill_chunk=serve_config.prefill_chunk,
                   attn_impl=serve_config.attn_impl,
                   kv_dtype=serve_config.kv_dtype,
                   weight_dtype=serve_config.weight_dtype,
                   kv_parity_check=serve_config.kv_parity_check,
                   spec_k=serve_config.spec_k,
                   adapter_rank=serve_config.adapter_rank,
                   adapter_pool_pages=serve_config.adapter_pool_pages,
                   adapter_dtype=serve_config.adapter_dtype,
                   tp_size=serve_config.tp_size, **kwargs)

    # -- replica construction ---------------------------------------------

    def _default_factory(self, index: int, **kwargs: Any) -> Any:
        return ServingEngine(self._params, self._cfg, **kwargs)

    def _tp_devices(self, index: int, tp: int) -> Optional[List[Any]]:
        """Replica ``index``'s TP device slice: contiguous groups of
        ``tp`` local devices when there are enough for disjoint slices,
        else None (the engine puts every position on its own device: on
        one card the groups share it)."""
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if self.device.type == "cuda" else [self.device])
        lo, hi = index * tp, (index + 1) * tp
        if hi <= len(devices):
            return list(devices[lo:hi])
        return None

    def _engine_build_kwargs(self, index: int,
                             tp: Optional[int] = None) -> Dict[str, Any]:
        kwargs = dict(self._engine_kwargs)
        tp = tp or self._base_tp
        if tp > 1:
            kwargs["tp_size"] = tp
            kwargs["tp_devices"] = self._tp_devices(index, tp)
        kwargs.setdefault("seed", draw_seed(self.seed, -1 - index))
        kwargs["replica_id"] = index
        kwargs["chaos"] = self.chaos
        kwargs["retire_hook"] = \
            lambda result, placement, _i=index: \
            self._terminal.append((_i, result, placement))
        view = ReplicaObs(trace=self.trace, registry=self.registry,
                          spans=self.spans,
                          hbm=getattr(self.obs, "hbm", None),
                          compilewatch=getattr(self.obs, "compilewatch",
                                               None))
        if self.config.attach_watchers or self._slo_rules is not None:
            from trustworthy_dl_tpu_torch.obs.anomaly import AnomalyWatcher
            from trustworthy_dl_tpu_torch.obs.slo import SLOWatcher, \
                default_serve_rules

            # Host-only per-replica watchers (no registry: N replicas
            # would write one unlabelled gauge set).
            view.slo = SLOWatcher(self._slo_rules
                                  if self._slo_rules is not None
                                  else default_serve_rules())
            view.anomaly = AnomalyWatcher()
        kwargs["obs"] = view
        return kwargs

    def _build_replica(self, index: int,
                       prev: Optional[_Replica] = None,
                       role: Optional[str] = None,
                       tp: Optional[int] = None) -> _Replica:
        # The TP width is sticky like the role: a rebuild keeps its width;
        # only a scale-up chooses a new one.
        if tp is None:
            tp = prev.tp if prev is not None and prev.tp > 1 \
                else self._base_tp
        engine = self._factory(index,
                               **self._engine_build_kwargs(index, tp))
        rep = prev if prev is not None else _Replica(
            index, engine, self.config.flag_window)
        rep.engine = engine
        rep.tp = tp
        # The pool role belongs to the index (its initial assignment) or to
        # the scale-up that made it; a rebuild keeps it.
        if role is not None:
            rep.role = role
        elif prev is None and self._roles_active \
                and index < len(self.config.pool_roles):
            rep.role = self.config.pool_roles[index]
        rep.reset_trust_window()
        # A rebuilt replica inherits the fleet's standing adapter verdicts.
        for name in self.quarantined_adapters:
            if hasattr(engine, "quarantine_adapter"):
                engine.quarantine_adapter(name)
        self.journals[rep.journal_key] = self._engine_journal(engine)
        # Geometry limits for submit-time validation, captured once, so an
        # impossible request fails in submit() even with every engine down.
        sched = getattr(engine, "scheduler", None)
        if sched is not None and self._max_seq is None:
            self._max_seq = sched.max_seq
            self._max_bucket = max(getattr(sched, "buckets",
                                           (sched.max_seq,)))
        return rep

    @staticmethod
    def _engine_journal(engine: Any) -> Any:
        sched = getattr(engine, "scheduler", None)
        journal = getattr(sched, "blocks", None)
        return journal if journal is not None else getattr(
            sched, "allocator", None)

    # -- submission --------------------------------------------------------

    def submit(self, request: ServeRequest) -> Optional[int]:
        """Enqueue one request; returns its fleet id, or None when every
        admitting replica's queue (or its class queue) shed it
        (backpressure), its tenant's or adapter's bucket throttled it, or
        its adapter is quarantined.  A fleet with no admitting replica
        right now parks the request and resubmits as capacity returns."""
        now = time.perf_counter()
        # Impossible requests fail here, with the engine's semantics: a
        # parked request must never raise inside the tick loop.
        prompt_len = len(list(request.prompt))
        if prompt_len == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self._max_seq is not None:
            total = prompt_len + int(request.max_new_tokens)
            if total > self._max_seq:
                raise ValueError(
                    f"prompt+new = {total} exceeds max_seq="
                    f"{self._max_seq}")
            if prompt_len > self._max_bucket:
                raise ValueError(
                    f"prompt of {prompt_len} tokens exceeds the largest "
                    f"prefill bucket {self._max_bucket}")
        cost = prompt_len + int(request.max_new_tokens)
        tenant = request.tenant
        # The adapter resolves at the fleet boundary (explicit wins, else
        # the tenant map), so a quarantine refuses before any replica.
        adapter = request.adapter
        if adapter is None and tenant is not None:
            adapter = self._adapter_map.get(tenant)
        if adapter is not None and adapter in self.quarantined_adapters:
            logger.warning(
                "fleet: adapter %r is quarantined fleet-wide; "
                "submission for tenant %r refused", adapter, tenant)
            return None
        # The tenant's bucket refuses a flood's overflow, loudly, before
        # any fleet state is touched; untagged traffic bypasses quotas.
        if self._buckets is not None and tenant is not None:
            if not self._buckets.try_spend(tenant, cost, self.tick):
                self.counters["throttles"] += 1
                self._throttle_counter.inc(tenant=tenant)
                level = self._buckets.level(tenant, self.tick)
                logger.warning(
                    "fleet: tenant %r throttled (%d tokens, bucket at "
                    "%.1f)", tenant, cost, level)
                if self.trace is not None:
                    self.trace.emit(EventType.TENANT_THROTTLE,
                                    tenant=tenant, tokens=cost,
                                    bucket_level=round(level, 2),
                                    tick=self.tick)
                return None
        # The adapter's bucket second: its refusal hands the tenant's
        # spend back (a throttled submission does no work).
        if self._adapter_buckets is not None and adapter is not None:
            if not self._adapter_buckets.try_spend(adapter, cost,
                                                   self.tick):
                if self._buckets is not None and tenant is not None:
                    self._buckets.refund(tenant, cost, self.tick)
                self.counters["adapter_throttles"] += 1
                self._adapter_throttle_counter.inc(adapter=adapter)
                level = self._adapter_buckets.level(adapter, self.tick)
                logger.warning(
                    "fleet: adapter %r throttled (%d tokens, bucket at "
                    "%.1f)", adapter, cost, level)
                if self.trace is not None:
                    self.trace.emit(EventType.TENANT_THROTTLE,
                                    tenant=tenant, adapter=adapter,
                                    tokens=cost,
                                    bucket_level=round(level, 2),
                                    tick=self.tick)
                return None
        fid = self._next_fid
        self._next_fid += 1
        seed = (int(request.seed) if request.seed is not None
                else draw_seed(self.seed, fid))
        rec = _FleetRequest(
            fid=fid, prompt=list(request.prompt),
            max_new_tokens=int(request.max_new_tokens),
            temperature=float(request.temperature), eos_id=request.eos_id,
            priority=int(request.priority), seed=seed,
            on_token=request.on_token,
            deadline_at=(now + request.deadline_s
                         if request.deadline_s is not None else None),
            submit_t=now, tenant=tenant, adapter=adapter, cost=cost)
        if self._classes:
            rec.slo_class = class_for_priority(self._classes,
                                               rec.priority).name
        if self.spans is not None:
            rec.span_root = self.spans.start(
                "fleet.request", kind="serve", request_id=fid,
                prompt_len=len(rec.prompt),
                max_new_tokens=rec.max_new_tokens, tenant=tenant,
                slo_class=rec.slo_class)
        self.requests[fid] = rec
        if self._classq is not None:
            # Class-scheduled admission: the request queues at the fleet
            # and the DRR dispatcher places it.
            if not self._classq.push(rec.slo_class, fid, cost):
                del self.requests[fid]
                self.rejected += 1
                self._refund_bucket(rec)
                if self.spans is not None and rec.span_root is not None:
                    self.spans.end(rec.span_root, status="rejected")
                return None
            return fid
        try:
            outcome = self._try_submit(rec)
        except Exception:
            # No orphaned record behind an engine-side raise.
            del self.requests[fid]
            self._refund_bucket(rec)
            if self.spans is not None and rec.span_root is not None:
                self.spans.end(rec.span_root, status="error")
            raise
        if outcome == "full":
            del self.requests[fid]
            self.rejected += 1
            self._refund_bucket(rec)
            if self.spans is not None and rec.span_root is not None:
                self.spans.end(rec.span_root, status="rejected")
            return None
        if outcome == "none_admitting":
            rec.retry_due = self.tick
        return fid

    def _refund_bucket(self, rec: _FleetRequest) -> None:
        """Hand back the bucket spend of a submission the fleet rejected
        after the quota check passed, or of a request that died unserved:
        it did no work."""
        if self._buckets is not None and rec.tenant is not None:
            self._buckets.refund(rec.tenant, rec.cost, self.tick)
        if self._adapter_buckets is not None and rec.adapter is not None:
            self._adapter_buckets.refund(rec.adapter, rec.cost, self.tick)

    def _pick_replicas(self, rec: _FleetRequest,
                       exclude: Set[int] = frozenset()) -> List[_Replica]:
        """Routing order: admitting replicas only, healthy before
        degraded, least loaded first.  ``exclude`` is ignored when it would
        leave no candidate; a replica already running an attempt of this
        request never is one."""
        live_on = set(rec.live)
        avoid = set(exclude) | rec.excluded | live_on
        candidates = [r for r in self.replicas
                      if r.state in ADMITTING and r.engine is not None]
        picked = [r for r in candidates if r.index not in avoid]
        if not picked:
            picked = [r for r in candidates if r.index not in live_on]
        # Disaggregated pools: every (re)submission replays from the
        # prompt, so prefill replicas come first; decode ones stay as the
        # fallback (availability beats specialization).
        roles = self._roles_active
        return sorted(picked,
                      key=lambda r: (roles and r.role == "decode",
                                     r.state is not ReplicaState.HEALTHY,
                                     r.engine.load, r.index))

    def _try_submit(self, rec: _FleetRequest,
                    exclude: Set[int] = frozenset()) -> str:
        """``"submitted"``, ``"full"`` (every admitting replica's queue
        shed it) or ``"none_admitting"``."""
        reps = self._pick_replicas(rec, exclude)
        if not reps:
            return "none_admitting"
        for rep in reps:
            if self._submit_to(rec, rep):
                return "submitted"
        return "full"

    def _submit_to(self, rec: _FleetRequest, rep: _Replica) -> bool:
        now = time.perf_counter()
        deadline_s = None
        if rec.deadline_at is not None:
            deadline_s = max(rec.deadline_at - now, 0.0)
        span = None
        if self.spans is not None:
            span = self.spans.start(
                "fleet.attempt", kind="serve", parent_id=rec.span_root,
                request_id=rec.fid, replica=rep.index,
                attempt=rec.submissions + 1)
        local = rep.engine.submit(ServeRequest(
            prompt=rec.prompt, max_new_tokens=rec.max_new_tokens,
            temperature=rec.temperature, eos_id=rec.eos_id,
            deadline_s=deadline_s, seed=rec.seed,
            on_token=self._token_forwarder(rec, rep.index),
            priority=rec.priority, first_submit_id=rec.fid,
            span_parent=span, tenant=rec.tenant, adapter=rec.adapter))
        if local is None:
            if span is not None:
                self.spans.end(span, outcome="queue_full")
            return False
        rec.submissions += 1
        rec.retry_due = None
        rec.live[rep.index] = _Attempt(replica=rep.index, gen=rep.gen,
                                       local_id=local, submit_t=now,
                                       span=span)
        self._local2fleet[(rep.index, local)] = rec.fid
        return True

    def _token_forwarder(self, rec: _FleetRequest, replica: int
                         ) -> Optional[Callable[[int, int], None]]:
        if rec.on_token is None:
            return None

        def forward(_local_rid: int, token: int) -> None:
            # The earliest-submitted live attempt owns the stream, and
            # nothing streams after the record closed.
            att = rec.live.get(replica)
            if rec.done or att is None or att.loser:
                return
            primary = min(rec.live.values(), key=lambda a: a.submit_t)
            if primary.replica == replica:
                rec.on_token(rec.fid, token)

        return forward

    # -- the fleet tick ----------------------------------------------------

    def step(self) -> int:
        """One tick: chaos -> class dispatch -> step live replicas -> pool
        hand-offs -> retirements -> supervision -> the autoscaler -> due
        retries and hedges.  Returns the tokens emitted across the
        fleet."""
        self.tick += 1
        self._apply_chaos()
        self._dispatch_classes()
        emitted = 0
        for rep in self.replicas:
            if rep.engine is None or rep.state is ReplicaState.QUARANTINED:
                continue
            if self.tick < rep.stalled_until:
                continue  # chaos wedge: no progress; the heartbeat sees it
            emitted += rep.engine.step()
            rep.last_progress_tick = self.tick
        self._rebalance_pools()
        self._process_terminals()
        self._supervise()
        self._autoscale()
        self._run_retries_and_hedges()
        self._set_state_gauge()
        # Done records with every attempt settled leave the working set.
        for fid in [f for f, r in self.requests.items()
                    if r.done and not r.live]:
            del self.requests[fid]
        return emitted

    def run_until_idle(self, max_ticks: int = 100_000
                       ) -> Dict[int, FleetResult]:
        """``step()`` until every request is terminal and every vote has
        resolved (``max_ticks`` is the liveness backstop)."""
        ticks = 0
        while self.busy:
            self.step()
            ticks += 1
            if ticks >= max_ticks:
                raise RuntimeError(
                    f"fleet did not drain in {max_ticks} ticks "
                    f"(states: {[r.state.value for r in self.replicas]})")
        return self.results

    # -- chaos mechanics ---------------------------------------------------

    def _apply_chaos(self) -> None:
        if self.chaos is None or not hasattr(self.chaos, "on_fleet_tick"):
            return
        for event in self.chaos.on_fleet_tick(self.tick):
            if event.kind is FaultKind.TENANT_FLOOD:
                self.counters["tenant_floods"] += 1
                self._run_flood(event)
                continue
            if event.kind is FaultKind.ADAPTER_POISON:
                # The injector keeps the per-adapter compromise; the
                # adapter's flag window does the catching.
                self.counters["adapter_poisons"] += 1
                continue
            target = event.target
            if not 0 <= target < len(self.replicas):
                logger.warning("chaos: fleet event %s targets unknown "
                               "replica %d", event.kind.value, target)
                continue
            rep = self.replicas[target]
            if event.kind is FaultKind.REPLICA_CRASH:
                self._crash_replica(rep)
            elif event.kind is FaultKind.REPLICA_STALL:
                self.counters["stalls"] += 1
                rep.stalled_until = self.tick + max(int(event.severity), 1)
            elif event.kind is FaultKind.REPLICA_POISON:
                # The injector keeps the compromise; the flag-rate ladder
                # does the rest.
                self.counters["poisons"] += 1
            elif event.kind is FaultKind.REPLICA_ADAPTIVE_POISON:
                self.counters["adaptive_poisons"] += 1
            elif event.kind is FaultKind.REPLICA_SLOWSTART:
                # Warm-up only for a replica in service: a quarantined or
                # draining one keeps its ladder state.
                self.counters["slowstarts"] += 1
                warm = self.tick + max(int(event.severity), 1)
                if rep.state in ADMITTING:
                    rep.warm_until = warm
                    self._transition(rep, ReplicaState.RESTARTING,
                                     "slowstart")
                elif rep.state is ReplicaState.RESTARTING:
                    rep.warm_until = max(rep.warm_until, warm)
                else:
                    logger.warning(
                        "chaos: slowstart on replica %d ignored in state "
                        "%s (ladder state preserved)", rep.index,
                        rep.state.value)
            elif event.kind is FaultKind.REPLICA_PREEMPT:
                self._preempt_replica(rep)

    def _crash_replica(self, rep: _Replica) -> None:
        """Kill the engine: every request it held fails over (one
        episode) and the replica restarts after ``restart_ticks``; the
        dead generation's journal stays.  A crash never launders trust: a
        quarantined replica stays quarantined, and a trust drain in
        progress completes as a quarantine."""
        if rep.state is ReplicaState.RETIRED:
            # Scaled in: no engine to crash, and the event must not
            # resurrect retired capacity.
            logger.warning("chaos: crash on retired replica %d ignored",
                           rep.index)
            return
        self.counters["crashes"] += 1
        if rep.state is ReplicaState.QUARANTINED:
            rep.engine = None   # the probe rebuilds; the cool-off stays
            return
        self.counters["failover_episodes"] += 1
        victims = [(key, fid) for key, fid in self._local2fleet.items()
                   if key[0] == rep.index]
        for (replica, local), fid in victims:
            del self._local2fleet[(replica, local)]
            rec = self.requests[fid]
            att = rec.live.pop(replica, None)
            if att is not None:
                self._close_attempt_span(att, "crashed")
                rec.closed.append({
                    "replica": replica, "gen": att.gen,
                    "journal": f"{replica}:{att.gen}", "outcome": "crashed",
                    "layout": None, "slot": -1, "block_ids": [],
                    "prefix_block_ids": [], "prefix_publishers": {},
                })
            self._schedule_failover(rec, from_replica=rep.index,
                                    reason="crash")
        # Ballots the dead engine held abstain...
        for key in [k for k in self._vote_ballots if k[0] == rep.index]:
            vote = self._vote_ballots.pop(key)
            vote.pending.discard(rep.index)
            vote.ballots[rep.index] = None
            if not vote.pending:
                self._resolve_vote(vote)
        # ...and votes targeting it are abandoned (the stream under audit
        # is gone with its generation).
        self._abandon_votes_targeting(rep.index)
        rep.engine = None
        # A crash voids a pending scale-in: the autoscaler decides again
        # against what is left.
        rep.retire_pending = False
        if rep.quarantine_pending:
            # Died mid trust drain: the quarantine it earned still lands.
            rep.quarantine_pending = False
            rep.cooloff_ticks = max(rep.cooloff_ticks * 2,
                                    self.config.quarantine_cooloff_ticks)
            rep.cooloff_until = self.tick + rep.cooloff_ticks
            self._transition(rep, ReplicaState.QUARANTINED, "crash")
        else:
            rep.warm_until = self.tick + self.config.restart_ticks
            self._transition(rep, ReplicaState.RESTARTING, "crash")

    def _preempt_replica(self, rep: _Replica) -> None:
        """Capacity loss with notice: the queue re-queues elsewhere and
        every in-flight request moves as a live block copy; only what
        cannot move replays.  A preemption that moves everything is no
        fail-over episode and no drain; the replica warms back through
        RESTARTING (``predict_fleet``: 1 preempt + 1 restart)."""
        if rep.state is ReplicaState.RETIRED or rep.engine is None:
            logger.warning("chaos: preempt on replica %d ignored "
                           "(no engine)", rep.index)
            return
        self.counters["preempts"] += 1
        if rep.state is ReplicaState.QUARANTINED:
            # Already drained empty: nothing to move, the cool-off stays.
            rep.engine = None
            self._forensic_incident("replica_preempt", rep=rep,
                                    trigger_type="replica_transition")
            return
        self._migrate(rep, rep.engine.queued_ids,
                      status="migrated", reason="preempt")
        for local in list(rep.engine.inflight_ids):
            fid = self._local2fleet.get((rep.index, local))
            if fid is None or not self._live_migrate(rep, fid, "preempt"):
                self._migrate(rep, [local],
                              status="failover", reason="preempt")
        # Settle the cancels now: ballots seated here abstain, and the
        # moved attempts close before the engine goes.
        self._process_terminals()
        self._abandon_votes_targeting(rep.index)
        rep.retire_pending = False
        if rep.quarantine_pending:
            rep.quarantine_pending = False
            rep.cooloff_ticks = max(rep.cooloff_ticks * 2,
                                    self.config.quarantine_cooloff_ticks)
            rep.cooloff_until = self.tick + rep.cooloff_ticks
            rep.engine = None
            self._transition(rep, ReplicaState.QUARANTINED, "preempt")
            self._forensic_incident("replica_preempt", rep=rep,
                                    trigger_type="replica_transition")
            return
        rep.engine = None
        rep.warm_until = self.tick + self.config.restart_ticks
        self._transition(rep, ReplicaState.RESTARTING, "preempt")
        # After the transition, so the incident's counters carry the whole
        # episode and its actions every kv_migration.
        self._forensic_incident("replica_preempt", rep=rep,
                                trigger_type="replica_transition")

    # -- the control plane: floods, class dispatch, autoscaling -----------

    def _run_flood(self, event: Any) -> None:
        """A TENANT_FLOOD: ``severity`` requests from the tenant through
        the normal admission path in one tick.  The tenant's bucket
        throttles what it cannot pay for, the class queues schedule the
        rest, and the admitted burst drives the autoscaler like any
        overload; admitted ones serve to completion like any other."""
        n = max(int(event.severity), 1)
        tenant = event.tenant or "flood"
        cfgc = self.config
        admitted = 0
        for _ in range(n):
            fid = self.submit(ServeRequest(
                prompt=[0] * cfgc.flood_prompt_len,
                max_new_tokens=cfgc.flood_new_tokens,
                temperature=0.0, tenant=tenant, priority=0))
            if fid is not None:
                admitted += 1
        logger.warning("fleet: tenant flood from %r — %d/%d admitted at "
                       "tick %d", tenant, admitted, n, self.tick)

    def _classq_alive(self, fid: int) -> bool:
        rec = self.requests.get(fid)
        return rec is not None and not rec.done and not rec.live \
            and rec.retry_due is None

    def _free_engine_queue_slots(self) -> int:
        free = 0
        for rep in self.replicas:
            if rep.state in ADMITTING and rep.engine is not None:
                free += max(int(rep.engine.queue_limit)
                            - len(rep.engine.queued_ids), 0)
        return free

    def _dispatch_classes(self) -> None:
        """One pass a tick (no-op without SLO classes): while a class's
        latency target is breached and the backlog exceeds the engines'
        free queue room, shed the newest entry of the lowest class (one a
        tick); then release queued requests by token-cost DRR."""
        if self._classq is None:
            return
        free = self._free_engine_queue_slots()
        if (self._class_latency.any_breached()
                and self._classq.depth() > free):
            cand = self._classq.shed_candidate(self._classq_alive)
            if cand is not None:
                name, fid = cand
                rec = self.requests.get(fid)
                if rec is not None and not rec.done:
                    self._class_stats[name]["shed"] += 1
                    self._finalize_unserved(rec, "shed_slo")
        batch = self._classq.take(free, self._classq_alive)
        for i, (name, fid, cost) in enumerate(batch):
            rec = self.requests.get(fid)
            if rec is None or rec.done:
                continue
            try:
                outcome = self._try_submit(rec)
            except BaseException:
                # An engine-side raise mid-batch re-queues the rest (this
                # entry included) before the caller sees it.
                for name2, fid2, cost2 in reversed(batch[i:]):
                    self._classq.push_front(name2, fid2, cost2)
                raise
            if outcome != "submitted":
                # Engine backpressure: every entry not yet placed goes
                # back in order, or it would be orphaned.
                for name2, fid2, cost2 in reversed(batch[i:]):
                    self._classq.push_front(name2, fid2, cost2)
                break

    def _rebalance_pools(self) -> None:
        """The disaggregated pools' hand-off (no-op without
        ``pool_roles``): a request that has emitted its first decode token
        on a prefill replica moves to a decode replica as a live block
        copy.  A refusal leaves it decoding where it is; the sweep tries
        again next tick."""
        if not self._roles_active:
            return
        moved = 0
        for rep in self.replicas:
            if (rep.role != "prefill" or rep.engine is None
                    or rep.state not in ADMITTING):
                continue
            for local in list(getattr(rep.engine, "decode_ready_ids",
                                      ())):
                fid = self._local2fleet.get((rep.index, local))
                if fid is None:
                    continue  # a vote replay: audits never move
                if self._live_migrate(rep, fid, "disagg"):
                    moved += 1
        if moved and self.trace is not None:
            self.trace.emit(
                EventType.POOL_REBALANCE, role="prefill", moved=moved,
                replicas=sum(1 for r in self.replicas
                             if r.role == "decode"
                             and r.engine is not None))

    def _in_service(self) -> List[_Replica]:
        """Replicas that exist as capacity (all but RETIRED): the count
        the autoscaler's bounds govern."""
        return [r for r in self.replicas
                if r.state is not ReplicaState.RETIRED]

    def _note_replica_trace(self) -> None:
        n = len(self._in_service())
        if len(self.replica_trace) < 4096 and (
                not self.replica_trace
                or self.replica_trace[-1][1] != n):
            self.replica_trace.append((self.tick, n))

    def _autoscale(self) -> None:
        """One decision a tick (no-op without an autoscaler); with pools,
        each pool decides on its own signals."""
        if self.autoscaler is None:
            return
        if self._pool_scalers:
            for role in ("prefill", "decode"):
                sig = self._scale_signals(role)
                decision = self._pool_scalers[role].observe(sig)
                if decision > 0:
                    self._scale_up(sig, role=role)
                elif decision < 0:
                    self._scale_down(sig, role=role)
            return
        sig = self._scale_signals(None)
        decision = self.autoscaler.observe(sig)
        if decision > 0:
            self._scale_up(sig)
        elif decision < 0:
            self._scale_down(sig)

    def _scale_signals(self, role: Optional[str]) -> ScaleSignals:
        """One tick's autoscaler inputs, fleet-wide (``role`` None) or of
        one pool.  A replica draining toward RETIRED is leaving and a
        QUARANTINED one serves nothing: neither counts (otherwise repeated
        scale-downs could walk below ``min_replicas``, and quarantines
        would dilute the queue per replica); RESTARTING is warming
        capacity and counts."""
        staying = [r for r in self._in_service()
                   if r.state is not ReplicaState.QUARANTINED
                   and not (r.state is ReplicaState.DRAINING
                            and r.retire_pending)
                   and (role is None or r.role == role)]
        engines = [r.engine for r in staying if r.engine is not None]
        queue = sum(e.load for e in engines)
        if self._classq is not None and role in (None, "prefill"):
            # Class-queued work dispatches to the prefill pool first.
            queue += self._classq.depth()
        occ = 0.0
        pools = [getattr(e, "scheduler", None) for e in engines]
        pools = [p for p in pools if p is not None]
        if pools:
            occ = sum(p.occupancy for p in pools) / len(pools)
        burning = any(
            getattr(e, "slo", None) is not None and e.slo.breached
            for e in engines)
        itl = (self._itl_est.quantile(0.99)
               if self._itl_est.count else None)
        cfg = self.autoscaler.cfg
        # A pool reads the predictive arm only where the config declares
        # its share of the demand.
        pred = None
        if cfg.predictive is not None:
            if role is None:
                pred = predicted_replicas(cfg.predictive, self.tick)
            elif role in dict(cfg.predictive.role_share or ()):
                pred = predicted_replicas(cfg.predictive, self.tick,
                                          role=role)
        return ScaleSignals(
            tick=self.tick, in_service=len(staying),
            queue_per_replica=queue / max(len(staying), 1),
            occupancy=occ, itl_p99=itl, slo_burning=burning,
            predicted_replicas=pred,
            down_candidates=any(r.state in ADMITTING
                                and r.engine is not None
                                and (role is None or r.role == role)
                                for r in self.replicas))

    def _emit_scale(self, direction: str, frm: int, to: int,
                    reason: str) -> None:
        self.counters[f"scale_{direction}s"] += 1
        self._scale_counter.inc(direction=direction)
        self._note_replica_trace()
        if self.trace is not None:
            self.trace.emit(EventType.FLEET_SCALE, direction=direction,
                            from_replicas=frm, to_replicas=to,
                            reason=reason, tick=self.tick)

    def _scale_up(self, sig: ScaleSignals,
                  role: Optional[str] = None) -> None:
        """Add capacity: revive a RETIRED index as a new generation (its
        journals kept) or append a replica.  The engine is built mid-run
        through the engine's HBM headroom gate and warms through
        RESTARTING.  ``role`` pins it to one pool; with none retired there,
        a replica retired from the other pool changes pools.  With TP
        headroom (``tp_max`` above the width) ``control.choose_scale_action``
        picks the shape: ``"up"`` builds the new replica with a doubled TP
        group (occupancy pressure, quiet queue: per-replica pool bytes are
        the bottleneck), ``"out"`` one of the current width.  Replicas in
        service are never rebuilt in place; the fleet widens through
        churn."""
        frm = len(self._in_service())
        cfgc = self.config
        cur_tp = max((r.tp for r in self._in_service()
                      if r.engine is not None), default=self._base_tp)
        tp_max = cfgc.tp_max or max(cfgc.tp_size, self._base_tp)
        action = choose_scale_action(self.autoscaler.cfg, sig, cur_tp,
                                     tp_max)
        tp_new = min(cur_tp * 2, tp_max) if action == "up" else None
        rep = next((r for r in self.replicas
                    if r.state is ReplicaState.RETIRED
                    and (role is None or r.role == role)), None)
        if rep is None and role is not None:
            rep = next((r for r in self.replicas
                        if r.state is ReplicaState.RETIRED), None)
        if rep is not None:
            rep.gen += 1
            self._build_replica(rep.index, prev=rep, role=role, tp=tp_new)
        else:
            rep = self._build_replica(len(self.replicas), role=role,
                                      tp=tp_new)
            self.replicas.append(rep)
        rep.warm_until = self.tick + cfgc.restart_ticks
        rep.last_progress_tick = self.tick
        self._transition(rep, ReplicaState.RESTARTING, "scale_up")
        if action == "up":
            self.counters["tp_scale_ups"] += 1
        logger.warning("fleet: scale-%s -> replica %d tp=%d (queue/replica "
                       "%.1f, occupancy %.2f)", action, rep.index, rep.tp,
                       sig.queue_per_replica, sig.occupancy)
        self._emit_scale("up", frm, len(self._in_service()), "scale_up")

    def _scale_down(self, sig: ScaleSignals,
                    role: Optional[str] = None) -> None:
        """Shed capacity without shedding work: drain the least-loaded
        admitting replica (ties: the newest index), move its queue now and
        its in-flight requests as live copies; what cannot move runs out
        where it is (never force-migrated at the grace deadline, never
        killed).  The drain completes into RETIRED."""
        cands = [r for r in self.replicas
                 if r.state in ADMITTING and r.engine is not None
                 and (role is None or r.role == role)]
        if not cands:
            return
        frm = len(self._in_service())
        rep = min(cands, key=lambda r: (r.engine.load, -r.index))
        rep.retire_pending = True
        rep.quarantine_pending = False
        self._transition(rep, ReplicaState.DRAINING, "scale_down")
        self._migrate(rep, rep.engine.queued_ids,
                      status="migrated", reason="scale_down")
        for local in list(rep.engine.inflight_ids):
            fid = self._local2fleet.get((rep.index, local))
            if fid is not None:
                self._live_migrate(rep, fid, "scale_down")
        logger.warning("fleet: scale-down draining replica %d "
                       "(queue/replica %.1f, occupancy %.2f)",
                       rep.index, sig.queue_per_replica, sig.occupancy)
        self._emit_scale("down", frm, frm - 1, "scale_down")

    # -- terminal processing -----------------------------------------------

    def _process_terminals(self) -> None:
        while self._terminal:
            replica, result, placement = self._terminal.popleft()
            self._on_terminal(replica, result, placement)

    def _attempt_record(self, att: _Attempt, placement: Optional[dict],
                        outcome: str) -> Dict[str, Any]:
        placement = placement or {"layout": None, "slot": -1,
                                  "block_ids": [], "prefix_block_ids": [],
                                  "prefix_publishers": {}}
        return {"replica": att.replica, "gen": att.gen,
                "journal": f"{att.replica}:{att.gen}",
                "local_id": att.local_id, "outcome": outcome,
                **placement}

    def _on_terminal(self, replica: int, result: ServeResult,
                     placement: Optional[dict]) -> None:
        vote = self._vote_ballots.pop((replica, result.request_id), None)
        if vote is not None:
            # A vote replay: record the ballot (abstain unless completed).
            # Replays never feed the voter's flag window.
            self._on_vote_ballot(vote, replica, result)
            return
        fid = self._local2fleet.pop((replica, result.request_id), None)
        if fid is None:
            return  # already accounted (the crash path ran first)
        rec = self.requests.get(fid)
        if rec is None:
            return
        att = rec.live.pop(replica, None)
        if att is None:
            return
        status = result.status
        if (status in ("completed", "deadline_exceeded")
                and placement is not None):
            # The monitor scored this retirement (a queue-side expiry has
            # no placement and never ran: feeding it would dilute the
            # flag rate).
            adapter = result.adapter
            if adapter is not None:
                # The flag indicts the adapter, not the replica hosting it.
                if result.flagged:
                    self._note_adapter_impound(adapter, replica, placement)
                self._terminal_fid = fid
                try:
                    self._observe_adapter_retirement(adapter,
                                                     result.flagged)
                finally:
                    self._terminal_fid = None
                self.observe_retirement(replica, False)
            else:
                self.observe_retirement(replica, result.flagged)
        if att.loser or (rec.done and status != "hedge_lost"):
            # A loser we cancelled, or both attempts completed in one tick
            # and this one lost.
            status = "hedge_lost"
        self._close_attempt_span(att, status)
        rec.closed.append(self._attempt_record(att, placement, status))
        if status == "hedge_lost":
            self.counters["hedge_lost"] += 1
            self._ledger_loser(rec, att)
            return
        if status == "completed":
            self._finalize(rec, result, att)
            return
        if status == "deadline_exceeded":
            self._cancel_siblings(rec, status="hedge_lost")
            self._finalize(rec, result, att)
            return
        if status in ("migrated", "failover"):
            return  # moved by us: the drain or crash path resubmits
        if status in ("no_capacity", "shed_slo"):
            self._schedule_failover(rec, from_replica=replica,
                                    reason=status)
            return
        logger.warning("fleet: request %d terminal status %r taken as "
                       "final", fid, status)
        self._finalize(rec, result, att)

    def _cancel_siblings(self, rec: _FleetRequest, status: str) -> None:
        for replica, att in list(rec.live.items()):
            rep = self.replicas[replica]
            att.loser = True
            if rep.engine is not None:
                rep.engine.cancel(att.local_id, status=status)

    def _schedule_failover(self, rec: _FleetRequest, from_replica: int,
                           reason: str) -> None:
        if rec.done or rec.live or rec.retry_due is not None:
            return
        now = time.perf_counter()
        if rec.deadline_at is not None and now > rec.deadline_at:
            self._finalize_unserved(rec, "deadline_exceeded")
            return
        if rec.submissions > self.config.max_retries:
            self._finalize_unserved(rec, "failover_exhausted")
            return
        rec.excluded.add(from_replica)
        rec.retry_due = self.tick + backoff_ticks(self.config,
                                                  max(rec.submissions, 1))
        self.counters["failovers"] += 1
        self._failover_counter.inc()
        if self.trace is not None:
            self.trace.emit(EventType.FLEET_FAILOVER, request_id=rec.fid,
                            from_replica=from_replica, to_replica=None,
                            attempt=rec.submissions + 1, reason=reason,
                            due_tick=rec.retry_due)

    # -- finalization ------------------------------------------------------

    def _finalize(self, rec: _FleetRequest, result: ServeResult,
                  att: _Attempt) -> None:
        if rec.done:
            return
        rec.done = True
        rec.retry_due = None
        self._cancel_siblings(rec, status="hedge_lost")
        ttft = None
        if result.ttft_s is not None:
            ttft = (att.submit_t - rec.submit_t) + result.ttft_s
        self.results[rec.fid] = FleetResult(
            request_id=rec.fid, tokens=list(result.tokens),
            status=result.status, replica=att.replica,
            attempts=rec.submissions, ttft_s=ttft,
            flagged=result.flagged, monitor_z=result.monitor_z,
            tenant=rec.tenant, slo_class=rec.slo_class, adapter=rec.adapter)
        if result.status == "completed":
            for dt in result.itl_s:
                self._itl_est.observe(dt)
            if rec.slo_class is not None:
                stats = self._class_stats[rec.slo_class]
                stats["completed"] += 1
                stats["tokens"] += len(result.tokens)
                self._class_latency.observe(rec.slo_class, ttft_s=ttft,
                                            itl_s=result.itl_s)
        self._ledger_canonical(rec, result, att, ttft)
        if self.spans is not None and rec.span_root is not None:
            self.spans.end(rec.span_root, status=result.status,
                           replica=att.replica, attempts=rec.submissions,
                           tokens=len(result.tokens))
        self._maybe_vote(rec, result, att)

    def _finalize_unserved(self, rec: _FleetRequest, status: str) -> None:
        """Terminal with no serving attempt left (deadline between
        attempts, retries exhausted, a convicted adapter): never silent, a
        result, a ledger record and a closed span like every other."""
        if rec.done:
            return
        rec.done = True
        rec.retry_due = None
        # The bucket spend landed once at submit and rode every move
        # un-recharged; a request that dies unserved gets it back, once
        # (``rec.done`` guards a second refund).
        self._refund_bucket(rec)
        self._cancel_siblings(rec, status="hedge_lost")
        self.results[rec.fid] = FleetResult(
            request_id=rec.fid, tokens=[], status=status, replica=None,
            attempts=rec.submissions, ttft_s=None, tenant=rec.tenant,
            slo_class=rec.slo_class, adapter=rec.adapter)
        if self.ledger is not None:
            self.ledger.append({
                "request_id": rec.fid, "status": status,
                "admitted": bool(rec.closed),
                "replica": None, "attempts": list(rec.closed),
                "flagged": False, "monitor_z": 0.0, "tokens": 0,
                "token_hash": attribution.token_hash([]),
                "ttft_s": None, "submissions": rec.submissions,
                "tenant": rec.tenant, "slo_class": rec.slo_class,
            })
        if self.trace is not None:
            self.trace.emit(EventType.SERVE_RETIRE, request_id=rec.fid,
                            status=status, tokens=0, fleet=True)
        if self.spans is not None and rec.span_root is not None:
            self.spans.end(rec.span_root, status=status,
                           attempts=rec.submissions)

    def _ledger_canonical(self, rec: _FleetRequest, result: ServeResult,
                          att: _Attempt, ttft: Optional[float]) -> None:
        if self.ledger is None:
            return
        winner = rec.closed[-1] if rec.closed else {}
        engine = self.replicas[att.replica].engine
        self.ledger.append({
            "request_id": rec.fid, "status": result.status,
            "admitted": True, "replica": att.replica,
            "journal": f"{att.replica}:{att.gen}",
            "layout": winner.get("layout"), "slot": winner.get("slot", -1),
            "block_ids": list(winner.get("block_ids") or []),
            "prefix_block_ids": list(winner.get("prefix_block_ids") or []),
            "prefix_publishers": dict(winner.get("prefix_publishers") or {}),
            "attempts": list(rec.closed),
            "kv_dtype": getattr(engine, "kv_dtype", None),
            "weight_dtype": getattr(engine, "weight_dtype", None),
            "kv_fallback_reason": getattr(engine, "kv_fallback_reason",
                                          None),
            "flagged": bool(result.flagged),
            "monitor_z": float(result.monitor_z),
            "tokens": len(result.tokens),
            "token_hash": attribution.token_hash(result.tokens),
            "ttft_s": ttft, "submissions": rec.submissions,
            "tenant": rec.tenant, "slo_class": rec.slo_class,
            "adapter": rec.adapter,
            "adapter_page": winner.get("adapter_page", 0),
        })

    def _ledger_loser(self, rec: _FleetRequest, att: _Attempt) -> None:
        if self.ledger is None:
            return
        self.ledger.append({
            "request_id": rec.fid, "status": "hedge_lost",
            "admitted": False, "replica": att.replica,
            "journal": f"{att.replica}:{att.gen}",
            "tokens": 0, "token_hash": attribution.token_hash([]),
        })

    def _close_attempt_span(self, att: _Attempt, outcome: str) -> None:
        if self.spans is not None and att.span is not None:
            self.spans.end(att.span, outcome=outcome)

    # -- supervision -------------------------------------------------------

    def _forensic_incident(self, reason: str, *,
                           rep: Optional[_Replica] = None,
                           adapter: Optional[str] = None,
                           trigger_type: Optional[str] = None,
                           refusals: Optional[List[Dict[str, Any]]] = None,
                           extra: Optional[Dict[str, Any]] = None) -> None:
        """One incident for a fleet episode (no-op without an assembler),
        its counters snapshot taken after every counter the episode
        bumped."""
        if self.forensics is None:
            return
        records = list(self.ledger.records()) \
            if self.ledger is not None else []
        # Records land at retirement: requests still in flight contribute
        # a provisional record from their closed attempts, so a mid-episode
        # blast radius sees them.
        for fid, rec in self.requests.items():
            if not rec.done and rec.closed:
                records.append({"request_id": fid, "admitted": True,
                                "status": "in_flight",
                                "attempts": list(rec.closed),
                                "provisional": True})
        self.forensics.assemble(
            reason, tick=self.tick,
            suspects=[rep.index] if rep is not None else None,
            suspect_journals=[rep.journal_key] if rep is not None else (),
            adapter=adapter, trigger_type=trigger_type,
            counters=dict(self.counters), records=records,
            refusals=refusals, extra=extra)

    def _transition(self, rep: _Replica, to: ReplicaState,
                    reason: str) -> None:
        if rep.state is to:
            return
        frm = rep.state
        rep.state = to
        rep.reason = reason
        self._transition_counter.inc(to_state=to.value)
        if to is ReplicaState.DRAINING:
            self.counters["drains"] += 1
            rep.drain_deadline = self.tick + self.config.drain_grace_ticks
        elif to is ReplicaState.QUARANTINED:
            self.counters["quarantines"] += 1
        logger.warning("fleet: replica %d %s -> %s (%s)", rep.index,
                       frm.value, to.value, reason)
        if self.trace is not None:
            self.trace.emit(EventType.REPLICA_TRANSITION,
                            replica=rep.index, from_state=frm.value,
                            to_state=to.value, reason=reason,
                            tick=self.tick)
        if to is ReplicaState.QUARANTINED:
            if self.verdicts is not None:
                self.verdicts.append("quarantine", "quarantined",
                                     replica=rep.index, reason=reason,
                                     tick=self.tick)
            self._forensic_incident("replica_quarantine", rep=rep,
                                    trigger_type="replica_transition",
                                    extra={"transition_reason": reason})

    def _migrate(self, rep: _Replica, ids: List[int], status: str,
                 reason: str) -> None:
        """Cancel local requests on ``rep`` and schedule their
        resubmission (the cancel's hook queues the terminal; its status
        routes it back through ``_schedule_failover``)."""
        for local in ids:
            fid = self._local2fleet.get((rep.index, local))
            rep.engine.cancel(local, status=status)
            if fid is None:
                continue
            rec = self.requests.get(fid)
            if rec is not None and not rec.done:
                self._drain_moves.append((fid, rep.index, reason))

    def _live_migrate(self, rep: _Replica, fid: int, reason: str) -> bool:
        """Move fleet request ``fid`` off ``rep`` as a live block copy:
        the fleet re-points its attempt in the commit hook before the
        source attempt closes, and the source's blocks release (impound,
        when the source is bound for quarantine) only after that.  False,
        source untouched, when no destination can take the copy."""
        if not self.config.live_migration:
            return False
        rec = self.requests.get(fid)
        if rec is None or rec.done:
            return False
        att = rec.live.get(rep.index)
        if att is None:
            return False
        cands = [r for r in self.replicas
                 if r.index != rep.index and r.state in ADMITTING
                 and r.engine is not None and r.index not in rec.live]
        if self._roles_active:
            decode = [r for r in cands if r.role == "decode"]
            if decode:
                cands = decode
        cands.sort(key=lambda r: (r.state is not ReplicaState.HEALTHY,
                                  r.engine.load, r.index))
        refusals: List[Dict[str, Any]] = []
        for dst in cands:
            if not can_migrate(rep.engine, dst.engine):
                refusals.append({"replica": dst.index,
                                 "reason": "structural_gate"})
                continue

            def commit(new_local: int, _dst: _Replica = dst) -> None:
                # The destination attempt keeps the source's submit time:
                # TTFT reads the stream as one request.
                rec.live[_dst.index] = _Attempt(
                    replica=_dst.index, gen=_dst.gen,
                    local_id=new_local, submit_t=att.submit_t)
                self._local2fleet[(_dst.index, new_local)] = rec.fid

            moved = migrate_request(
                rep.engine, dst.engine, att.local_id,
                quarantine_src=rep.quarantine_pending,
                on_token=self._token_forwarder(rec, dst.index),
                src_journal=f"{rep.index}:{att.gen}",
                on_commit=commit,
                on_refuse=lambda why, _d=dst: refusals.append(
                    {"replica": _d.index, "reason": why}))
            if moved is None:
                continue
            self.counters["migrations"] += 1
            self._migration_counter.inc(reason=reason)
            if self.trace is not None:
                self.trace.emit(EventType.KV_MIGRATION, request_id=fid,
                                from_replica=rep.index,
                                to_replica=dst.index,
                                blocks=moved["blocks"], reason=reason)
            # Settle the source cancel now, or the two attempts' equal
            # submit times would suppress the destination's next token.
            self._process_terminals()
            return True
        self._last_migration_refusals = refusals
        if refusals:
            self._forensic_incident(
                "migration_refused", rep=rep, refusals=refusals,
                trigger_type="replica_transition",
                extra={"request_id": fid, "migrate_reason": reason})
        return False

    def _start_trust_drain(self, rep: _Replica, reason: str) -> None:
        """The trust-driven drain (flag-rate trip, slot exhaustion, an
        outvote): transition, arm the quarantine, move the queue, and move
        in-flight work now as live copies with the source blocks
        impounded; what cannot move runs out in the grace window."""
        self._transition(rep, ReplicaState.DRAINING, reason)
        rep.quarantine_pending = True
        self._migrate(rep, rep.engine.queued_ids,
                      status="migrated", reason="drain")
        for local in list(rep.engine.inflight_ids):
            fid = self._local2fleet.get((rep.index, local))
            if fid is not None:
                self._live_migrate(rep, fid, "drain")

    def _supervise(self) -> None:
        cfg = self.config
        # _drain_moves is not reset here: a vote-triggered drain queues
        # moves from terminal processing before this pass.
        for rep in self.replicas:
            if rep.state is ReplicaState.RETIRED:
                continue  # scaled in: no engine, no signals, no ladder
            if rep.state is ReplicaState.RESTARTING:
                if self.tick >= rep.warm_until:
                    if rep.engine is None:
                        rep.gen += 1
                        self._build_replica(rep.index, prev=rep)
                        self.counters["restarts"] += 1
                    # A fresh heartbeat epoch.
                    rep.last_progress_tick = self.tick
                    self._transition(rep, ReplicaState.HEALTHY,
                                     "warmup_complete")
                continue
            if rep.state is ReplicaState.QUARANTINED:
                if self.tick >= rep.cooloff_until:
                    # Cool-off over: the readmission probe.
                    self.counters["readmissions"] += 1
                    if self.verdicts is not None:
                        self.verdicts.append(
                            "quarantine", "readmitted", replica=rep.index,
                            reason="readmission_probe", tick=self.tick)
                    self._abandon_votes_targeting(rep.index)
                    rep.reset_trust_window()
                    rep.warm_until = self.tick + cfg.restart_ticks
                    self._transition(rep, ReplicaState.RESTARTING,
                                     "readmission_probe")
                continue
            if rep.engine is None:
                continue
            missed = self.tick - rep.last_progress_tick
            trip = rep.ladder_tripped(cfg)
            watcher_bad = (
                (rep.engine.slo is not None and rep.engine.slo.breached)
                or (rep.engine.anomaly is not None
                    and rep.engine.anomaly.any_active))
            if watcher_bad and rep.state in ADMITTING:
                # Watcher episodes feed the suspicion tier too.
                self.note_suspicion(rep.index, "watcher")
            if rep.state in ADMITTING:
                if trip:
                    self._start_trust_drain(rep, "monitor_flag_rate")
                elif (getattr(rep.engine, "in_service_capacity", None)
                        == 0 and rep.engine.load):
                    # Every slot impounded by monitor quarantines: the
                    # replica cannot serve its queue.
                    self._start_trust_drain(rep,
                                            "slot_quarantine_exhausted")
                elif missed >= cfg.heartbeat_miss_limit:
                    self._transition(rep, ReplicaState.DRAINING,
                                     "heartbeat")
                    rep.quarantine_pending = False
                    self.counters["failover_episodes"] += 1
                    # No progress, nothing to wait for: the queue and the
                    # in-flight move now (a wedged pool is still readable).
                    self._migrate(rep, rep.engine.queued_ids,
                                  status="migrated", reason="drain")
                    for local in list(rep.engine.inflight_ids):
                        fid = self._local2fleet.get((rep.index, local))
                        if fid is None or not self._live_migrate(
                                rep, fid, "heartbeat"):
                            self._migrate(rep, [local],
                                          status="failover",
                                          reason="heartbeat")
                elif rep.state is ReplicaState.HEALTHY and (
                        rep.flag_count >= 1
                        or missed >= cfg.heartbeat_miss_degraded
                        or watcher_bad):
                    self._transition(rep, ReplicaState.DEGRADED,
                                     "early_warning")
                elif rep.state is ReplicaState.DEGRADED and (
                        rep.flag_count == 0
                        and missed < cfg.heartbeat_miss_degraded
                        and not watcher_bad):
                    self._transition(rep, ReplicaState.HEALTHY,
                                     "recovered")
            if rep.state is ReplicaState.DRAINING:
                # A scale-down drain lets in-flight work run out where it
                # is, past the grace deadline, while the engine ticks; one
                # that stops making progress falls back to the move after
                # heartbeat_miss_limit silent ticks, or the work would be
                # stranded.
                stalled_retire = (
                    rep.retire_pending and rep.engine.load
                    and self.tick - rep.last_progress_tick
                    >= cfg.heartbeat_miss_limit)
                if stalled_retire or (
                        not rep.retire_pending and rep.engine.load
                        and self.tick >= rep.drain_deadline):
                    why = ("scale_down_stall" if stalled_retire
                           else "drain_grace")
                    self._migrate(rep, rep.engine.queued_ids,
                                  status="migrated", reason="drain")
                    for local in list(rep.engine.inflight_ids):
                        fid = self._local2fleet.get((rep.index, local))
                        if fid is None or not self._live_migrate(
                                rep, fid, why):
                            self._migrate(rep, [local], status="failover",
                                          reason=why)
                if rep.engine.load == 0:
                    if rep.retire_pending:
                        # Scale-in complete: release the pool, keep the
                        # journal, leave the index for a revival.
                        rep.retire_pending = False
                        rep.engine = None
                        self._transition(rep, ReplicaState.RETIRED,
                                         "scale_down_complete")
                        self._note_replica_trace()
                    elif rep.quarantine_pending:
                        rep.quarantine_pending = False
                        rep.cooloff_ticks = max(
                            rep.cooloff_ticks * 2,
                            cfg.quarantine_cooloff_ticks)
                        rep.cooloff_until = self.tick + rep.cooloff_ticks
                        self._transition(rep, ReplicaState.QUARANTINED,
                                         rep.reason)
                    else:
                        rep.warm_until = max(rep.stalled_until,
                                             self.tick + cfg.restart_ticks)
                        self._transition(rep, ReplicaState.RESTARTING,
                                         "drain_complete")
        # The cancels queued terminal records: drain them, then arm the
        # scheduled moves (the terminal handler leaves migrated and
        # failover statuses to this path).
        self._process_terminals()
        for fid, from_replica, reason in self._drain_moves:
            rec = self.requests.get(fid)
            if rec is not None and not rec.done:
                self._schedule_failover(rec, from_replica, reason)
        self._drain_moves = []

    def observe_retirement(self, replica: int, flagged: bool) -> None:
        """One slot-side retirement's monitor verdict into the replica's
        flag window and its EWMA suspicion score; the post-observation
        flag rate goes to the chaos feedback hook."""
        if not 0 <= replica < len(self.replicas):
            return
        rep = self.replicas[replica]
        rep.flags.append(1 if flagged else 0)
        if flagged:
            rep.total_flags += 1
        a = self.config.suspicion_ewma_alpha
        rep.suspicion = (1.0 - a) * rep.suspicion + a * (
            1.0 if flagged else 0.0)
        self._suspicion_gauge.set(rep.suspicion, replica=str(rep.index))
        self._update_suspicion_episode(rep, reason="flag_rate")
        if self.chaos is not None and hasattr(self.chaos,
                                              "on_flag_observed"):
            self.chaos.on_flag_observed(replica, flagged, rep.flag_rate)

    # -- adapter trust plane ----------------------------------------------

    def _observe_adapter_retirement(self, adapter: str,
                                    flagged: bool) -> None:
        """One adapter-attributed verdict into the adapter's fleet-wide
        window (the replica ladder's window and trip); a trip quarantines
        the adapter everywhere."""
        cfg = self.config
        win = self._adapter_flags.get(adapter)
        if win is None:
            win = self._adapter_flags[adapter] = deque(
                maxlen=cfg.flag_window)
        win.append(1 if flagged else 0)
        if adapter in self.quarantined_adapters:
            return  # late stragglers add no verdict
        count = sum(win)
        rate = count / len(win)
        if count >= cfg.flag_min_count and rate >= cfg.flag_rate_quarantine:
            self._quarantine_adapter(adapter, "monitor_flag_rate", rate)

    def _note_adapter_impound(self, adapter: str, replica: int,
                              placement: Optional[dict]) -> None:
        """Remember an engine-side slot impound the adapter earned; it is
        released when the fleet convicts the adapter (at once when the
        adapter already is)."""
        slot = (placement or {}).get("slot", -1)
        if slot is None or slot < 0:
            return
        rep = self.replicas[replica]
        if adapter in self.quarantined_adapters:
            self._release_impound(rep, rep.gen, int(slot))
        else:
            self._adapter_impounds.setdefault(adapter, []).append(
                (replica, rep.gen, int(slot)))

    def _release_impound(self, rep: _Replica, gen: int, slot: int) -> None:
        if (rep.engine is not None and rep.gen == gen
                and slot in rep.engine.quarantined_slots):
            rep.engine.release_quarantine(slot)

    def _quarantine_adapter(self, adapter: str, reason: str,
                            flag_rate: float = 0.0) -> None:
        """Fleet-wide adapter quarantine: refuse new submissions naming
        it, impound its page on every replica, release the slots its
        flags impounded, fail its open requests loudly; the replicas stay
        in service."""
        if adapter in self.quarantined_adapters:
            return
        self.quarantined_adapters.add(adapter)
        self.counters["adapter_quarantines"] += 1
        for rep in self.replicas:
            if rep.engine is not None and hasattr(rep.engine,
                                                  "quarantine_adapter"):
                rep.engine.quarantine_adapter(adapter)
        for replica, gen, slot in self._adapter_impounds.pop(adapter, []):
            self._release_impound(self.replicas[replica], gen, slot)
        for rec in list(self.requests.values()):
            if (rec.adapter == adapter and not rec.done
                    and rec.fid != self._terminal_fid):
                self._finalize_unserved(rec, "adapter_quarantined")
        logger.warning("fleet: adapter %r QUARANTINED fleet-wide "
                       "(%s, flag rate %.3f)", adapter, reason, flag_rate)
        if self.trace is not None:
            self.trace.emit(EventType.ADAPTER_QUARANTINE, adapter=adapter,
                            reason=reason, flag_rate=round(flag_rate, 4),
                            tick=self.tick)
        if self.verdicts is not None:
            self.verdicts.append("adapter_quarantine", "quarantined",
                                 adapter=adapter, reason=reason,
                                 tick=self.tick)
        self._forensic_incident("adapter_quarantine", adapter=adapter,
                                trigger_type="adapter_quarantine",
                                extra={"flag_rate": round(flag_rate, 4)})

    def release_adapter_quarantine(self, adapter: str) -> None:
        """Operator action: readmit a quarantined adapter (its evidence
        window starts over) on every live replica."""
        self.quarantined_adapters.discard(adapter)
        self._adapter_flags.pop(adapter, None)
        for rep in self.replicas:
            if rep.engine is not None and hasattr(rep.engine,
                                                  "unquarantine_adapter"):
                rep.engine.unquarantine_adapter(adapter)

    def adapter_flag_rate(self, adapter: str) -> float:
        win = self._adapter_flags.get(adapter)
        return sum(win) / len(win) if win else 0.0

    # -- the suspicion tier ------------------------------------------------

    def note_suspicion(self, replica: int, reason: str,
                       weight: float = 1.0) -> None:
        """Raise a replica's suspicion from a signal other than a flag (a
        watcher episode, an attribution irregularity, a dissenting
        ballot): folded into the same EWMA, and the replica is eligible
        for suspicion without ``suspicion_min_flags`` flags."""
        if not 0 <= replica < len(self.replicas):
            return
        rep = self.replicas[replica]
        a = self.config.suspicion_ewma_alpha
        rep.suspicion = min(1.0,
                            (1.0 - a) * rep.suspicion + a * float(weight))
        rep.suspicion_noted = True
        self._suspicion_gauge.set(rep.suspicion, replica=str(rep.index))
        self._update_suspicion_episode(rep, reason=reason)

    def _update_suspicion_episode(self, rep: _Replica,
                                  reason: str) -> None:
        cfg = self.config
        suspected = (rep.suspicion >= cfg.suspicion_threshold
                     and (rep.total_flags >= cfg.suspicion_min_flags
                          or rep.suspicion_noted))
        if suspected and not rep.suspicion_episode:
            rep.suspicion_episode = True
            self.counters["suspicions"] += 1
            self._suspicion_counter.inc()
            logger.warning("fleet: replica %d SUSPECTED (score %.3f, "
                           "flag rate %.3f, %s)", rep.index,
                           rep.suspicion, rep.flag_rate, reason)
            if self.trace is not None:
                self.trace.emit(EventType.FLEET_SUSPICION,
                                replica=rep.index,
                                score=round(rep.suspicion, 4),
                                reason=reason,
                                flag_rate=round(rep.flag_rate, 4),
                                tick=self.tick)
            if self.verdicts is not None:
                self.verdicts.append("suspicion", "opened",
                                     replica=rep.index, reason=reason,
                                     tick=self.tick)
        elif (rep.suspicion_episode
              and rep.suspicion < cfg.suspicion_threshold / 2.0
              and rep.outvotes == 0):
            # Hysteresis: the episode closes only well below the
            # threshold, and an outvote on record pins it open.
            rep.suspicion_episode = False
            if self.verdicts is not None:
                self.verdicts.append("suspicion", "closed",
                                     replica=rep.index, reason=reason,
                                     tick=self.tick)

    # -- cross-replica verdict votes ---------------------------------------

    def _maybe_vote(self, rec: _FleetRequest, result: ServeResult,
                    att: _Attempt) -> None:
        """Launch a vote for a request completed on a suspected, still
        admitting replica: replay it on up to ``vote_k`` other admitting
        replicas with the request's seed.  One vote in flight per
        suspect."""
        cfg = self.config
        if cfg.vote_k < 1 or result.status != "completed":
            return
        rep = self.replicas[att.replica]
        if (not rep.suspicion_episode or rep.vote_open
                or rep.state not in ADMITTING or rep.engine is None):
            return
        if rep.ladder_tripped(cfg):
            return  # the flag-rate ladder owns it this tick
        voters = sorted(
            (r for r in self.replicas
             if r.index != rep.index and r.state in ADMITTING
             and r.engine is not None),
            key=lambda r: (r.engine.load, r.index))[:cfg.vote_k]
        if not voters:
            return
        accepted: List[Tuple[_Replica, int]] = []
        for voter in voters:
            local = voter.engine.submit(ServeRequest(
                prompt=rec.prompt, max_new_tokens=rec.max_new_tokens,
                temperature=rec.temperature, eos_id=rec.eos_id,
                seed=rec.seed, priority=rec.priority, tenant=rec.tenant,
                # An audit: no user stream, no deadline, no prefix
                # publication.
                publish_prefix=False))
            if local is not None:
                accepted.append((voter, local))
        if len(accepted) < min(cfg.vote_k, 2):
            # Quorum or nothing: retry at the suspect's next retirement.
            for voter, local in accepted:
                voter.engine.cancel(local, status="vote_abandoned")
            return
        vote = _Vote(fid=rec.fid, target=rep.index,
                     original_hash=attribution.token_hash(result.tokens))
        for voter, local in accepted:
            vote.pending.add(voter.index)
            self._vote_ballots[(voter.index, local)] = vote
        rep.vote_open = True
        self.counters["votes"] += 1

    def _abandon_votes_targeting(self, index: int) -> None:
        """Drop every vote whose target generation is going away (crash,
        preemption, readmission probe): cancel its replays, no outcome, no
        counters."""
        stale = [(key, vote) for key, vote in self._vote_ballots.items()
                 if vote.target == index]
        for (voter, local), _vote in stale:
            self._vote_ballots.pop((voter, local), None)
            rep = self.replicas[voter]
            if rep.engine is not None:
                rep.engine.cancel(local, status="vote_abandoned")

    def _on_vote_ballot(self, vote: _Vote, replica: int,
                        result: ServeResult) -> None:
        vote.pending.discard(replica)
        completed = result.status == "completed"
        replay_hash = attribution.token_hash(result.tokens)
        vote.ballots[replica] = replay_hash if completed else None
        if self.ledger is not None:
            # Evidence, not service: admitted False keeps one admitted
            # record per fleet id.
            self.ledger.append({
                "request_id": vote.fid, "status": "vote_replay",
                "admitted": False, "replica": replica,
                "vote_target": vote.target,
                "tokens": len(result.tokens),
                "token_hash": replay_hash,
            })
        if not vote.pending:
            self._resolve_vote(vote)

    def _resolve_vote(self, vote: _Vote) -> None:
        """Majority vote by token_hash.  Outvoted: a dissenting hash
        shared by >= 2 replays that also outnumbers the agreeing ballots,
        so no lone faulty voter convicts a clean original and split
        dissent convicts nobody."""
        cfg = self.config
        rep = self.replicas[vote.target]
        rep.vote_open = False
        counted = {r: h for r, h in vote.ballots.items() if h is not None}
        agree = [r for r, h in counted.items()
                 if h == vote.original_hash]
        dissent_by_hash: Dict[str, List[int]] = {}
        for r, h in counted.items():
            if h != vote.original_hash:
                dissent_by_hash.setdefault(h, []).append(r)
        top_dissent: List[int] = max(dissent_by_hash.values(),
                                     key=len, default=[])
        if len(counted) < 2:
            outcome = "inconclusive"
        elif len(top_dissent) >= 2 and len(top_dissent) > len(agree):
            outcome = "outvoted"
            self.counters["outvotes"] += 1
            rep.outvotes += 1
            self.note_suspicion(vote.target, "outvoted")
            if (rep.outvotes >= cfg.vote_outvote_limit
                    and rep.state in ADMITTING and rep.engine is not None):
                self._start_trust_drain(rep, "verdict_outvoted")
        else:
            outcome = "confirmed"
            for voters in dissent_by_hash.values():
                for voter in voters:
                    # A minority dissenter is now the suspect.
                    self.note_suspicion(voter, "vote_dissent")
        self._vote_counter.inc(outcome=outcome)
        logger.warning("fleet: verdict vote on request %d (replica %d): "
                       "%s (agree %d, dissent %d)", vote.fid, vote.target,
                       outcome, len(agree), len(top_dissent))
        if self.trace is not None:
            self.trace.emit(EventType.VERDICT_VOTE, request_id=vote.fid,
                            replica=vote.target, outcome=outcome,
                            agree=len(agree), dissent=len(top_dissent),
                            outvotes=rep.outvotes, tick=self.tick)
        if self.verdicts is not None:
            self.verdicts.append("vote", outcome, replica=vote.target,
                                 request_id=vote.fid, tick=self.tick)

    # -- retries and hedges ------------------------------------------------

    def _run_retries_and_hedges(self) -> None:
        now = time.perf_counter()
        for rec in list(self.requests.values()):
            if rec.done:
                continue
            if (rec.deadline_at is not None and now > rec.deadline_at
                    and not rec.live):
                self._finalize_unserved(rec, "deadline_exceeded")
                continue
            if rec.retry_due is not None and self.tick >= rec.retry_due:
                # The FLEET_FAILOVER event was emitted when the failover
                # was scheduled; on failure the request stays parked.
                self._try_submit(rec, exclude=rec.excluded)
                continue
            if (self.config.hedge_deadline_s is not None
                    and rec.deadline_at is not None and not rec.hedged
                    and len(rec.live) == 1
                    and len(self.replicas) > 1
                    and rec.deadline_at - now
                    < self.config.hedge_deadline_s):
                primary = next(iter(rec.live.values()))
                if self._try_submit(rec,
                                    exclude={primary.replica}
                                    | rec.excluded) == "submitted":
                    rec.hedged = True
                    self.counters["hedges"] += 1
                    self._hedge_counter.inc()
                    if self.trace is not None:
                        att = max(rec.live.values(),
                                  key=lambda a: a.submit_t)
                        self.trace.emit(EventType.FLEET_HEDGE,
                                        request_id=rec.fid,
                                        replica=att.replica,
                                        primary=primary.replica)
        # Cancels issued while finalizing (hedge losers) settle in the
        # same tick.
        self._process_terminals()

    # -- reporting ---------------------------------------------------------

    def _set_state_gauge(self) -> None:
        by_state = {s: 0 for s in ReplicaState}
        tif = 0
        load = 0
        for rep in self.replicas:
            by_state[rep.state] += 1
            self._suspicion_gauge.set(rep.suspicion,
                                      replica=str(rep.index))
            if rep.engine is not None:
                load += rep.engine.load
                sched = getattr(rep.engine, "scheduler", None)
                if sched is not None:
                    tif += sched.tokens_in_flight
        for state, n in by_state.items():
            self._replicas_gauge.set(float(n), state=state.value)
        if self._roles_active:
            for role in ("prefill", "decode"):
                n = sum(1 for r in self.replicas if r.role == role
                        and r.state is not ReplicaState.RETIRED)
                self._pool_gauge.set(float(n), role=role)
        self._tif_gauge.set(float(tif))
        self._queue_gauge.set(float(load))
        self._chips_gauge.set(float(self.chips_in_service()))
        if self._classq is not None:
            for name, depth in self._classq.depth_by_class().items():
                self._classq_gauge.set(float(depth), slo_class=name)

    def chips_in_service(self) -> int:
        """Devices the fleet occupies: the replicas x model-shards grid,
        each replica in service counting its TP group's width (TP
        positions, which share the card on one card)."""
        return sum(r.tp for r in self._in_service())

    @property
    def open_requests(self) -> int:
        """Accepted-but-unfinished fleet requests (class-queued, live or
        between retries): the closed-loop driver's in-flight count."""
        return sum(1 for r in self.requests.values() if not r.done)

    @property
    def busy(self) -> bool:
        # Outstanding ballots keep the loop live: a vote's verdict must
        # land even after the last user request retired.
        return (any(not r.done for r in self.requests.values())
                or bool(self._vote_ballots))

    def drain_results(self) -> Dict[int, FleetResult]:
        """Finished results, cleared (bounded memory for long loops)."""
        out = self.results
        self.results = {}
        return out

    def states(self) -> Dict[int, str]:
        return {r.index: r.state.value for r in self.replicas}

    def verify_attribution(self) -> Tuple[bool, List[str]]:
        """Reconcile the fleet ledger against every replica generation's
        block journal."""
        if self.ledger is None:
            raise ValueError("fleet has no attribution ledger attached")
        return attribution.verify_attribution(self.ledger.records(),
                                              self.journals)

    def metrics_summary(self) -> Dict[str, Any]:
        """Terminal statuses, drill counters, replica states,
        canonical-stream goodput."""
        statuses: Dict[str, int] = {}
        tokens = 0
        for res in self.results.values():
            statuses[res.status] = statuses.get(res.status, 0) + 1
            if res.status == "completed":
                tokens += len(res.tokens)
        out = {
            "requests": len(self.requests),
            "statuses": statuses,
            "completed_tokens": tokens,
            "replica_states": self.states(),
            "replica_suspicion": {r.index: round(r.suspicion, 4)
                                  for r in self.replicas},
            "ticks": self.tick,
            **{f"fleet_{k}": v for k, v in self.counters.items()},
        }
        slo_active = {
            rep.index: rep.engine.slo.active
            for rep in self.replicas
            if rep.engine is not None
            and getattr(rep.engine, "slo", None) is not None
        }
        if slo_active:
            out["replica_slo_active"] = slo_active
        if self._classes:
            out["per_class"] = {
                c.name: {**self._class_stats[c.name],
                         **self._class_latency.summary(c.name)}
                for c in self._classes}
            out["class_queue_depth"] = self._classq.depth_by_class()
        if self.autoscaler is not None:
            out["replicas_in_service"] = len(self._in_service())
            out["replica_trace"] = list(self.replica_trace)
        if self._adapter_flags or self.quarantined_adapters:
            out["adapter_flag_rates"] = {
                name: round(self.adapter_flag_rate(name), 4)
                for name in sorted(self._adapter_flags)}
            out["quarantined_adapters"] = sorted(self.quarantined_adapters)
        return out


__all__ = ["ADMITTING", "FleetConfig", "FleetResult", "ReplicaObs",
           "ReplicaState", "ServingFleet", "TERMINAL_STATUSES",
           "backoff_ticks"]
