"""Structured trace bus: typed JSONL events with monotonic timestamps
and step/request correlation ids.

Counterpart of ``trustworthy_dl_tpu/obs/events.py``: the same names,
schemas and behaviour, in the port's own copy.  The catalogue is the JAX
package's whole table (fleet, migration, control and performance types
included), so a trace validates the same in both packages.

Every event is one flat JSON object::

    {"seq": 17, "t": 1722700000.123, "t_mono": 8.201,
     "type": "train_step", "step": 12, "loss": 2.31, ...}

``seq`` is a per-bus monotone counter (total order even when wall clocks
collide), ``t`` wall-clock epoch seconds (cross-process alignment),
``t_mono`` ``time.monotonic()`` (intra-process durations immune to NTP
steps).  Training-side events correlate on ``step`` (the trainer's
global step), serving-side events on ``request_id`` — a reader joins
``train_step`` ↔ ``detection_verdict`` ↔ ``ckpt_save`` rows on the step
id, and ``serve_submit`` ↔ ``serve_retire`` on the request id.

Event types and their required fields are declared in
:data:`EVENT_SCHEMAS`; ``TraceBus.emit`` validates against it so a
malformed emission fails at the producer (loudly, in tests) instead of
corrupting the post-mortem record a recovery depends on.  Extra fields
are always allowed — schemas are a floor, not a ceiling.
"""

from __future__ import annotations

import enum
import json
import os
import re
import threading
import time
from typing import Any, Dict, IO, List, Optional, Tuple


class EventType(str, enum.Enum):
    """Everything the framework can say about itself.  README
    §Observability carries the same catalog as a table."""

    # Run lifecycle
    RUN_START = "run_start"
    RUN_END = "run_end"
    METRICS_SNAPSHOT = "metrics_snapshot"
    # Training
    TRAIN_STEP = "train_step"
    TRUST_TRANSITION = "trust_transition"
    DETECTION_VERDICT = "detection_verdict"
    FLEET_ALERT = "fleet_alert"
    ELASTIC_EVICT = "elastic_evict"
    ELASTIC_READMIT = "elastic_readmit"
    # Checkpointing
    CKPT_SAVE = "ckpt_save"
    CKPT_COMMIT = "ckpt_commit"
    CKPT_RESTORE = "ckpt_restore"
    # Supervisor recovery ladder
    GUARD_TRIP = "guard_trip"
    SUPERVISOR_RETRY = "supervisor_retry"
    SUPERVISOR_ROLLBACK = "supervisor_rollback"
    SUPERVISOR_RESTART = "supervisor_restart"
    PREEMPTION = "preemption"
    FLIGHT_DUMP = "flight_dump"
    # Chaos
    CHAOS_FAULT = "chaos_fault"
    # Serving request lifecycle
    SERVE_SUBMIT = "serve_submit"
    SERVE_ADMIT = "serve_admit"
    SERVE_RETIRE = "serve_retire"
    SERVE_QUARANTINE = "serve_quarantine"
    # Active observability plane (obs/spans.py, slo.py, anomaly.py,
    # attribution.py)
    SPAN = "span"
    SLO_BREACH = "slo_breach"
    ANOMALY = "anomaly"
    ATTRIBUTION = "attribution"
    # Serving fleet (serve/fleet.py): replica lifecycle + request
    # fail-over.  ``request_id`` on fleet events is the FLEET id; the
    # ENGINE lifecycle events (serve_submit/admit/retire/...) keep
    # replica-LOCAL ids but carry a ``replica`` field whenever the
    # engine runs inside a fleet, so a shared trace stays joinable.
    REPLICA_TRANSITION = "replica_transition"
    FLEET_FAILOVER = "fleet_failover"
    FLEET_HEDGE = "fleet_hedge"
    # Adversarial serving tier: the suspicion episode below the
    # quarantine threshold (sustained sub-threshold flag rate, anomaly
    # episode, or attribution irregularity) and each cross-replica
    # verdict vote's resolution.
    FLEET_SUSPICION = "fleet_suspicion"
    VERDICT_VOTE = "verdict_vote"
    # Fleet control plane (serve/control.py wired into serve/fleet.py):
    # each autoscaler action (replica count change, either direction)
    # and each per-tenant token-bucket throttle (a submission the
    # flooding tenant's own bucket refused).
    FLEET_SCALE = "fleet_scale"
    TENANT_THROTTLE = "tenant_throttle"
    # Adapter tier (serve/adapters.py): every residency change of the
    # paged adapter pool (a tenant's adapter uploaded into a pool page,
    # evicting a cold tenant when the pool is full) and every fleet-wide
    # adapter quarantine (the per-ADAPTER flag-rate window tripping —
    # the trust verdict that blames the model delta, not the replica).
    ADAPTER_SWAP = "adapter_swap"
    ADAPTER_QUARANTINE = "adapter_quarantine"
    # Live migration tier (serve/migrate.py wired into serve/fleet.py):
    # every live KV block-table hand-off of an in-flight request between
    # replicas (drain, heartbeat, scale-in, preemption, disaggregation)
    # and every pool-role rebalance sweep that moved decode-ready work
    # off a prefill-specialist replica.
    KV_MIGRATION = "kv_migration"
    POOL_REBALANCE = "pool_rebalance"
    # Performance tier (obs/compilewatch.py, hbm.py, sentinel.py):
    # every compilation, compile-once contract violations, live-HBM
    # sweeps/pressure denials, and perf-ledger regressions.
    COMPILE = "compile"
    COMPILE_STORM = "compile_storm"
    HBM_SWEEP = "hbm_sweep"
    HBM_PRESSURE = "hbm_pressure"
    PERF_REGRESSION = "perf_regression"
    # Trace-bus housekeeping: the first event of a fresh segment after a
    # size-based rotation names the segment the bus just sealed.
    TRACE_ROTATE = "trace_rotate"
    # Forensics tier (obs/forensics.py, obs/verdicts.py): an ``incident``
    # announces the assembled post-mortem artifact for a flight-dump-
    # grade episode; a ``verdict`` announces each durable trust-history
    # row appended to the VerdictStore.
    INCIDENT = "incident"
    VERDICT = "verdict"


#: type -> {"requires": base correlation keys, "fields": required extras}.
EVENT_SCHEMAS: Dict[EventType, Dict[str, tuple]] = {
    EventType.RUN_START: {"requires": (), "fields": ()},
    EventType.RUN_END: {"requires": (), "fields": ()},
    EventType.METRICS_SNAPSHOT: {"requires": (), "fields": ("path",)},
    EventType.TRAIN_STEP: {"requires": ("step",),
                           "fields": ("loss", "grad_norm")},
    EventType.TRUST_TRANSITION: {
        "requires": ("step",),
        "fields": ("node", "from_status", "to_status"),
    },
    EventType.DETECTION_VERDICT: {
        "requires": ("step",), "fields": ("node", "attack_type"),
    },
    EventType.FLEET_ALERT: {"requires": ("step",), "fields": ()},
    EventType.ELASTIC_EVICT: {"requires": ("step",), "fields": ("nodes",)},
    EventType.ELASTIC_READMIT: {"requires": ("step",),
                                "fields": ("nodes",)},
    EventType.CKPT_SAVE: {"requires": ("step",), "fields": ("path",)},
    EventType.CKPT_COMMIT: {"requires": ("step",),
                            "fields": ("committed",)},
    EventType.CKPT_RESTORE: {"requires": ("step",), "fields": ()},
    EventType.GUARD_TRIP: {
        "requires": ("step",),
        "fields": ("loss", "grad_norm", "finite_nodes"),
    },
    EventType.SUPERVISOR_RETRY: {"requires": ("step",),
                                 "fields": ("attempt",)},
    EventType.SUPERVISOR_ROLLBACK: {
        "requires": ("step",), "fields": ("restored_step",),
    },
    EventType.SUPERVISOR_RESTART: {"requires": ("step",),
                                   "fields": ("restart",)},
    EventType.PREEMPTION: {"requires": ("step",), "fields": ()},
    EventType.FLIGHT_DUMP: {"requires": (), "fields": ("path", "reason")},
    EventType.CHAOS_FAULT: {"requires": ("step",), "fields": ("kind",)},
    EventType.SERVE_SUBMIT: {"requires": ("request_id",),
                             "fields": ("prompt_len", "max_new_tokens")},
    EventType.SERVE_ADMIT: {"requires": ("request_id",),
                            "fields": ("slot",)},
    EventType.SERVE_RETIRE: {"requires": ("request_id",),
                             "fields": ("status", "tokens")},
    EventType.SERVE_QUARANTINE: {"requires": ("request_id",),
                                 "fields": ("slot",)},
    # Spans correlate on whichever key their workload carries (a train
    # span has a step, a serve span a request id) — neither is required.
    EventType.SPAN: {"requires": (),
                     "fields": ("name", "kind", "span_id", "duration_s")},
    EventType.SLO_BREACH: {"requires": (),
                           "fields": ("slo", "signal", "burn_rate")},
    EventType.ANOMALY: {"requires": (), "fields": ("signal", "zscore")},
    EventType.ATTRIBUTION: {"requires": ("request_id",),
                            "fields": ("slot", "n_blocks", "token_hash")},
    # Fleet lifecycle is replica-keyed, not request-keyed: a transition
    # (healthy → degraded → draining → quarantined → restarting) names
    # the replica, the states, and the signal that drove it.
    EventType.REPLICA_TRANSITION: {
        "requires": (),
        "fields": ("replica", "from_state", "to_state", "reason"),
    },
    EventType.FLEET_FAILOVER: {
        "requires": ("request_id",),
        "fields": ("from_replica", "to_replica", "attempt"),
    },
    EventType.FLEET_HEDGE: {"requires": ("request_id",),
                            "fields": ("replica",)},
    # Suspicion is replica-keyed (an episode, not a request); a verdict
    # vote correlates on the FLEET request id it replayed and names the
    # suspected replica, the outcome (confirmed/outvoted/inconclusive)
    # and the ballot split.
    EventType.FLEET_SUSPICION: {
        "requires": (),
        "fields": ("replica", "score", "reason"),
    },
    EventType.VERDICT_VOTE: {
        "requires": ("request_id",),
        "fields": ("replica", "outcome", "agree", "dissent"),
    },
    # Control plane: a scale event names the direction, both replica
    # counts and the signal that drove it; a throttle names the tenant,
    # the token cost the bucket refused and the bucket's level.
    EventType.FLEET_SCALE: {
        "requires": (),
        "fields": ("direction", "from_replicas", "to_replicas",
                   "reason"),
    },
    EventType.TENANT_THROTTLE: {
        "requires": (),
        "fields": ("tenant", "tokens", "bucket_level"),
    },
    # Adapter pool residency: a swap names the adapter that moved in,
    # the pool page it landed on, and the evicted adapter (None for a
    # cold-start fill of a free page).  A quarantine names the adapter
    # and the flag-rate evidence that tripped the per-adapter window.
    EventType.ADAPTER_SWAP: {
        "requires": (),
        "fields": ("adapter", "page", "evicted"),
    },
    EventType.ADAPTER_QUARANTINE: {
        "requires": (),
        "fields": ("adapter", "reason"),
    },
    # Live migration: a kv_migration correlates on the FLEET request id
    # and names both replicas, the number of physical blocks copied and
    # the reason ("trust_drain"/"heartbeat"/"scale_down"/"preempt"/
    # "disagg"); a pool_rebalance is role-keyed (a sweep, not a request)
    # and counts what the sweep moved off the prefill pool.
    EventType.KV_MIGRATION: {
        "requires": ("request_id",),
        "fields": ("from_replica", "to_replica", "blocks", "reason"),
    },
    EventType.POOL_REBALANCE: {
        "requires": (),
        "fields": ("role", "replicas", "moved"),
    },
    # Performance tier.  ``compile`` rows are per-compilation (key =
    # the compile stage, seconds = backend compile wall time);
    # ``compile_storm`` marks a post-warmup recompile inside a guarded
    # hot loop (scope = which loop).  HBM rows carry byte counts; a
    # ``perf_regression`` names the fingerprint metric that left the
    # ledger's noise band.
    EventType.COMPILE: {"requires": (), "fields": ("key", "seconds")},
    EventType.COMPILE_STORM: {"requires": (),
                              "fields": ("scope", "compiles")},
    EventType.HBM_SWEEP: {"requires": (),
                          "fields": ("live_bytes", "watermark_bytes")},
    EventType.HBM_PRESSURE: {
        "requires": (),
        "fields": ("requested_bytes", "headroom_bytes"),
    },
    EventType.PERF_REGRESSION: {
        "requires": (), "fields": ("metric", "value", "baseline"),
    },
    EventType.TRACE_ROTATE: {"requires": (),
                             "fields": ("path", "segment")},
    # Forensics: an incident names the artifact it wrote (path is None
    # in the in-memory bench mode) and the registered reason that
    # triggered assembly; a verdict names the (kind, outcome) pair the
    # VerdictStore recorded — same label the tddl_verdicts_total
    # counter pages on.
    EventType.INCIDENT: {"requires": (),
                         "fields": ("incident_id", "reason", "path")},
    EventType.VERDICT: {"requires": (), "fields": ("kind", "outcome")},
}


#: Floor for ``TraceBus.max_bytes``: a rotation cap must comfortably
#: hold the trace_rotate announcement line plus real events, or the
#: fresh segment would immediately re-trip the cap.
MIN_ROTATE_BYTES = 4096


def validate_event(event: Dict[str, Any]) -> None:
    """Raise ValueError when ``event`` violates its type's schema."""
    try:
        etype = EventType(event.get("type"))
    except ValueError:
        raise ValueError(f"unknown event type {event.get('type')!r}")
    schema = EVENT_SCHEMAS[etype]
    for key in schema["requires"]:
        if event.get(key) is None:
            raise ValueError(
                f"{etype.value} event requires correlation id {key!r}"
            )
    missing = [f for f in schema["fields"] if f not in event]
    if missing:
        raise ValueError(
            f"{etype.value} event missing required field(s) {missing}"
        )


class TraceBus:
    """Emits validated events to (any of) a JSONL file, a flight
    recorder, and the metrics registry's event counter.

    With no sinks configured the bus still validates and counts —
    instrumented code never branches on whether tracing is on; it only
    guards on ``bus is not None`` for the cost of building the dict.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 recorder: Any = None, registry: Any = None,
                 validate: bool = True, max_bytes: int = 0):
        # ``max_bytes`` > 0 enables size-based rotation: when the live
        # file crosses the cap it is sealed as ``trace.<n>.jsonl`` (n
        # monotonically increasing) and a fresh ``trace.jsonl`` opens
        # whose FIRST event is a typed ``trace_rotate`` row naming the
        # sealed segment — long serve/fleet runs stay disk-bounded per
        # segment and the reader side (:func:`read_jsonl_rotated`, the
        # obs CLI, the offline Chrome export) walks segments in order.
        self.jsonl_path = str(jsonl_path) if jsonl_path else None
        self.max_bytes = int(max_bytes)
        if 0 < self.max_bytes < MIN_ROTATE_BYTES:
            # A cap smaller than a handful of event lines would make the
            # rotation ANNOUNCEMENT itself trip the cap — emit → rotate
            # → emit recursion producing thousands of one-line segments.
            self.max_bytes = MIN_ROTATE_BYTES
        self.rotations = 0
        self.recorder = recorder
        self.validate = validate
        self._file: Optional[IO[str]] = None
        self._closed = False
        self._lock = threading.Lock()
        self._seq = 0
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "tddl_obs_events_total", "Trace events emitted, by type",
                labels=("type",),
            )

    def emit(self, type: Any, *, step: Optional[int] = None,
             request_id: Optional[int] = None, **data: Any
             ) -> Dict[str, Any]:
        etype = type.value if isinstance(type, EventType) else str(type)
        event: Dict[str, Any] = {
            "seq": 0,  # patched under the lock below
            "t": time.time(),
            "t_mono": time.monotonic(),
            "type": etype,
        }
        if step is not None:
            event["step"] = int(step)
        if request_id is not None:
            event["request_id"] = int(request_id)
        event.update(data)
        if self.validate:
            validate_event(event)
        rotated: Optional[tuple] = None
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            # After close() the file never reopens: a straggler event
            # (e.g. an async checkpoint COMMIT joining during cleanup)
            # still reaches the recorder/counter but must not land in
            # the file after its final run_end line — nor leak a handle.
            if self.jsonl_path is not None and not self._closed:
                if self._file is None:
                    self._file = open(self.jsonl_path, "a", buffering=1)
                self._file.write(json.dumps(event) + "\n")
                if self.max_bytes > 0 \
                        and self._file.tell() >= self.max_bytes:
                    rotated = self._rotate_locked()
        if self.recorder is not None:
            self.recorder.record(event)
        if self._counter is not None:
            self._counter.inc(type=etype)
        if rotated is not None:
            # Outside the lock: the rotation announcement is a normal
            # typed event and lands as the FIRST line of the fresh
            # segment (the fresh file cannot itself trip the cap here).
            path, segment, size = rotated
            self.emit(EventType.TRACE_ROTATE, path=path, segment=segment,
                      bytes=size)
        return event

    def _rotate_locked(self) -> "tuple[str, int, int]":
        """Seal the live file as the next ``<stem>.<n>.jsonl`` segment
        (caller holds the lock).  Returns (sealed path, segment, bytes)."""
        size = self._file.tell()
        self._file.close()
        self._file = None
        existing = [n for _, n in rotated_segments(self.jsonl_path)]
        segment = (max(existing) + 1) if existing else 1
        sealed = _segment_path(self.jsonl_path, segment)
        os.replace(self.jsonl_path, sealed)
        self.rotations += 1
        return sealed, segment, size

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None


def read_jsonl(path: str) -> list:
    """Load a trace file back into event dicts (reader-side helper)."""
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(json.loads(line))
    return events


def _segment_path(path: str, segment: int) -> str:
    stem, ext = os.path.splitext(path)
    return f"{stem}.{segment}{ext}"


def rotated_segments(path: str) -> "List[Tuple[str, int]]":
    """(path, segment) of the sealed rotation segments belonging to
    ``path`` (``trace.jsonl`` → ``trace.1.jsonl``, ``trace.2.jsonl``,
    ...), ordered oldest first."""
    stem, ext = os.path.splitext(os.path.basename(path))
    directory = os.path.dirname(path) or "."
    pattern = re.compile(
        rf"^{re.escape(stem)}\.(\d+){re.escape(ext)}$"
    )
    out: List[Tuple[str, int]] = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            m = pattern.match(name)
            if m:
                out.append((os.path.join(directory, name), int(m.group(1))))
    out.sort(key=lambda item: item[1])
    return out


def read_jsonl_rotated(path: str) -> list:
    """Load a trace INCLUDING its sealed rotation segments, oldest
    events first — the reader every offline consumer (obs CLI, Chrome
    export) should use; a never-rotated trace reads identically to
    :func:`read_jsonl`."""
    events: list = []
    for segment_path, _ in rotated_segments(path):
        events.extend(read_jsonl(segment_path))
    if os.path.exists(path):
        events.extend(read_jsonl(path))
    return events
