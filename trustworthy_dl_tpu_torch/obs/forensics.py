"""Incident forensics: one structured post-mortem per flight-dump-grade
episode — causal timeline, blast radius, reconciled counters.

Counterpart of ``trustworthy_dl_tpu/obs/forensics.py``: the same incident
schema, file names, metric, events and renderers.  The obs plane records
every signal (typed trace events, per-request attribution records,
allocator journals, flight dumps, the perf ledger); the
:class:`IncidentAssembler` joins them AT the episode and writes
``incident_NNN_<reason>.json`` next to the flight dump:

* **causal chain** — trigger event → contributing signals → actions
  taken, each entry carrying its trace ``seq`` id so the timeline is
  replayable against the raw segments (``read_jsonl_rotated``);
* **blast radius** — every request that decoded off the suspect's KV
  blocks (via each attempt's ``journal`` key and the attribution
  ledger's per-block publisher records) or a quarantined tenant's
  adapter page, including cross-replica reach via ``migrated_from``
  provenance;
* **counters** — the counter snapshot the caller passes at assembly.

The port's episodes are the supervisor's (``guard_trip``, ``rollback``,
``preemption``), the watchers' (``slo_breach``, ``anomaly``,
``compile_storm``), the operator's (``drill``, ``manual``) and the serving
fleet's (``serve/fleet.py``: ``replica_quarantine``, ``replica_preempt``,
``adapter_quarantine``, ``migration_refused``), whose incidents carry the
suspect replicas and journals, per-attempt journal keys and
``migrated_from`` provenance in the blast radius, and the suspicion, vote
and quarantine rows of the verdict store.

Incident ``reason`` strings come from :data:`ARTIFACT_REASONS`, the port's
copy of the JAX package's registered vocabulary (a typo'd reason would
silently orphan an incident from its trigger).

Host-only: nothing here imports torch, so incidents are assembled and
rendered (``python -m trustworthy_dl_tpu_torch.cli obs incident``) on
machines whose card may be the thing that broke.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

from trustworthy_dl_tpu_torch.obs.events import read_jsonl_rotated

INCIDENT_SCHEMA_VERSION = 1

#: The flight-dump / incident reason vocabulary (the JAX package's
#: ``analysis/contracts.py`` ``ARTIFACT_REASONS``).  Incidents pair with
#: their flight dump and their trigger events BY reason string, so every
#: literal reason passed to ``dump_flight`` / ``recorder.dump`` /
#: ``assemble`` comes from this set.
ARTIFACT_REASONS = frozenset({
    # training supervisor ladder (engine/supervisor.py)
    "guard_trip", "rollback", "preemption",
    # watcher-driven dumps (obs/slo.py, anomaly.py, compilewatch.py)
    "slo_breach", "anomaly", "compile_storm",
    # fleet forensic episodes (serve/fleet.py)
    "replica_quarantine", "replica_preempt", "adapter_quarantine",
    "migration_refused",
    # operator-initiated artifacts (examples, tests, CLI)
    "drill", "manual",
})

#: Event types that count as CONTRIBUTING SIGNALS in a causal chain —
#: evidence that accumulated before the trigger.
SIGNAL_EVENTS = frozenset({
    "fleet_suspicion", "verdict_vote", "anomaly", "slo_breach",
    "compile_storm", "chaos_fault", "guard_trip", "hbm_pressure",
    "detection_verdict", "fleet_alert",
})

#: Event types that count as ACTIONS TAKEN — what the control plane did
#: about it.
ACTION_EVENTS = frozenset({
    "replica_transition", "kv_migration", "fleet_failover",
    "adapter_quarantine", "serve_quarantine", "fleet_scale",
    "supervisor_retry", "supervisor_rollback", "supervisor_restart",
    "ckpt_restore", "elastic_evict", "elastic_readmit", "flight_dump",
})

_INCIDENT_RE = re.compile(r"incident_(\d+)_(.+)\.json$")


def _placement_touches(att: Dict[str, Any]) -> bool:
    """True when an attempt/placement actually held physical state —
    an unplaced attempt (layout None, no blocks, slot -1) never touched
    the pool and must not inflate a blast radius."""
    if att.get("block_ids"):
        return True
    return att.get("layout") == "stripe" and att.get("slot", -1) >= 0


def blast_radius(records: Iterable[Dict[str, Any]],
                 suspect_journals: Sequence[str] = (),
                 adapter: Optional[str] = None,
                 tenant: Optional[str] = None) -> Dict[str, Any]:
    """Compute which requests a suspect touched, from ledger records.

    A request is in the radius iff (a) any of its attempts ran on a
    suspect allocator generation (``journal`` ∈ ``suspect_journals``)
    while holding blocks or a stripe slot, (b) any attempt's
    ``migrated_from`` provenance names a suspect journal (the stream
    STARTED on the suspect and was live-migrated off — cross-replica
    reach), or (c) it decoded through a quarantined ``adapter``'s page
    or belongs to a quarantined ``tenant``.  Pure and host-only so
    tests can pin exact sets against hand-built ledgers.
    """
    suspects = set(suspect_journals)
    via: Dict[Any, List[Dict[str, Any]]] = {}
    suspect_blocks: Dict[str, set] = {}

    def touch(journal: str, blocks: Iterable[int]) -> None:
        suspect_blocks.setdefault(journal, set()).update(blocks or ())

    for rec in records:
        rid = rec.get("request_id")
        if rec.get("admitted") is False:
            # Hedge losers / vote replays carry no canonical placement;
            # the canonical record's ``attempts`` list already owns
            # every placement this request ever held.
            continue
        attempts = rec.get("attempts") or [rec]
        hows: List[Dict[str, Any]] = []
        for att in attempts:
            journal = att.get("journal")
            if journal is None and att.get("replica") is not None:
                journal = f"{att.get('replica')}:{att.get('gen', 0)}"
            if journal in suspects and _placement_touches(att):
                blocks = sorted(att.get("block_ids") or [])
                hows.append({"journal": journal, "blocks": blocks})
                touch(journal, blocks)
            src = att.get("migrated_from")
            if src and src.get("journal") in suspects:
                blocks = sorted(src.get("block_ids") or [])
                hows.append({"journal": src["journal"], "blocks": blocks,
                             "migrated_from": src.get("replica")})
                touch(src["journal"], blocks)
        if adapter is not None and rec.get("adapter") == adapter:
            hows.append({"adapter": adapter,
                         "adapter_page": rec.get("adapter_page")})
        if tenant is not None and rec.get("tenant") == tenant:
            hows.append({"tenant": tenant})
        if hows:
            via.setdefault(rid, []).extend(hows)
    return {
        "requests": sorted(via),
        "via": {str(rid): via[rid] for rid in sorted(via)},
        "suspect_blocks": {j: sorted(b)
                           for j, b in sorted(suspect_blocks.items())},
    }


class IncidentAssembler:
    """Joins the run's artifacts into one incident JSON per episode.

    ``directory=None`` is the in-memory mode (bench arms): incidents
    are assembled and counted but no file is written.  Trace events
    resolve from, in order: an explicit ``events=`` list passed to
    :meth:`assemble`, a ``trace`` object exposing ``.events`` (the
    test RecordingTrace) or ``.jsonl_path`` (a TraceBus), or
    ``trace_path`` via :func:`read_jsonl_rotated` — sealed rotation
    segments included.
    """

    def __init__(self, directory: Optional[str] = None, *,
                 trace: Any = None, trace_path: Optional[str] = None,
                 ledger: Any = None, journals: Any = None,
                 perf_ledger: Any = None, verdicts: Any = None,
                 registry: Any = None,
                 run_meta: Optional[Dict[str, Any]] = None):
        self.directory = str(directory) if directory else None
        if self.directory:
            os.makedirs(self.directory, exist_ok=True)
        self.trace = trace
        self.trace_path = trace_path
        self.ledger = ledger
        self.journals = journals
        self.perf_ledger = perf_ledger
        self.verdicts = verdicts
        if run_meta is None:
            from trustworthy_dl_tpu_torch.obs.meta import run_metadata

            # host_only: an offline post-mortem must never initialise
            # CUDA (nor import torch).  The paired flight dump carries
            # the device-probed stamp.
            run_meta = run_metadata(host_only=True)
        self._run_meta = run_meta
        self._lock = threading.Lock()
        self._index = 0
        #: (incident_id, reason) in assembly order — the bench's counts
        #: source when no directory is attached.
        self.incidents: List[Dict[str, str]] = []
        self._incident_counter = None
        if registry is not None:
            self._incident_counter = registry.counter(
                "tddl_incidents_total",
                "Forensic incident reports assembled, by reason",
                labels=("reason",),
            )

    # -- sources ------------------------------------------------------------

    def _events(self) -> List[Dict[str, Any]]:
        events: List[Dict[str, Any]] = []
        if self.trace is not None and hasattr(self.trace, "events"):
            events = [dict(e) for e in self.trace.events]
        else:
            path = self.trace_path
            if path is None and self.trace is not None:
                path = getattr(self.trace, "jsonl_path", None)
            if path and os.path.exists(path):
                events = read_jsonl_rotated(path)
        for i, event in enumerate(events):
            event.setdefault("seq", i + 1)
        return events

    def _records(self) -> List[Dict[str, Any]]:
        if self.ledger is None:
            return []
        if hasattr(self.ledger, "records"):
            return self.ledger.records()
        return list(self.ledger)

    def counts_by_reason(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for inc in self.incidents:
            out[inc["reason"]] = out.get(inc["reason"], 0) + 1
        return dict(sorted(out.items()))

    # -- assembly -----------------------------------------------------------

    def _mentions(self, event: Dict[str, Any],
                  suspects: Optional[Sequence[int]],
                  adapter: Optional[str]) -> bool:
        """Does this event reference one of the suspects?  With no
        suspects named (training-plane episodes) every signal/action
        event is in scope — the trigger's step window bounds it."""
        if suspects is None and adapter is None:
            return True
        if suspects is not None:
            for key in ("replica", "from_replica", "to_replica",
                        "primary"):
                if event.get(key) in suspects:
                    return True
        if adapter is not None and event.get("adapter") == adapter:
            return True
        return False

    def assemble(self, reason: str, *,
                 step: Optional[int] = None,
                 tick: Optional[int] = None,
                 suspects: Optional[Sequence[int]] = None,
                 suspect_journals: Sequence[str] = (),
                 adapter: Optional[str] = None,
                 tenant: Optional[str] = None,
                 trigger_type: Optional[str] = None,
                 flight_path: Optional[str] = None,
                 directory: Optional[str] = None,
                 counters: Optional[Dict[str, int]] = None,
                 refusals: Optional[List[Dict[str, Any]]] = None,
                 events: Optional[List[Dict[str, Any]]] = None,
                 records: Optional[List[Dict[str, Any]]] = None,
                 extra: Optional[Dict[str, Any]] = None
                 ) -> Optional[str]:
        """Assemble and (when a directory is known) write one incident.

        Returns the written path, or ``None`` in in-memory mode.  The
        incident index pairs with the flight dump when ``flight_path``
        is given (``flight_007_x.json`` → ``incident_007_x.json``);
        otherwise it increments a private counter.
        """
        if events is None:
            events = self._events()
        else:
            events = [dict(e) for e in events]
            for i, event in enumerate(events):
                event.setdefault("seq", i + 1)
        if records is None:
            records = self._records()

        trigger: Optional[Dict[str, Any]] = None
        want = trigger_type or reason
        for event in events:
            if event.get("type") == want \
                    and self._mentions(event, suspects, adapter):
                trigger = event  # LAST matching event wins (the episode)
        if trigger is None:
            trigger = {"type": want, "seq": None, "synthetic": True}
        trigger_seq = trigger.get("seq")

        contributing = [
            e for e in events
            if e.get("type") in SIGNAL_EVENTS
            and self._mentions(e, suspects, adapter)
            and (trigger_seq is None or e.get("seq", 0) <= trigger_seq)
        ]
        actions = [
            e for e in events
            if e.get("type") in ACTION_EVENTS
            and self._mentions(e, suspects, adapter)
        ]

        radius = blast_radius(records, suspect_journals=suspect_journals,
                              adapter=adapter, tenant=tenant)

        perf_tail = None
        if self.perf_ledger is not None:
            try:
                perf_tail = self.perf_ledger.last()
            except (OSError, AttributeError):
                perf_tail = None

        with self._lock:
            index = None
            if flight_path:
                m = re.search(r"flight_(\d+)_", os.path.basename(
                    flight_path))
                if m:
                    index = int(m.group(1))
            if index is None:
                index = self._index
            self._index = max(self._index + 1, index + 1)
            incident_id = f"incident_{index:03d}_{reason}"
            self.incidents.append({"incident_id": incident_id,
                                   "reason": reason})

        incident: Dict[str, Any] = {
            "schema_version": INCIDENT_SCHEMA_VERSION,
            "incident_id": incident_id,
            "reason": reason,
            "step": step, "tick": tick,
            "suspect_replicas": list(suspects) if suspects else [],
            "suspect_journals": list(suspect_journals),
            "adapter": adapter, "tenant": tenant,
            "flight_dump": flight_path,
            "trigger": trigger,
            "contributing": contributing,
            "actions": actions,
            "blast_radius": radius,
            "counters": dict(counters or {}),
            "refused_destinations": list(refusals or []),
            "perf_tail": perf_tail,
            "t": time.time(),
            "run_metadata": self._run_meta,
        }
        if extra:
            incident["extra"] = dict(extra)

        directory = directory or self.directory
        path = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, incident_id + ".json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(incident, f, indent=2, default=str)
            os.replace(tmp, path)
        if self._incident_counter is not None:
            self._incident_counter.inc(reason=reason)
        if self.verdicts is not None:
            self.verdicts.append(
                "incident", "recorded", reason=reason,
                replica=suspects[0] if suspects else None,
                adapter=adapter, tenant=tenant,
                incident_id=incident_id, tick=tick, step=step)
        if self.trace is not None and hasattr(self.trace, "emit"):
            from trustworthy_dl_tpu_torch.obs.events import EventType

            self.trace.emit(EventType.INCIDENT, incident_id=incident_id,
                            reason=reason, path=path, step=step)
        return path


# -- offline readers (the obs CLI renders from these) ------------------------


def load_incidents(directory: str) -> List[Dict[str, Any]]:
    """All ``incident_NNN_<reason>.json`` files under ``directory``,
    sorted by index; unreadable files are skipped (torn-artifact
    tolerance, same stance as the ledgers)."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        m = _INCIDENT_RE.match(name)
        if not m:
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                out.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    out.sort(key=lambda inc: inc.get("incident_id", ""))
    return out


def find_incident(directory: str, ident: str) -> Optional[Dict[str, Any]]:
    """Look an incident up by full id, bare index ("7"), or reason
    substring (first match wins)."""
    incidents = load_incidents(directory)
    for inc in incidents:
        if inc.get("incident_id") == ident:
            return inc
    if ident.isdigit():
        idx = int(ident)
        for inc in incidents:
            m = _INCIDENT_RE.match(inc.get("incident_id", "") + ".json")
            if m and int(m.group(1)) == idx:
                return inc
    for inc in incidents:
        if ident in inc.get("incident_id", ""):
            return inc
    return None


def _event_line(event: Dict[str, Any]) -> str:
    seq = event.get("seq")
    etype = event.get("type", "?")
    keys = ("replica", "from_replica", "to_replica", "from_state",
            "to_state", "reason", "outcome", "request_id", "adapter",
            "kind", "score", "signal", "metric", "step", "tick")
    detail = " ".join(f"{k}={event[k]}" for k in keys
                      if event.get(k) is not None)
    return f"  [seq {seq if seq is not None else '—'}] {etype} {detail}"


def render_incident(incident: Dict[str, Any]) -> str:
    """Human-readable causal timeline for ``incident show``."""
    lines = [
        f"{incident.get('incident_id')}  reason={incident.get('reason')}"
        f"  tick={incident.get('tick')}  step={incident.get('step')}",
        f"suspects: replicas={incident.get('suspect_replicas')} "
        f"journals={incident.get('suspect_journals')} "
        f"adapter={incident.get('adapter')}",
    ]
    if incident.get("flight_dump"):
        lines.append(f"flight dump: {incident['flight_dump']}")
    lines.append("trigger:")
    lines.append(_event_line(incident.get("trigger") or {}))
    lines.append(f"contributing signals "
                 f"({len(incident.get('contributing') or [])}):")
    lines.extend(_event_line(e)
                 for e in incident.get("contributing") or [])
    lines.append(f"actions taken ({len(incident.get('actions') or [])}):")
    lines.extend(_event_line(e) for e in incident.get("actions") or [])
    if incident.get("refused_destinations"):
        lines.append("refused destinations:")
        lines.extend(f"  replica {r.get('replica')}: {r.get('reason')}"
                     for r in incident["refused_destinations"])
    counters = incident.get("counters") or {}
    hot = {k: v for k, v in counters.items() if v}
    if hot:
        lines.append("counters at assembly: " + ", ".join(
            f"{k}={v}" for k, v in sorted(hot.items())))
    radius = incident.get("blast_radius") or {}
    lines.append(f"blast radius: {len(radius.get('requests') or [])} "
                 f"request(s) {radius.get('requests')}")
    return "\n".join(lines)


def render_blast(incident: Dict[str, Any]) -> str:
    """Per-request blast-radius detail for ``incident blast``."""
    radius = incident.get("blast_radius") or {}
    lines = [f"{incident.get('incident_id')}  blast radius "
             f"({len(radius.get('requests') or [])} requests)"]
    via = radius.get("via") or {}
    for rid in radius.get("requests") or []:
        lines.append(f"request {rid}:")
        for how in via.get(str(rid), []):
            if "journal" in how:
                src = (f" (migrated from replica "
                       f"{how['migrated_from']})"
                       if "migrated_from" in how else "")
                lines.append(f"  journal {how['journal']} blocks "
                             f"{how.get('blocks')}{src}")
            elif "adapter" in how:
                lines.append(f"  adapter {how['adapter']} page "
                             f"{how.get('adapter_page')}")
            elif "tenant" in how:
                lines.append(f"  tenant {how['tenant']}")
    blocks = radius.get("suspect_blocks") or {}
    if blocks:
        lines.append("suspect blocks by journal:")
        lines.extend(f"  {j}: {b}" for j, b in blocks.items())
    return "\n".join(lines)


__all__ = ["ACTION_EVENTS", "ARTIFACT_REASONS", "INCIDENT_SCHEMA_VERSION",
           "IncidentAssembler", "SIGNAL_EVENTS", "blast_radius",
           "find_incident", "load_incidents", "render_blast",
           "render_incident"]
