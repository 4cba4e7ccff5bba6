"""VerdictStore — durable cross-plane trust history.

Counterpart of ``trustworthy_dl_tpu/obs/verdicts.py``: the same file
format, outcome vocabulary, metric and event.  The trust machinery
produces VERDICTS — suspicion episodes opening and closing, cross-replica
vote outcomes, replica and adapter quarantines, readmissions, assembled
incidents.  The VerdictStore is their durable, queryable aggregation: one
JSONL file (keep-trim, torn-line tolerant, ``run_metadata``-stamped — the
:class:`~trustworthy_dl_tpu_torch.obs.sentinel.PerfLedger` pattern) whose
entries accumulate ACROSS runs.  On one card the port appends the
``incident`` rows its incident assembler records; the fleet's suspicion,
vote and quarantine rows arrive with the fleet.

Entry shape (one JSON object per line)::

    {"kind": "vote", "outcome": "outvoted", "replica": 2,
     "tenant": null, "adapter": null, "reason": "verdict_outvoted",
     "request_id": 7, "incident_id": null, "tick": 9, "step": null,
     "t": 1722700000.1, "run_metadata": {...}}

``kind`` ∈ {"suspicion", "vote", "quarantine", "adapter_quarantine",
"incident"}; ``outcome`` is the small label vocabulary the
``tddl_verdicts_total{outcome=}`` counter pages on.

Host-only: nothing here imports torch (the stamp is
``run_metadata(host_only=True)``), so the obs command reads the store in a
process that never loads it.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

#: The closed outcome vocabulary — the label set of
#: ``tddl_verdicts_total{outcome=}`` (bounded cardinality by contract).
VERDICT_OUTCOMES = (
    "opened", "closed", "confirmed", "outvoted", "inconclusive",
    "quarantined", "readmitted", "recorded",
)


class VerdictStore:
    """Rolling JSONL of trust verdicts.  ``keep`` bounds the FILE: an
    append past it rewrites the tail — a trajectory window of recent
    trust history, not an archive (the trace segments are the
    archive)."""

    def __init__(self, path: str, keep: int = 512, *,
                 run_meta: Optional[Dict[str, Any]] = None,
                 registry: Any = None, trace: Any = None):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.path = str(path)
        self.keep = keep
        self.trace = trace
        if run_meta is None:
            from trustworthy_dl_tpu_torch.obs.meta import run_metadata

            # host_only: appending a verdict must never initialise CUDA
            # (nor import torch: the obs command reads this store).
            run_meta = run_metadata(host_only=True)
        self._run_meta = run_meta
        self._verdict_counter = None
        if registry is not None:
            self._verdict_counter = registry.counter(
                "tddl_verdicts_total",
                "Durable trust verdicts appended to the VerdictStore",
                labels=("outcome",),
            )

    def read(self) -> List[Dict[str, Any]]:
        entries: List[Dict[str, Any]] = []
        try:
            with open(self.path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entries.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue  # a torn line loses one row, not the file
        except OSError:
            pass
        return entries

    def append(self, kind: str, outcome: str, *,
               replica: Optional[int] = None,
               tenant: Optional[str] = None,
               adapter: Optional[str] = None,
               reason: Optional[str] = None,
               request_id: Optional[int] = None,
               incident_id: Optional[str] = None,
               tick: Optional[int] = None,
               step: Optional[int] = None,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        if outcome not in VERDICT_OUTCOMES:
            raise ValueError(f"unknown verdict outcome {outcome!r} "
                             f"(vocabulary: {VERDICT_OUTCOMES})")
        entry: Dict[str, Any] = {
            "kind": kind, "outcome": outcome, "replica": replica,
            "tenant": tenant, "adapter": adapter, "reason": reason,
            "request_id": request_id, "incident_id": incident_id,
            "tick": tick, "step": step, "t": time.time(),
            "run_metadata": self._run_meta,
        }
        if extra:
            entry.update(extra)
        entries = self.read()
        entries.append(entry)
        if len(entries) > self.keep:
            entries = entries[-self.keep:]
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for row in entries:
                f.write(json.dumps(row) + "\n")
        os.replace(tmp, self.path)
        if self._verdict_counter is not None:
            self._verdict_counter.inc(outcome=outcome)
        if self.trace is not None:
            from trustworthy_dl_tpu_torch.obs.events import EventType

            self.trace.emit(EventType.VERDICT, kind=kind, outcome=outcome,
                            replica=replica, adapter=adapter,
                            reason=reason)
        return entry

    # -- the item-5a read interface -----------------------------------------

    def history(self, *, replica: Optional[int] = None,
                tenant: Optional[str] = None,
                adapter: Optional[str] = None) -> List[Dict[str, Any]]:
        """Entries for one subject, oldest first (filters AND)."""
        rows = self.read()
        if replica is not None:
            rows = [r for r in rows if r.get("replica") == replica]
        if tenant is not None:
            rows = [r for r in rows if r.get("tenant") == tenant]
        if adapter is not None:
            rows = [r for r in rows if r.get("adapter") == adapter]
        return rows

    def priors(self) -> Dict[str, Any]:
        """Aggregate the window into per-subject trust priors — the
        exact shape the training-side trust manager folds into its
        initial scores: per replica/tenant/adapter, counts by
        (kind, outcome) plus the incident ids on record."""
        out: Dict[str, Any] = {"replicas": {}, "tenants": {},
                               "adapters": {}}

        def bucket(table: Dict[str, Any], key: Any) -> Dict[str, Any]:
            key = str(key)
            if key not in table:
                table[key] = {"counts": {}, "incidents": []}
            return table[key]

        for row in self.read():
            subjects = []
            if row.get("replica") is not None:
                subjects.append(bucket(out["replicas"], row["replica"]))
            if row.get("tenant") is not None:
                subjects.append(bucket(out["tenants"], row["tenant"]))
            if row.get("adapter") is not None:
                subjects.append(bucket(out["adapters"], row["adapter"]))
            label = f"{row.get('kind')}:{row.get('outcome')}"
            for subject in subjects:
                subject["counts"][label] = \
                    subject["counts"].get(label, 0) + 1
                iid = row.get("incident_id")
                if iid and iid not in subject["incidents"]:
                    subject["incidents"].append(iid)
        return out


__all__ = ["VERDICT_OUTCOMES", "VerdictStore"]
