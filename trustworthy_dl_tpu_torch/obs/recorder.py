"""Flight recorder: a bounded ring buffer of recent trace events,
dumped to disk when something goes wrong.

Counterpart of ``trustworthy_dl_tpu/obs/recorder.py``: the same names,
schemas and behaviour, in the port's own copy.

The trace JSONL is the full flight log; the recorder is the black box —
always on, O(capacity) memory, and cheap enough to run even when no
``--obs-dir`` was given.  The supervisor dumps it next to the
checkpoint directory on rollback, non-finite guard trip and preemption,
so every recovery leaves a queryable post-mortem artifact: what the
last N events were, in order, with correlation ids intact.
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Dict, List, Optional


class FlightRecorder:
    """Ring buffer of event dicts (see :mod:`obs.events`)."""

    def __init__(self, capacity: int = 2048):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._total = 0
        self._dumps = 0

    def record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)
            self._total += 1

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def counts(self) -> Dict[str, int]:
        """Retained events by type — what a drill asserts against."""
        out: Dict[str, int] = {}
        for event in self.events():
            key = event.get("type", "unknown")
            out[key] = out.get(key, 0) + 1
        return out

    @property
    def total_recorded(self) -> int:
        """Events ever seen (retained + evicted by the ring bound)."""
        return self._total

    def dump(self, directory: str, reason: str,
             step: Optional[int] = None,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the retained events (+ run metadata) as one JSON file
        under ``directory``; returns the path.  Filenames embed reason /
        step / a per-recorder dump index so repeated incidents never
        overwrite each other."""
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata

        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._dumps += 1
            index = self._dumps
        name = f"flight_{index:03d}_{reason}"
        if step is not None:
            name += f"_step{int(step)}"
        path = os.path.join(directory, name + ".json")
        events = self.events()
        payload: Dict[str, Any] = {
            "reason": reason,
            "step": int(step) if step is not None else None,
            "capacity": self.capacity,
            "num_events": len(events),
            "total_recorded": self._total,
            "run_metadata": run_metadata(),
            "events": events,
        }
        if extra:
            payload.update(extra)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)  # a torn post-mortem is worse than none
        return path
