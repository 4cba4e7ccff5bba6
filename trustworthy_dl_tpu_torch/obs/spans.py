"""Hierarchical spans: timed, nestable units of work emitted through the
trace bus and exportable as a Chrome/Perfetto ``trace_events`` timeline.

Counterpart of ``trustworthy_dl_tpu/obs/spans.py``: the same names,
schemas and behaviour, in the port's own copy.

Events (obs/events.py) answer *what happened*; spans answer *where the
time went*.  A span is one record — id, optional parent id, kind, name,
start/end monotonic timestamps, free-form attrs — correlated on the same
``step``/``request_id`` keys as every other trace row, so a reader can
join a request's ``serve.decode`` span against its ``serve_retire``
event, or a training step's ``train.compute`` span against its
``train_step`` row.

Design constraints (the serving hot loop runs through this):

* **Emit-on-close only.**  A span becomes one ``span`` trace event when
  it ENDS (start time and duration both known), so tracking N open spans
  costs N small dicts and the trace stays one-line-per-span.  There is
  no span-start event to pair up or leak.
* **Bounded memory.**  Open spans live in a dict keyed by id; closed
  spans are retained in a ring (``keep``) solely for in-process Chrome
  export — the durable record is the trace JSONL, which the CLI can
  convert without any retained state (:func:`chrome_trace_from_events`).
* **Host-only.**  Nothing here touches torch; ``time.perf_counter`` laps
  on the host step/iteration loop, exactly like obs/report.py.

Chrome export: ``chrome://tracing`` / https://ui.perfetto.dev consume
the JSON object format ``{"traceEvents": [{"ph": "X", ...}]}``; complete
("X") events need only name/cat/ts/dur/pid/tid, with attrs as ``args``.
The track (``tid``) is the request id for serving spans, so concurrent
requests render as parallel lanes; training spans all share one lane
(sequential steps read as a timeline, not a per-step ladder — the step
id rides in ``args``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence

from trustworthy_dl_tpu_torch.utils.io import atomic_write_json


@dataclasses.dataclass
class Span:
    """One closed (or still-open, ``end is None``) unit of work."""

    span_id: int
    name: str
    kind: str
    start: float                      # time.perf_counter() domain
    end: Optional[float] = None
    parent_id: Optional[int] = None
    step: Optional[int] = None
    request_id: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start


class SpanTracker:
    """Start/end span bookkeeping + emission through a TraceBus.

    ``trace`` is any object with the TraceBus ``emit`` signature (or
    None — spans are then only retained for :meth:`export_chrome`).
    Thread-safe: the serving engine and an async drain may both close
    spans.
    """

    def __init__(self, trace: Any = None, keep: int = 8192):
        self.trace = trace
        self._lock = threading.Lock()
        self._open: Dict[int, Span] = {}
        self._closed: collections.deque = collections.deque(maxlen=keep)
        self._next_id = 0
        self._dropped = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self, name: str, kind: str = "span", *,
              parent_id: Optional[int] = None, step: Optional[int] = None,
              request_id: Optional[int] = None, t: Optional[float] = None,
              **attrs: Any) -> int:
        """Open a span; returns its id (pass as ``parent_id`` to nest)."""
        with self._lock:
            self._next_id += 1
            sid = self._next_id
            self._open[sid] = Span(
                span_id=sid, name=name, kind=kind,
                start=time.perf_counter() if t is None else t,
                parent_id=parent_id, step=step, request_id=request_id,
                attrs=dict(attrs),
            )
        return sid

    def end(self, span_id: int, t: Optional[float] = None,
            **attrs: Any) -> Optional[Span]:
        """Close a span and emit it.  Unknown/already-closed ids are a
        no-op returning None (a retire path may race a shed path; the
        second close must not corrupt the record)."""
        with self._lock:
            span = self._open.pop(span_id, None)
            if span is None:
                self._dropped += 1
                return None
            span.end = time.perf_counter() if t is None else t
            span.attrs.update(attrs)
            self._closed.append(span)
        self._emit(span)
        return span

    def add(self, name: str, start: float, end: float, kind: str = "span",
            *, parent_id: Optional[int] = None, step: Optional[int] = None,
            request_id: Optional[int] = None, **attrs: Any) -> Span:
        """Record an already-measured span in one call (the trainer's
        per-phase laps are synthesized this way at ``finish_step``)."""
        with self._lock:
            self._next_id += 1
            span = Span(span_id=self._next_id, name=name, kind=kind,
                        start=start, end=end, parent_id=parent_id,
                        step=step, request_id=request_id, attrs=dict(attrs))
            self._closed.append(span)
        self._emit(span)
        return span

    @contextmanager
    def span(self, name: str, kind: str = "span",
             **kwargs: Any) -> Iterator[int]:
        sid = self.start(name, kind, **kwargs)
        try:
            yield sid
        finally:
            self.end(sid)

    def _emit(self, span: Span) -> None:
        if self.trace is None:
            return
        from trustworthy_dl_tpu_torch.obs.events import EventType

        self.trace.emit(
            EventType.SPAN, step=span.step, request_id=span.request_id,
            name=span.name, kind=span.kind, span_id=span.span_id,
            parent_id=span.parent_id, duration_s=span.duration_s,
            start_mono=span.start, **span.attrs,
        )

    # -- introspection -----------------------------------------------------

    @property
    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def closed_spans(self) -> List[Span]:
        with self._lock:
            return list(self._closed)

    # -- Chrome/Perfetto export -------------------------------------------

    def export_chrome(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Closed spans as a ``{"traceEvents": [...]}`` object (written
        to ``path`` when given) — load in chrome://tracing / Perfetto."""
        events = [_chrome_event(
            s.name, s.kind, s.start, s.duration_s or 0.0,
            step=s.step, request_id=s.request_id, span_id=s.span_id,
            parent_id=s.parent_id, attrs=s.attrs,
        ) for s in self.closed_spans()]
        payload = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            atomic_write_json(path, payload, indent=None)
        return payload


def _chrome_event(name: str, kind: str, start: float, duration: float, *,
                  step: Optional[int], request_id: Optional[int],
                  span_id: Any, parent_id: Any,
                  attrs: Dict[str, Any]) -> Dict[str, Any]:
    # Track layout: serving spans lane per request, training spans lane
    # per kind (all steps on one lane reads as a timeline, not a ladder).
    if request_id is not None:
        pid, tid = 1, int(request_id)
    else:
        pid, tid = 0, 0
    args = {k: v for k, v in attrs.items() if v is not None}
    if step is not None:
        args["step"] = step
    if parent_id is not None:
        args["parent_id"] = parent_id
    return {
        "name": name, "cat": kind, "ph": "X",
        "ts": start * 1e6, "dur": max(duration, 0.0) * 1e6,
        "pid": pid, "tid": tid, "id": span_id, "args": args,
    }


def chrome_trace_from_events(events: Sequence[Dict[str, Any]],
                             path: Optional[str] = None) -> Dict[str, Any]:
    """Convert ``span`` rows of a trace JSONL (obs/events.py) into the
    Chrome trace_events object — the CLI's offline exporter, needing no
    in-process SpanTracker state."""
    meta_keys = {"seq", "t", "t_mono", "type", "name", "kind", "span_id",
                 "parent_id", "duration_s", "start_mono", "step",
                 "request_id"}
    out = []
    for e in events:
        if e.get("type") != "span" or e.get("duration_s") is None:
            continue
        out.append(_chrome_event(
            e.get("name", "?"), e.get("kind", "span"),
            float(e.get("start_mono", 0.0)), float(e["duration_s"]),
            step=e.get("step"), request_id=e.get("request_id"),
            span_id=e.get("span_id"), parent_id=e.get("parent_id"),
            attrs={k: v for k, v in e.items() if k not in meta_keys},
        ))
    payload = {"traceEvents": out, "displayTimeUnit": "ms"}
    if path is not None:
        atomic_write_json(path, payload, indent=None)
    return payload
