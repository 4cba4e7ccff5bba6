"""ObsSession — the one handle a run threads through its layers.

Counterpart of ``trustworthy_dl_tpu/obs/session.py``, less what the port
has not got yet (ROADMAP, the rest of obs/ on one card): the compile watcher, the
forensics tier and the perf sentinel (``enable_compile_watch``,
``enable_forensics`` and ``write_perf`` raise ``NotImplementedError``),
and the per-program cost ledger (so no ``cost_ledger`` block and no
``PERF_LEDGER.jsonl``).

Bundles the four telemetry pieces with a shared output directory::

    session = ObsSession("runs/exp7/obs", metrics_snapshot_every=50)
    trainer.attach_obs(session)          # events + phase timing
    TrainingSupervisor(trainer, obs=session, ...)  # recovery events + dumps
    ...
    session.finalize()                   # snapshot + obs_report.json

Artifacts under ``obs_dir``:

* ``trace.jsonl`` — the structured event stream (obs/events.py)
* ``metrics_snapshot.json`` — latest registry snapshot (rewritten at the
  ``metrics_snapshot_every`` step cadence and at finalize)
* ``metrics.prom`` — Prometheus text exposition of the same registry
* ``obs_report.json`` — step-time breakdown + MFU (obs/report.py).
  Under the async host pipeline (``async_host_depth`` > 0) the report's
  ``host`` phase is the time the loop blocked on lagged metrics + host
  bookkeeping — the dispatch-gap number the pipeline collapses
* ``flight_*.json`` — flight-recorder dumps (obs/recorder.py); the
  supervisor writes its incident dumps next to the *checkpoints*
  instead, via ``dump_flight(directory=...)``

``obs_dir=None`` is a valid in-memory mode: events still flow to the
flight recorder and metrics to the registry; only the files are skipped.

Each session owns a FRESH registry by default (pass ``registry=`` to
share one): the snapshot a run publishes must describe *that run*, and
the process-wide default registry accumulates across every run in the
process (repeated experiment cells, threshold sweeps) — summed counters
and cross-run percentiles presented as one run's metrics would be
silently wrong.  ``trainer.attach_obs`` re-binds the trainer's
collector onto the session registry for the same reason.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional

from trustworthy_dl_tpu_torch.obs.events import EventType, TraceBus
from trustworthy_dl_tpu_torch.obs.recorder import FlightRecorder
from trustworthy_dl_tpu_torch.obs.registry import MetricsRegistry
from trustworthy_dl_tpu_torch.obs.report import StepTimeReporter
from trustworthy_dl_tpu_torch.utils.io import atomic_write_json, \
    atomic_write_text

logger = logging.getLogger(__name__)

#: Extra artifacts the active plane adds under ``obs_dir``:
#: ``attribution.jsonl`` (per-request attribution ledger),
#: ``slo_status.json`` (SLO/anomaly watcher rollup at finalize),
#: ``trace_events.json`` (Chrome/Perfetto span timeline at finalize).


#: The ROADMAP item the session's unported tiers wait for.
_NEXT_ITEM = ("ROADMAP: the rest of obs/ on one card (compilewatch, "
              "forensics, verdicts, sentinel, cli obs)")


class ObsSession:
    def __init__(self, obs_dir: Optional[str] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 recorder_capacity: int = 2048,
                 metrics_snapshot_every: int = 0,
                 validate_events: bool = True,
                 trace_max_bytes: int = 0):
        self.obs_dir = str(obs_dir) if obs_dir else None
        if self.obs_dir:
            os.makedirs(self.obs_dir, exist_ok=True)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.recorder = FlightRecorder(recorder_capacity)
        # ``trace_max_bytes`` (or TDDL_TRACE_MAX_BYTES) bounds the live
        # trace file: past the cap it is sealed as trace.<n>.jsonl and a
        # fresh segment opens (obs/events.py rotation; readers walk the
        # segments in order).
        if trace_max_bytes == 0:
            trace_max_bytes = int(os.environ.get("TDDL_TRACE_MAX_BYTES",
                                                 "0"))
        self.trace = TraceBus(
            os.path.join(self.obs_dir, "trace.jsonl")
            if self.obs_dir else None,
            recorder=self.recorder, registry=self.registry,
            validate=validate_events, max_bytes=trace_max_bytes,
        )
        self.step_timer = StepTimeReporter(registry=self.registry)
        self.metrics_snapshot_every = int(metrics_snapshot_every)
        self._finalized = False
        # Active-plane attachments (None until enabled — the passive
        # recorder stays exactly as cheap as before).
        self.spans: Any = None            # obs.spans.SpanTracker
        self.slo: Any = None              # obs.slo.SLOWatcher
        self.anomaly: Any = None          # obs.anomaly.AnomalyWatcher
        self.ledger: Any = None           # obs.attribution.AttributionLedger
        self.hbm: Any = None              # obs.hbm.HbmMonitor
        self.trace.emit(EventType.RUN_START, obs_dir=self.obs_dir)

    # -- active plane ------------------------------------------------------

    def enable_spans(self) -> Any:
        """Attach a SpanTracker to the trace bus AND the step timer (the
        trainer's per-phase laps become ``train.*`` spans for free)."""
        if self.spans is None:
            from trustworthy_dl_tpu_torch.obs.spans import SpanTracker

            self.spans = SpanTracker(trace=self.trace)
            self.step_timer.spans = self.spans
        return self.spans

    def install_watchers(self, slo_rules: Any = None,
                         anomaly_signals: Any = None) -> tuple:
        """Construct the SLO and anomaly watchers wired to this
        session's trace/registry/flight-recorder.  ``slo_rules`` default
        to :func:`obs.slo.default_serve_rules`; ``anomaly_signals`` to
        :data:`obs.anomaly.DEFAULT_SIGNALS`.  Returns ``(slo, anomaly)``
        (idempotent — repeated calls return the existing watchers)."""
        from trustworthy_dl_tpu_torch.obs.anomaly import AnomalyWatcher
        from trustworthy_dl_tpu_torch.obs.slo import SLOWatcher, \
            default_serve_rules

        if self.slo is None:
            self.slo = SLOWatcher(
                default_serve_rules() if slo_rules is None else slo_rules,
                registry=self.registry, trace=self.trace,
                dump=self.dump_flight,
            )
        if self.anomaly is None:
            self.anomaly = AnomalyWatcher(
                anomaly_signals, registry=self.registry, trace=self.trace,
                dump=self.dump_flight,
            )
        return self.slo, self.anomaly

    def enable_compile_watch(self, warmup_calls: int = 1) -> Any:
        """The compile watcher (JAX ``obs/compilewatch.py``) is not
        ported yet."""
        raise NotImplementedError(
            f"the compile watcher is not ported yet ({_NEXT_ITEM})")

    def enable_hbm(self, budget_bytes: Optional[int] = None,
                   reserve_fraction: float = 0.0) -> Any:
        """Attach the live device-memory monitor (gauges + watermark +
        the pool headroom gate the serve engine consults).  Idempotent."""
        if self.hbm is None:
            from trustworthy_dl_tpu_torch.obs.hbm import HbmMonitor

            self.hbm = HbmMonitor(
                registry=self.registry, trace=self.trace,
                budget_bytes=budget_bytes,
                reserve_fraction=reserve_fraction,
            )
        return self.hbm

    def enable_forensics(self, verdict_path: Optional[str] = None,
                         directory: Optional[str] = None) -> Any:
        """The incident assembler and verdict store (JAX
        ``obs/forensics.py``, ``obs/verdicts.py``) are not ported yet."""
        raise NotImplementedError(
            f"the forensics tier is not ported yet ({_NEXT_ITEM})")

    def open_ledger(self, keep: int = 4096) -> Any:
        """Open the per-request attribution ledger (JSONL beside the
        trace when ``obs_dir`` is set; in-memory ring otherwise)."""
        if self.ledger is None:
            from trustworthy_dl_tpu_torch.obs.attribution import \
                AttributionLedger

            self.ledger = AttributionLedger(
                os.path.join(self.obs_dir, "attribution.jsonl")
                if self.obs_dir else None, keep=keep,
            )
        return self.ledger

    # -- cadence hooks -----------------------------------------------------

    def on_step(self, step: int) -> None:
        """Called by the trainer once per accounted step."""
        total = self.step_timer.last_step_total
        if total is not None:
            if self.anomaly is not None:
                self.anomaly.observe("step_time", total, step=step)
            if self.slo is not None:
                self.slo.observe("step_time_s", total, step=step)
        if (self.metrics_snapshot_every > 0
                and step % self.metrics_snapshot_every == 0):
            self.snapshot_metrics(step=step)

    # -- artifacts ---------------------------------------------------------

    def snapshot_metrics(self, step: Optional[int] = None
                         ) -> Optional[str]:
        if not self.obs_dir:
            return None
        path = os.path.join(self.obs_dir, "metrics_snapshot.json")
        self.registry.snapshot_to_json(
            path, extra={"step": step} if step is not None else None
        )
        atomic_write_text(os.path.join(self.obs_dir, "metrics.prom"),
                          self.registry.prometheus_text())
        self.trace.emit(EventType.METRICS_SNAPSHOT, step=step, path=path)
        return path

    def dump_flight(self, reason: str, step: Optional[int] = None,
                    directory: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Optional[str]:
        """Dump the ring buffer; ``directory`` defaults to ``obs_dir``
        (the supervisor passes the checkpoint dir so the post-mortem
        lands next to the state it explains)."""
        directory = directory or self.obs_dir
        if not directory:
            return None
        path = self.recorder.dump(directory, reason, step=step, extra=extra)
        # Emitted AFTER the dump so the dump never contains its own
        # announcement but the trace records where it went.
        self.trace.emit(EventType.FLIGHT_DUMP, step=step, path=path,
                        reason=reason)
        return path

    def write_report(self) -> Optional[Dict[str, Any]]:
        if not self.obs_dir:
            return self.step_timer.report()
        path = os.path.join(self.obs_dir, "obs_report.json")
        report = self.step_timer.write(path)
        logger.info("obs: report written to %s (%d steps)", path,
                    report.get("num_steps", 0))
        return report

    def write_slo_status(self) -> Optional[Dict[str, Any]]:
        """Watcher rollup (SLO burn + anomaly baselines) as
        ``slo_status.json``."""
        if self.slo is None and self.anomaly is None:
            return None
        status: Dict[str, Any] = {}
        if self.slo is not None:
            status["slo"] = self.slo.status()
        if self.anomaly is not None:
            status["anomaly"] = self.anomaly.status()
        if self.obs_dir:
            atomic_write_json(
                os.path.join(self.obs_dir, "slo_status.json"), status)
        return status

    def write_perf(self) -> Optional[Dict[str, Any]]:
        """The perf sentinel (JAX ``obs/sentinel.py``) is not ported
        yet."""
        raise NotImplementedError(
            f"the perf sentinel is not ported yet ({_NEXT_ITEM})")

    def finalize(self) -> None:
        """Final snapshot + report + active-plane artifacts + close the
        trace file.  Idempotent."""
        if self._finalized:
            return
        self._finalized = True
        self.snapshot_metrics()
        self.write_report()
        self.write_slo_status()
        if self.spans is not None and self.obs_dir:
            self.spans.export_chrome(
                os.path.join(self.obs_dir, "trace_events.json")
            )
        if self.ledger is not None:
            self.ledger.close()
        self.trace.emit(EventType.RUN_END)  # last event in the trace
        self.trace.close()


__all__ = ["ObsSession"]
