"""ObsSession — the one handle a run threads through its layers.

Counterpart of ``trustworthy_dl_tpu/obs/session.py``, whole: the passive
recorder, the active plane (spans, watchers, attribution ledger), the
performance tier (the compile watcher over the kernel-library builds, the
device-memory monitor, the cost ledger, the perf sentinel) and the
forensics tier (an incident paired with every flight dump, the verdict
store).

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
* ``incident_*.json`` — with forensics on, the post-mortem paired with
  each flight dump, in the dump's directory (obs/forensics.py), and
  ``VERDICTS.jsonl``, the verdict store (obs/verdicts.py)
* ``PERF_LEDGER.jsonl`` — the rolling perf-fingerprint ledger the
  sentinel bands against (obs/sentinel.py); the path is the
  ``perf_ledger`` argument, else ``TDDL_PERF_LEDGER``, else this file
  under ``obs_dir``

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


class ObsSession:
    def __init__(self, obs_dir: Optional[str] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 recorder_capacity: int = 2048,
                 metrics_snapshot_every: int = 0,
                 validate_events: bool = True,
                 trace_max_bytes: int = 0,
                 perf_ledger: Optional[str] = None):
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
        # Performance tier (None until enabled): the compile registry/
        # watcher pair and the device-memory monitor.  The cost ledger is
        # kept by artifact-producing sessions (obs_dir set) only.
        self.compiles: Any = None         # obs.compilewatch.CompileRegistry
        self.compilewatch: Any = None     # obs.compilewatch.CompileWatcher
        self.hbm: Any = None              # obs.hbm.HbmMonitor
        # Forensics tier (None until enabled): the incident assembler
        # pairs a structured post-mortem with every flight dump; the
        # verdict store is the durable cross-run trust history.
        self.forensics: Any = None        # obs.forensics.IncidentAssembler
        self.verdicts: Any = None         # obs.verdicts.VerdictStore
        self.cost_ledger: Any = None
        if self.obs_dir:
            from trustworthy_dl_tpu_torch.obs.hbm import CostLedger

            self.cost_ledger = CostLedger()
        self.step_timer.cost_ledger = self.cost_ledger
        # Perf-fingerprint ledger path: explicit arg, else
        # TDDL_PERF_LEDGER (the cross-run trajectory file), else a
        # run-local PERF_LEDGER.jsonl beside the other artifacts.
        if perf_ledger is None:
            perf_ledger = os.environ.get("TDDL_PERF_LEDGER") or (
                os.path.join(self.obs_dir, "PERF_LEDGER.jsonl")
                if self.obs_dir else None
            )
        self.perf_ledger_path = perf_ledger
        self.perf_verdict: Optional[Dict[str, Any]] = None
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
        """Install the kernel-library compile listener and the run-time
        compile-once watcher (obs/compilewatch.py).  Hot loops that
        received this session guard their dispatch; idempotent.  Imports
        ``ops`` (and torch)."""
        if self.compilewatch is None:
            from trustworthy_dl_tpu_torch.obs.compilewatch import (
                CompileRegistry,
                CompileWatcher,
            )

            self.compiles = CompileRegistry(
                trace=self.trace, registry=self.registry
            ).install()
            self.compilewatch = CompileWatcher(
                self.compiles, trace=self.trace, registry=self.registry,
                dump=self.dump_flight, warmup_calls=warmup_calls,
            )
        return self.compilewatch

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
        """Attach the incident assembler and the durable verdict store.
        Each flight dump then gets a paired ``incident_NNN_<reason>.json``
        assembled from this session's trace/ledger artifacts.  Verdict
        path resolution mirrors the perf ledger: explicit arg, else
        ``TDDL_VERDICT_STORE``, else a run-local ``VERDICTS.jsonl`` beside
        the other artifacts (None ⇒ in-memory incidents only).
        Idempotent."""
        if self.forensics is None:
            from trustworthy_dl_tpu_torch.obs.forensics import \
                IncidentAssembler
            from trustworthy_dl_tpu_torch.obs.verdicts import VerdictStore

            if verdict_path is None:
                verdict_path = os.environ.get("TDDL_VERDICT_STORE") or (
                    os.path.join(self.obs_dir, "VERDICTS.jsonl")
                    if self.obs_dir else None
                )
            if verdict_path:
                self.verdicts = VerdictStore(
                    verdict_path, registry=self.registry, trace=self.trace)
            self.forensics = IncidentAssembler(
                directory or self.obs_dir, trace=self.trace,
                trace_path=self.trace.jsonl_path,
                ledger=self.ledger, perf_ledger=None,
                verdicts=self.verdicts, registry=self.registry,
            )
        return self.forensics

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
            if self.forensics is not None:
                # Enable order is free: a ledger opened after forensics
                # still feeds blast-radius computation.
                self.forensics.ledger = self.ledger
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
        if self.forensics is not None:
            # The paired post-mortem: same index as the flight dump,
            # assembled from whatever the trace has recorded so far.
            self.forensics.assemble(reason, step=step, flight_path=path,
                                    directory=directory, extra=extra)
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
        ``slo_status.json`` — what the obs command pretty-prints."""
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

    def perf_fingerprint(self) -> Dict[str, Any]:
        """The compact perf fingerprint this run appends to the rolling
        ledger (obs/sentinel.py): step time and tokens/s (when the timer
        knows the model) over the steps the cost ledger did not count,
        compile counts/seconds, memory watermark."""
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata
        from trustworthy_dl_tpu_torch.obs.sentinel import fingerprint

        timer = self.step_timer
        mean = timer.steady_step_time_mean
        tokens_per_s = None
        if mean and timer.has_model_info and timer.tokens_per_step \
                and timer.model_kind == "lm":
            tokens_per_s = timer.tokens_per_step / mean
        compiles = self.compiles
        hbm = self.hbm
        if hbm is not None:
            hbm.sweep()
        return fingerprint(
            "session",
            metric=timer.model_kind if timer.has_model_info else None,
            tokens_per_s=tokens_per_s,
            step_time_s=mean,
            phase_fractions=timer.phase_fractions() or None,
            compile_total=compiles.total if compiles else None,
            compile_seconds=(round(compiles.total_seconds, 6)
                             if compiles else None),
            hbm_watermark_bytes=(hbm.watermark_bytes or None)
            if hbm is not None else None,
            run_metadata=run_metadata(),
            extra={"num_steps": timer.num_steps},
        )

    def write_perf(self) -> Optional[Dict[str, Any]]:
        """Sentinel pass + ledger append: compare this run's fingerprint
        against the rolling ledger's noise band (typed
        ``perf_regression`` events on breach), then append the
        fingerprint — verdict stamped on it — as the newest entry."""
        if not self.perf_ledger_path:
            return None
        from trustworthy_dl_tpu_torch.obs.sentinel import PerfLedger, \
            PerfSentinel

        ledger = PerfLedger(self.perf_ledger_path)
        fp = self.perf_fingerprint()
        sentinel = PerfSentinel(ledger, trace=self.trace,
                                registry=self.registry)
        self.perf_verdict = sentinel.check(fp)
        fp["regressed"] = self.perf_verdict["regressed"]
        ledger.append(fp)
        if self.perf_verdict["regressed"]:
            logger.warning("perf sentinel: regression outside the noise "
                           "band — %s", [
                               c["metric"] for c in
                               self.perf_verdict["checks"]
                               if c.get("regressed")
                           ])
        return self.perf_verdict

    def finalize(self) -> None:
        """Final snapshot + report + active-plane artifacts + close the
        trace file.  Idempotent."""
        if self._finalized:
            return
        self._finalized = True
        self.snapshot_metrics()
        self.write_report()
        self.write_slo_status()
        self.write_perf()
        if self.spans is not None and self.obs_dir:
            self.spans.export_chrome(
                os.path.join(self.obs_dir, "trace_events.json")
            )
        if self.ledger is not None:
            self.ledger.close()
        if self.compiles is not None:
            # Stop the process-global dispatcher from feeding a finished
            # session (a dead registry must not count other runs' loads).
            self.compiles.uninstall()
        self.trace.emit(EventType.RUN_END)  # last event in the trace
        self.trace.close()


__all__ = ["ObsSession"]
