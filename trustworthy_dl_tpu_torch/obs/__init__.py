"""obs — the port's telemetry plane: metrics registry, structured trace
bus, flight recorder, step-time/MFU reporter, spans, SLO and anomaly
watchers, the per-request attribution ledger, the device-memory headroom
gate and the cost ledger, the compile watcher over the kernel-library
builds, incident forensics and the verdict store, the perf sentinel, and
:class:`ObsSession`, which bundles them for a run.

Counterpart of ``trustworthy_dl_tpu/obs/``, all sixteen modules: each is
the port's own copy with the JAX module's names, metric names
(``tddl_*``), label sets, event types, schemas and artifact file names.
The deliberate differences: a compile is a kernel library's ``nvcc``
build or ``ctypes`` load (``compilewatch``), and analyzed FLOPs count the
products a program launches (``hbm.count_flops``), not XLA's
``cost_analysis``.  No module imports torch when it is imported.

Metric naming convention: ``tddl_<subsystem>_<what>[_unit]`` —
e.g. ``tddl_train_loss``, ``tddl_serve_ttft_seconds``,
``tddl_supervisor_actions_total``.
"""

from trustworthy_dl_tpu_torch.obs.anomaly import AnomalyWatcher, \
    EwmaDetector
from trustworthy_dl_tpu_torch.obs.attribution import (
    AttributionLedger,
    read_ledger,
    token_hash,
    verify_attribution,
)
from trustworthy_dl_tpu_torch.obs.compilewatch import (
    CompileRegistry,
    CompileWatcher,
)
from trustworthy_dl_tpu_torch.obs.events import (
    EVENT_SCHEMAS,
    EventType,
    TraceBus,
    read_jsonl_rotated,
)
from trustworthy_dl_tpu_torch.obs.forensics import (
    IncidentAssembler,
    blast_radius,
    load_incidents,
)
from trustworthy_dl_tpu_torch.obs.hbm import (
    CostLedger,
    HbmMonitor,
    count_flops,
    live_buffer_bytes,
)
from trustworthy_dl_tpu_torch.obs.meta import run_metadata
from trustworthy_dl_tpu_torch.obs.recorder import FlightRecorder
from trustworthy_dl_tpu_torch.obs.registry import MetricsRegistry, \
    get_registry
from trustworthy_dl_tpu_torch.obs.report import PHASES, StepTimeReporter, \
    mfu_from_throughput, peak_flops_per_chip
from trustworthy_dl_tpu_torch.obs.sentinel import (
    PerfLedger,
    PerfSentinel,
    fingerprint as perf_fingerprint,
)
from trustworthy_dl_tpu_torch.obs.session import ObsSession
from trustworthy_dl_tpu_torch.obs.slo import (
    P2Quantile,
    SLORule,
    SLOWatcher,
    StreamingPercentiles,
    default_serve_rules,
)
from trustworthy_dl_tpu_torch.obs.spans import (
    SpanTracker,
    chrome_trace_from_events,
)
from trustworthy_dl_tpu_torch.obs.verdicts import VERDICT_OUTCOMES, \
    VerdictStore

__all__ = [
    "AnomalyWatcher",
    "AttributionLedger",
    "CompileRegistry",
    "CompileWatcher",
    "CostLedger",
    "EVENT_SCHEMAS",
    "EventType",
    "EwmaDetector",
    "FlightRecorder",
    "HbmMonitor",
    "IncidentAssembler",
    "MetricsRegistry",
    "ObsSession",
    "P2Quantile",
    "PHASES",
    "PerfLedger",
    "PerfSentinel",
    "SLORule",
    "SLOWatcher",
    "SpanTracker",
    "StepTimeReporter",
    "StreamingPercentiles",
    "TraceBus",
    "VERDICT_OUTCOMES",
    "VerdictStore",
    "blast_radius",
    "chrome_trace_from_events",
    "count_flops",
    "default_serve_rules",
    "get_registry",
    "live_buffer_bytes",
    "load_incidents",
    "mfu_from_throughput",
    "peak_flops_per_chip",
    "perf_fingerprint",
    "read_jsonl_rotated",
    "read_ledger",
    "run_metadata",
    "token_hash",
    "verify_attribution",
]
