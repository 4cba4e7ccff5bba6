"""obs — the port's telemetry plane: metrics registry, structured trace
bus, flight recorder, step-time/MFU reporter, spans, SLO and anomaly
watchers, the per-request attribution ledger, the device-memory headroom
gate, and :class:`ObsSession`, which bundles them for a run.

Counterpart of ``trustworthy_dl_tpu/obs/``: each module is the port's own
copy with the JAX module's names, metric names (``tddl_*``), label sets,
event types, schemas and artifact file names.  Not ported yet (ROADMAP):
``compilewatch``, ``forensics``, ``verdicts``, ``sentinel`` and the cost
ledger of ``hbm``.

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
from trustworthy_dl_tpu_torch.obs.events import (
    EVENT_SCHEMAS,
    EventType,
    TraceBus,
    read_jsonl_rotated,
)
from trustworthy_dl_tpu_torch.obs.hbm import HbmMonitor, live_buffer_bytes
from trustworthy_dl_tpu_torch.obs.meta import run_metadata
from trustworthy_dl_tpu_torch.obs.recorder import FlightRecorder
from trustworthy_dl_tpu_torch.obs.registry import MetricsRegistry, \
    get_registry
from trustworthy_dl_tpu_torch.obs.report import PHASES, StepTimeReporter, \
    mfu_from_throughput, peak_flops_per_chip
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

__all__ = [
    "AnomalyWatcher",
    "AttributionLedger",
    "EVENT_SCHEMAS",
    "EventType",
    "EwmaDetector",
    "FlightRecorder",
    "HbmMonitor",
    "MetricsRegistry",
    "ObsSession",
    "P2Quantile",
    "PHASES",
    "SLORule",
    "SLOWatcher",
    "SpanTracker",
    "StepTimeReporter",
    "StreamingPercentiles",
    "TraceBus",
    "chrome_trace_from_events",
    "default_serve_rules",
    "get_registry",
    "live_buffer_bytes",
    "mfu_from_throughput",
    "peak_flops_per_chip",
    "read_jsonl_rotated",
    "read_ledger",
    "run_metadata",
    "token_hash",
    "verify_attribution",
]
