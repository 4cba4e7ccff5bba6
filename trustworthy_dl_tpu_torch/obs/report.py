"""Step-time breakdown + MFU reporter (``obs_report.json``).

Counterpart of ``trustworthy_dl_tpu/obs/report.py``: named-phase
wall-clock accounting on the host step loop, and model-FLOPs utilization
computed from the model config — attached by the trainer
(``--obs-dir``) and the experiment runner.

Phase semantics (the canonical names in :data:`PHASES`):

* Host-measurable phases — ``data`` (loader + host batch assembly +
  the copy to the card), ``compute`` (dispatch + device execution of the
  step, synced at the packed metrics copy; dispatch only under the async
  host pipeline), ``detection`` (host-side verdict processing /
  incident records, synchronous loop), ``host`` (async-pipeline drain:
  time blocked on the lagged metrics landing + the host bookkeeping —
  the number the pipeline exists to collapse), ``host_sync``,
  ``checkpoint`` — are accounted by :class:`StepTimeReporter` per step.
* Device-internal phases — ``forward``, ``backward``, ``optimizer`` —
  live inside the step's kernels and are only separable in a
  ``torch.profiler`` timeline; ``utils.profiling.phase_annotation`` uses
  the same names so a ``profile_dir`` trace and this report line up.

MFU uses the standard ~6 FLOPs/param/token transformer-training
estimate (fwd 2 + bwd 4; remat recompute not counted, so achieved
hardware FLOPs are a lower bound) against a per-device peak table, the
port's own: NVIDIA's published dense bf16 peak of the H100, matched on
"H100" in ``torch.cuda.get_device_name``.  Unknown devices fall back to
``TDDL_PEAK_FLOPS_PER_CHIP`` or a nominal CPU estimate — the figure is
always computed, and ``peak_flops_source`` says how much to trust it.
With a cost ledger attached (``obs.hbm.CostLedger``, an ``ObsSession``
with an ``obs_dir``), the report also carries ``cost_ledger`` and
``mfu_analyzed``: the ``train_step`` entry's counted FLOPs per step over
the mean time of the other steps (the counted step's wall, counter
overhead included, stands apart as ``counted_step_s``).  The count is the products the step really
launched (``flops_source`` ``"flop-counter+kernel-shapes"``: library ops
through ``torch.utils.flop_counter``, each kernel through its wrapper's
shape count), where JAX's is XLA's ``cost_analysis`` of the lowered step,
which also counts elementwise work.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Deque, Dict, Iterator, Optional

import collections

import numpy as np

#: Canonical phase names — host-measured and trace-timeline both.
PHASES = ("data", "forward", "backward", "optimizer", "detection",
          "host", "host_sync", "compute", "checkpoint", "other")

#: Peak dense bf16 FLOP/s per card by ``torch.cuda.get_device_name``
#: (published peaks; MFU denominators, not guarantees), matched by
#: case-insensitive substring: (token, peak, source).
PEAK_FLOPS_BF16 = (
    ("h100", 989e12, "NVIDIA H100 SXM data sheet, dense bf16 at 700 W"),
)

#: Nominal per-core CPU fallback (order-of-magnitude only) so a CPU-mesh
#: dev run still produces a number instead of a null.
CPU_NOMINAL_FLOPS = 5e10


def peak_flops_per_chip(device_kind: str) -> "tuple[float, str]":
    """(peak FLOP/s, source) for one chip of ``device_kind``."""
    kind = (device_kind or "").lower()
    for token, peak, sheet in PEAK_FLOPS_BF16:
        if token in kind:
            return peak, f"bf16-peak-table:{token} ({sheet})"
    env = os.environ.get("TDDL_PEAK_FLOPS_PER_CHIP")
    if env:
        return float(env), "env:TDDL_PEAK_FLOPS_PER_CHIP"
    return CPU_NOMINAL_FLOPS, "cpu-nominal-estimate"


def mfu_from_throughput(n_params: int, tokens_per_s_per_chip: float,
                        device_kind: Optional[str] = None) -> Dict[str, Any]:
    """MFU block from an already-measured throughput."""
    if device_kind is None:
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata

        device_kind = run_metadata()["device_kind"]
    peak, source = peak_flops_per_chip(device_kind)
    achieved = 6.0 * float(n_params) * float(tokens_per_s_per_chip)
    return {
        "n_params": int(n_params),
        "tokens_per_s_per_chip": float(tokens_per_s_per_chip),
        "model_flops_per_s_per_chip": achieved,
        "peak_flops_per_chip": peak,
        "peak_flops_source": source,
        "device_kind": device_kind,
        "mfu": achieved / peak if peak > 0 else None,
    }


class StepTimeReporter:
    """Lap-based per-step phase accounting.

    Usage (the trainer's loop)::

        reporter.lap("data")       # time since last mark -> "data"
        ... dispatch + sync ...
        reporter.lap("compute")
        ... host verdicts ...
        reporter.lap("detection")
        reporter.finish_step()

    ``lap(name)`` attributes the wall time since the previous mark to
    ``name`` (repeat laps into the same phase accumulate);
    ``finish_step()`` closes the step.  Steps the caller must not
    account (guard-rejected, stale batches) call ``discard_step()``.
    Per-step records are ring-bounded; per-phase aggregates stream into
    the registry as ``tddl_phase_time_seconds{phase=}``.  (End-to-end
    step time already has a registry series —
    ``tddl_<ns>_step_time_seconds`` from ``MetricsCollector.tick`` — so
    the reporter deliberately adds no second one.)
    """

    def __init__(self, registry: Any = None, max_steps: int = 4096):
        self._steps: Deque[Dict[str, float]] = collections.deque(
            maxlen=max_steps
        )
        self._current: Dict[str, float] = {}
        self._laps: list = []          # (phase, start, end) this step
        self._mark: Optional[float] = None
        #: Optional obs.spans.SpanTracker: when attached (ObsSession
        #: enable_spans), finish_step synthesizes a ``train.step`` span
        #: plus one child per recorded lap from the SAME perf_counter
        #: marks the phase accounting used — the trainer loop needs no
        #: extra instrumentation for its timeline.
        self.spans: Any = None
        self.last_step_total: Optional[float] = None
        self.n_params: Optional[int] = None
        self.tokens_per_step: Optional[int] = None
        self.model_kind: str = "lm"
        self.num_chips: int = 1
        #: Optional obs.hbm.CostLedger (ObsSession sets it): its entries
        #: land in the report as ``cost_ledger``, its ``train_step``
        #: FLOPs give ``mfu_analyzed``.
        self.cost_ledger: Any = None
        #: Wall of the step whose dispatch the cost ledger counted (the
        #: counter's overhead is in it); None until that step finishes.
        self.counted_step_s: Optional[float] = None
        self._counting = False
        self._phase_hist = None
        if registry is not None:
            self._phase_hist = registry.histogram(
                "tddl_phase_time_seconds",
                "Per-phase step-time breakdown", labels=("phase",),
            )

    # -- model info (for MFU) ---------------------------------------------

    @property
    def has_model_info(self) -> bool:
        return self.n_params is not None

    def set_model_info(self, n_params: int, tokens_per_step: int,
                       model_kind: str = "lm", num_chips: int = 1) -> None:
        self.n_params = int(n_params)
        self.tokens_per_step = int(tokens_per_step)
        self.model_kind = model_kind
        self.num_chips = max(int(num_chips), 1)

    # -- timing ------------------------------------------------------------

    def lap(self, phase: str) -> None:
        if phase not in PHASES:
            raise ValueError(f"unknown phase {phase!r}; one of {PHASES}")
        now = time.perf_counter()
        if self._mark is not None:
            self._current[phase] = self._current.get(phase, 0.0) \
                + (now - self._mark)
            self._laps.append((phase, self._mark, now))
        self._mark = now

    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Scoped alternative to ``lap`` for non-loop call sites."""
        if name not in PHASES:
            raise ValueError(f"unknown phase {name!r}; one of {PHASES}")
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._current[name] = self._current.get(name, 0.0) + (t1 - t0)
            self._laps.append((name, t0, t1))
            self._mark = time.perf_counter()

    def note_counted(self) -> None:
        """Mark the accumulating step as the one the cost ledger counted:
        :attr:`steady_step_time_mean` leaves it out."""
        self._counting = True

    def finish_step(self, step: Optional[int] = None) -> None:
        record = self._current
        laps = self._laps
        counted, self._counting = self._counting, False
        self._current = {}
        self._laps = []
        self._mark = time.perf_counter()
        if not record:
            return
        record["_total"] = sum(record.values())
        if counted:
            record["_counted"] = 1.0
            self.counted_step_s = record["_total"]
        self.last_step_total = record["_total"]
        self._steps.append(record)
        if self._phase_hist is not None:
            for phase, seconds in record.items():
                if not phase.startswith("_"):
                    self._phase_hist.observe(seconds, phase=phase)
        if self.spans is not None and laps:
            # One root span per accounted step, one child per lap, all
            # from the marks the phase accounting already took — the
            # Chrome timeline and obs_report.json agree by construction.
            root = self.spans.add(
                "train.step", laps[0][1], laps[-1][2], kind="train",
                step=step,
            )
            for phase, t0, t1 in laps:
                self.spans.add(f"train.{phase}", t0, t1, kind="train",
                               parent_id=root.span_id, step=step)

    def discard_step(self) -> None:
        """Drop the accumulating step (rejected/retried — its duration
        would poison the per-phase distribution)."""
        self._current = {}
        self._laps = []
        self._counting = False
        self.last_step_total = None  # nothing fresh for watcher feeds
        self._mark = time.perf_counter()

    @property
    def num_steps(self) -> int:
        return len(self._steps)

    @property
    def step_time_mean(self) -> Optional[float]:
        if not self._steps:
            return None
        return float(np.mean([s["_total"] for s in self._steps]))

    @property
    def steady_step_time_mean(self) -> Optional[float]:
        """The mean over the accounted steps other than the counted one
        (all of them when it is the only one): the analyzed MFU's and the
        perf fingerprint's step time."""
        totals = [s["_total"] for s in self._steps if "_counted" not in s]
        if not totals:
            return self.step_time_mean
        return float(np.mean(totals))

    def phase_fractions(self) -> Dict[str, float]:
        """Per-phase share of the accounted wall time (the fingerprint's
        compact view of the full ``phases`` report block)."""
        steps = list(self._steps)
        if not steps:
            return {}
        grand = sum(s["_total"] for s in steps)
        out: Dict[str, float] = {}
        for phase in PHASES:
            total = sum(s.get(phase, 0.0) for s in steps)
            if total > 0.0 and grand > 0.0:
                out[phase] = total / grand
        return out

    # -- reporting ---------------------------------------------------------

    def report(self) -> Dict[str, Any]:
        """The ``obs_report.json`` payload: per-phase breakdown + MFU."""
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata

        steps = list(self._steps)
        out: Dict[str, Any] = {
            "num_steps": len(steps),
            "run_metadata": run_metadata(),
        }
        if steps:
            totals = np.asarray([s["_total"] for s in steps])
            out["step_time_s"] = {
                "mean": float(totals.mean()),
                "p50": float(np.percentile(totals, 50)),
                "p95": float(np.percentile(totals, 95)),
                "max": float(totals.max()),
            }
            grand_total = float(totals.sum())
            phases: Dict[str, Any] = {}
            for phase in PHASES:
                values = np.asarray([s.get(phase, 0.0) for s in steps])
                total = float(values.sum())
                if total <= 0.0:
                    continue
                phases[phase] = {
                    "total_s": total,
                    "mean_s": float(values.mean()),
                    "p50_s": float(np.percentile(values, 50)),
                    "p95_s": float(np.percentile(values, 95)),
                    "fraction": total / grand_total if grand_total else 0.0,
                }
            out["phases"] = phases
        if self.has_model_info and steps:
            mean_step = out["step_time_s"]["mean"]
            if self.model_kind == "lm" and self.tokens_per_step:
                tokens_per_s = self.tokens_per_step / mean_step
                out["mfu"] = mfu_from_throughput(
                    self.n_params, tokens_per_s / self.num_chips
                )
                out["mfu"]["tokens_per_step"] = self.tokens_per_step
                out["mfu"]["num_chips"] = self.num_chips
            else:
                # No comparable FLOPs-per-sample formula for convs; the
                # report still carries the throughput inputs.
                out["mfu"] = {
                    "n_params": self.n_params,
                    "samples_per_step": self.tokens_per_step,
                    "mfu": None,
                    "note": "MFU defined for LM (6 FLOPs/param/token) "
                            "only",
                }
        ledger = self.cost_ledger
        if ledger:
            out["cost_ledger"] = ledger.to_dict()
            analyzed = self._analyzed_mfu(out)
            if analyzed is not None:
                out["mfu_analyzed"] = analyzed
        return out

    def _analyzed_mfu(self, out: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """MFU from the counted FLOPs of one train step
        (``cost_ledger['train_step']``) over the mean time of the steps
        the counter did not run in (``step_time_s``; the counted step's
        wall is ``counted_step_s``): no 6 FLOPs/param/token model, and it
        covers the remat recompute and the detection products the nominal
        estimate ignores.  The peak denominator is the per-device table
        (its source named)."""
        entry = self.cost_ledger.programs.get("train_step") or {}
        flops = self.cost_ledger.flops("train_step")
        mean_step = self.steady_step_time_mean
        if not flops or not mean_step:
            return None
        from trustworthy_dl_tpu_torch.obs.meta import run_metadata

        device_kind = run_metadata()["device_kind"]
        peak, source = peak_flops_per_chip(device_kind)
        achieved = flops / mean_step / max(self.num_chips, 1)
        return {
            "flops_per_step": flops,
            "flops_source": entry.get("flops_source"),
            "achieved_flops_per_s_per_chip": achieved,
            "peak_flops_per_chip": peak,
            "peak_flops_source": source,
            "num_chips": self.num_chips,
            "mfu": achieved / peak if peak > 0 else None,
            "step_time_s": mean_step,
            "counted_step_s": self.counted_step_s,
            "note": "products only; attention over the full [T, T] "
                    "score matrix, whose causal half the kernels skip",
        }

    def write(self, path: str) -> Dict[str, Any]:
        report = self.report()
        tmp = str(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump(report, f, indent=2)
        os.replace(tmp, path)
        return report
