"""Live device-memory accounting, the pool headroom gate and the
per-program cost ledger.

Counterpart of ``trustworthy_dl_tpu/obs/hbm.py``: *how much device memory
is live right now* (and at peak), whether a pool the serving engine is
about to allocate fits, and what each named program costs.

* :func:`live_buffer_bytes` — the caching allocator's allocated bytes
  (``torch.cuda.memory_allocated``) of every CUDA device; ``{}`` on a
  machine without CUDA.  (The JAX package sums ``jax.live_arrays()``; the
  allocator's count is the port's counterpart of "live".)
  :class:`HbmMonitor` turns sweeps into ``tddl_hbm_live_bytes{device=}``
  gauges, a monotone ``tddl_hbm_watermark_bytes{device=}`` watermark,
  typed ``hbm_sweep`` events, and a **headroom gate**: the serve engine
  calls :meth:`HbmMonitor.admit` before allocating its paged KV pool and
  its adapter pool — low headroom shrinks the growth instead of
  discovering the out-of-memory error at allocation time
  (``hbm_pressure`` event + ``tddl_hbm_pressure_total``).
* :func:`device_budget_bytes` — ``TDDL_HBM_BUDGET_BYTES``, else the
  card's ``total_memory``, else None (no CUDA: the gate always admits,
  as the JAX gate does on a CPU backend).

* :class:`CostLedger` — named programs -> cost blocks, stamped into
  ``obs_report.json`` (the report's ``cost_ledger`` and its
  ``mfu_analyzed`` read ``train_step``).  The JAX ledger asks XLA
  (``lower().cost_analysis()``); the port cannot lower a program, so it
  counts the work a program launches (:func:`count_flops`): library ops
  through ``torch.utils.flop_counter.FlopCounterMode``, and each
  hand-written kernel, which the counter cannot see, through its
  wrapper's shape count (``ops.count_kernel_flops``).  Both count
  products only — XLA's figure also counts elementwise work, so the two
  packages' numbers differ by design — and ``bytes_accessed`` is None
  (the port has no byte count of a whole program).  The trainer counts
  its first step, which it runs anyway; ``ServingEngine.analyze_programs``
  works its programs' counts out from the engine's shapes.

``torch`` is imported only inside functions, so importing ``obs`` never
initialises CUDA.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from trustworthy_dl_tpu_torch.obs.events import EventType

logger = logging.getLogger(__name__)


def live_buffer_bytes() -> Dict[str, int]:
    """Allocated bytes of the caching allocator per CUDA device (keys
    ``cuda:<i>``); ``{}`` when CUDA is not available."""
    import torch

    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": int(torch.cuda.memory_allocated(i))
            for i in range(torch.cuda.device_count())}


def device_budget_bytes() -> Optional[int]:
    """Per-device memory budget: ``TDDL_HBM_BUDGET_BYTES`` wins, else
    the first card's ``total_memory``, else None (unknown: no CUDA)."""
    env = os.environ.get("TDDL_HBM_BUDGET_BYTES")
    if env:
        return int(float(env))
    import torch

    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return None


class HbmMonitor:
    """Watermark gauges + the pool-growth headroom gate."""

    def __init__(self, registry: Any = None, trace: Any = None,
                 budget_bytes: Optional[int] = None,
                 reserve_fraction: float = 0.0):
        # ``reserve_fraction``: slack kept free even when admitting (a
        # pool sized to the last byte leaves nothing for activations).
        self.trace = trace
        self.budget_bytes = (int(budget_bytes) if budget_bytes is not None
                             else device_budget_bytes())
        self.reserve_fraction = float(reserve_fraction)
        self.watermark: Dict[str, int] = {}
        self.last_sweep: Dict[str, int] = {}
        #: Headroom measured by the LAST admit()/headroom_bytes() call —
        #: a denied caller sizes its shrunk allocation from THIS value,
        #: so the deny decision and the re-size use one sweep (a second
        #: sweep could report different headroom than the gate enforced).
        self.last_headroom: Optional[int] = None
        self.pressure_denials = 0
        self._live_gauge = None
        self._mark_gauge = None
        self._pressure_metric = None
        if registry is not None:
            self._live_gauge = registry.gauge(
                "tddl_hbm_live_bytes",
                "Live allocated device bytes, by device (last sweep)",
                labels=("device",),
            )
            self._mark_gauge = registry.gauge(
                "tddl_hbm_watermark_bytes",
                "Peak live allocated device bytes ever swept, by device",
                labels=("device",),
            )
            self._pressure_metric = registry.counter(
                "tddl_hbm_pressure_total",
                "Pool growths denied/shrunk by the headroom gate",
            )

    # -- sweeps ------------------------------------------------------------

    def sweep(self, step: Optional[int] = None,
              emit: bool = False) -> Dict[str, Any]:
        """One live-buffer sweep: update gauges + watermark; optionally
        emit a typed ``hbm_sweep`` event (sweeps can be frequent — the
        event is for cadence points, the gauges for dashboards)."""
        per_device = live_buffer_bytes()
        self.last_sweep = per_device
        for device, nbytes in per_device.items():
            peak = max(self.watermark.get(device, 0), nbytes)
            self.watermark[device] = peak
            if self._live_gauge is not None:
                self._live_gauge.set(float(nbytes), device=device)
                self._mark_gauge.set(float(peak), device=device)
        summary = {
            "per_device": per_device,
            "total_bytes": sum(per_device.values()),
            "watermark_bytes": self.watermark_bytes,
        }
        if emit and self.trace is not None:
            self.trace.emit(EventType.HBM_SWEEP, step=step,
                            live_bytes=summary["total_bytes"],
                            watermark_bytes=summary["watermark_bytes"],
                            devices=len(per_device))
        return summary

    @property
    def watermark_bytes(self) -> int:
        """Peak single-device live bytes (the OOM-relevant number)."""
        return max(self.watermark.values()) if self.watermark else 0

    def headroom_bytes(self) -> Optional[int]:
        """Budget minus the busiest device's CURRENT live bytes (after a
        fresh sweep), minus the reserve.  None when no budget is known."""
        if self.budget_bytes is None:
            self.last_headroom = None
            return None
        self.sweep()
        used = max(self.last_sweep.values()) if self.last_sweep else 0
        reserve = int(self.budget_bytes * self.reserve_fraction)
        self.last_headroom = self.budget_bytes - used - reserve
        return self.last_headroom

    # -- the growth gate ---------------------------------------------------

    def admit(self, requested_bytes: int, what: str = "",
              step: Optional[int] = None) -> bool:
        """May ``requested_bytes`` of new device allocation proceed?
        Unknown budget → always True (the gate never blocks dev boxes);
        a denial emits ``hbm_pressure`` so the refusal is attributable."""
        headroom = self.headroom_bytes()
        if headroom is None or requested_bytes <= headroom:
            return True
        self.pressure_denials += 1
        logger.warning(
            "HBM pressure: %s wants %d bytes but headroom is %d "
            "(budget %d, reserve %.0f%%) — growth denied",
            what or "allocation", requested_bytes, headroom,
            self.budget_bytes, self.reserve_fraction * 100,
        )
        if self._pressure_metric is not None:
            self._pressure_metric.inc()
        if self.trace is not None:
            self.trace.emit(EventType.HBM_PRESSURE, step=step,
                            requested_bytes=int(requested_bytes),
                            headroom_bytes=int(headroom),
                            what=what or None)
        return False


# ---------------------------------------------------------------------------
# Per-program cost ledger
# ---------------------------------------------------------------------------

#: How the port's analyzed FLOPs are counted (``flops_source``).
FLOPS_SOURCE = "flop-counter+kernel-shapes"


@contextmanager
def count_flops() -> Iterator[Dict[str, Any]]:
    """Count the products of the work dispatched inside the block; the
    yielded dict is filled on exit with ``flops`` (their sum),
    ``library_flops`` (``FlopCounterMode``), ``kernel_flops`` (by kernel
    wrapper, from the launches' shapes), ``flops_source`` and
    ``bytes_accessed`` (None).  On the CPU the wrappers run their plain
    twins, which the counter counts instead (each twin's count equals its
    kernel's shape count), so the total does not depend on the device.
    Counting changes no result: the counter only reads each op's shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from trustworthy_dl_tpu_torch import ops

    cost: Dict[str, Any] = {}
    counter = FlopCounterMode(display=False)
    with ops.count_kernel_flops() as kernels, counter:
        yield cost
    library = int(counter.get_total_flops())
    kernel = int(sum(kernels.values()))
    cost.update(flops=float(library + kernel), library_flops=library,
                kernel_flops=dict(sorted(kernels.items())),
                flops_source=FLOPS_SOURCE, bytes_accessed=None)


class CostLedger:
    """Named programs -> cost blocks, stamped into ``obs_report.json``
    (StepTimeReporter reads ``programs``)."""

    def __init__(self) -> None:
        self.programs: Dict[str, Dict[str, Any]] = {}

    def note(self, name: str, cost: Dict[str, Any]) -> None:
        self.programs[str(name)] = dict(cost)

    @contextmanager
    def count(self, name: str) -> Iterator[Dict[str, Any]]:
        """Run the block under :func:`count_flops` and note its cost as
        ``name``."""
        with count_flops() as cost:
            yield cost
        self.note(name, cost)

    def flops(self, name: str) -> Optional[float]:
        entry = self.programs.get(name)
        if entry and entry.get("flops"):
            return float(entry["flops"])
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {name: dict(entry)
                for name, entry in sorted(self.programs.items())}

    def __bool__(self) -> bool:
        return bool(self.programs)


__all__ = ["CostLedger", "FLOPS_SOURCE", "HbmMonitor", "count_flops",
           "device_budget_bytes", "live_buffer_bytes"]
