"""Compile watcher: every kernel-library compilation as a typed, metered
event, and the compile-once contract enforced at run time.

Counterpart of ``trustworthy_dl_tpu/obs/compilewatch.py``.  The port has no
XLA and no ``torch.compile``: its compilations are the hand-written
kernels' libraries, which ``trustworthy_dl_tpu_torch/ops/__init__.py``
builds with ``nvcc`` (stage ``nvcc_build``) and loads with ``ctypes``
(stage ``library_load``) at first use.  A serving engine loads every
library its configuration can launch when it is built, and a trainer's
first step loads what the step launches, so a load inside a hot loop after
its first call is the port's recompile storm: a library dropped and
reloaded, or a code path that reaches a kernel no earlier call reached.

Two pieces, as in JAX:

* :class:`CompileRegistry` — a listener of the ``ops`` compile hook that
  records every build and load in the process: per-stage counts and wall
  time (``tddl_compile_total`` / ``tddl_compile_seconds{stage=}``) and one
  typed ``compile`` trace event per library load.  The hook
  (``ops.compile_listener``) is process-global, so ONE module-level
  dispatcher is set lazily and fans out to the currently installed
  registries; ``install()`` / ``uninstall()`` are cheap and test-safe.
  ``total`` counts library loads (a build is always followed by its load,
  so counting both would count one library twice), as JAX's counts
  backend compiles and records its other stages per stage.
* :class:`CompileWatcher` — the run-time contract.  A hot loop wraps its
  dispatch in ``watcher.guard(scope)``; loads inside the first
  ``warmup_calls`` guarded calls of a scope are warmup, any load after that
  is a **storm**: a typed ``compile_storm`` event, a
  ``tddl_compile_storms_total{scope=}`` bump, and a once-per-episode flight
  dump (consecutive storming calls are one episode; a clean guarded call
  closes it).  A legitimate rebuild (an elastic topology change rebuilding
  the train step) calls ``reset(scope)`` so the next load is warmup again.

Host-only at import time: ``ops`` (and with it torch) is imported lazily
inside ``install()``.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

from trustworthy_dl_tpu_torch.obs.events import EventType

logger = logging.getLogger(__name__)

#: The stage that counts as "a compile": one kernel library becoming
#: loaded in the process (built first when it was missing).
COMPILE_STAGE = "library_load"
#: Every stage the ``ops`` hook reports.
COMPILE_STAGES = ("nvcc_build", "library_load")

_DISPATCH_LOCK = threading.Lock()
_ACTIVE: "set[CompileRegistry]" = set()
_DISPATCHER_INSTALLED = False


def _dispatch_compile(stage: str, library: str, seconds: float) -> None:
    for registry in list(_ACTIVE):
        registry._on_compile(stage, seconds)


def _install_dispatcher() -> None:
    global _DISPATCHER_INSTALLED
    with _DISPATCH_LOCK:
        if _DISPATCHER_INSTALLED:
            return
        from trustworthy_dl_tpu_torch import ops

        ops.compile_listener = _dispatch_compile
        _DISPATCHER_INSTALLED = True


class CompileRegistry:
    """Process-wide kernel-library compilation record for one obs session.

    ``total`` / ``total_seconds`` count library loads only — the number a
    storm moves; per-stage counts (``nvcc_build``, ``library_load``) live
    in ``by_stage`` and the ``tddl_compile_seconds{stage=}`` counter.
    """

    def __init__(self, trace: Any = None, registry: Any = None,
                 keep: int = 256):
        self.trace = trace
        self._lock = threading.Lock()
        self.total = 0
        self.total_seconds = 0.0
        self.by_stage: Dict[str, Dict[str, float]] = {}
        self.recent: collections.deque = collections.deque(maxlen=keep)
        self._installed = False
        self._count_metric = None
        self._seconds_metric = None
        if registry is not None:
            self._count_metric = registry.counter(
                "tddl_compile_total",
                "Kernel libraries loaded, observed through the ops hook",
            )
            self._seconds_metric = registry.counter(
                "tddl_compile_seconds",
                "Wall time spent building and loading kernel libraries, "
                "by stage",
                labels=("stage",),
            )

    # -- lifecycle ---------------------------------------------------------

    def install(self) -> "CompileRegistry":
        """Start receiving compile events (idempotent).  Imports ops."""
        _install_dispatcher()
        with _DISPATCH_LOCK:
            _ACTIVE.add(self)
        self._installed = True
        return self

    def uninstall(self) -> None:
        with _DISPATCH_LOCK:
            _ACTIVE.discard(self)
        self._installed = False

    # -- listener ----------------------------------------------------------

    def _on_compile(self, stage: str, seconds: float) -> None:
        if stage not in COMPILE_STAGES:
            return
        is_compile = stage == COMPILE_STAGE
        with self._lock:
            entry = self.by_stage.setdefault(stage,
                                             {"count": 0, "seconds": 0.0})
            entry["count"] += 1
            entry["seconds"] += float(seconds)
            if is_compile:
                self.total += 1
                self.total_seconds += float(seconds)
                self.recent.append((stage, float(seconds)))
        if self._seconds_metric is not None:
            self._seconds_metric.inc(float(seconds), stage=stage)
        if is_compile:
            if self._count_metric is not None:
                self._count_metric.inc()
            if self.trace is not None:
                self.trace.emit(EventType.COMPILE, key=stage,
                                seconds=float(seconds))

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "total": self.total,
                "seconds": round(self.total_seconds, 6),
                "by_stage": {k: {"count": int(v["count"]),
                                 "seconds": round(v["seconds"], 6)}
                             for k, v in sorted(self.by_stage.items())},
            }


class _ScopeState:
    __slots__ = ("calls", "storms", "episode_open")

    def __init__(self) -> None:
        self.calls = 0
        self.storms = 0
        self.episode_open = False


class CompileWatcher:
    """Turns the compile-once pins into a run-time contract (module
    docstring).  ``dump`` has the :meth:`ObsSession.dump_flight`
    signature; every storm EPISODE produces exactly one dump."""

    def __init__(self, compiles: CompileRegistry, trace: Any = None,
                 registry: Any = None, dump: Any = None,
                 warmup_calls: int = 1):
        if warmup_calls < 1:
            raise ValueError("warmup_calls must be >= 1")
        self.compiles = compiles
        self.trace = trace
        self.dump = dump
        self.warmup_calls = warmup_calls
        self._scopes: Dict[str, _ScopeState] = {}
        self._lock = threading.Lock()
        self._storm_metric = None
        if registry is not None:
            self._storm_metric = registry.counter(
                "tddl_compile_storms_total",
                "Post-warmup recompiles inside a guarded hot loop",
                labels=("scope",),
            )

    def _scope(self, name: str) -> _ScopeState:
        with self._lock:
            state = self._scopes.get(name)
            if state is None:
                state = self._scopes[name] = _ScopeState()
            return state

    def reset(self, scope: str) -> None:
        """Back to cold: the next load in ``scope`` is warmup again (call
        at LEGITIMATE rebuild points — elastic topology changes — so a
        planned reload is not a storm)."""
        with self._lock:
            self._scopes.pop(scope, None)

    @property
    def storm_total(self) -> int:
        with self._lock:
            return sum(s.storms for s in self._scopes.values())

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {name: {"calls": s.calls, "storms": s.storms,
                           "warm": s.calls >= self.warmup_calls}
                    for name, s in sorted(self._scopes.items())}

    @contextmanager
    def guard(self, scope: str, step: Optional[int] = None
              ) -> Iterator[None]:
        """Wrap ONE dispatch of a compile-once program.  Loads inside the
        first ``warmup_calls`` guarded calls are absorbed; later ones
        storm."""
        before = self.compiles.total
        try:
            yield
        finally:
            self._after(scope, before, step)

    def _after(self, scope: str, before: int,
               step: Optional[int]) -> None:
        state = self._scope(scope)
        delta = self.compiles.total - before
        warm = state.calls >= self.warmup_calls
        state.calls += 1
        if delta <= 0:
            state.episode_open = False
            return
        if not warm:
            return
        state.storms += delta
        logger.warning(
            "compile storm: %d library load(s) inside the %r loop after "
            "warmup (step %s) — the compile-once contract is broken",
            delta, scope, step,
        )
        if self._storm_metric is not None:
            self._storm_metric.inc(delta, scope=scope)
        if self.trace is not None:
            self.trace.emit(EventType.COMPILE_STORM, step=step,
                            scope=scope, compiles=int(delta))
        if not state.episode_open:
            state.episode_open = True
            if self.dump is not None:
                self.dump("compile_storm", step=step,
                          extra={"scope": scope, "compiles": int(delta)})


_NULL_CONTEXT = contextlib.nullcontext()


def guarded(watcher: Optional[CompileWatcher], scope: str,
            step: Optional[int] = None):
    """``watcher.guard(...)`` or a shared no-op context — the one-liner
    hot loops use so the unwatched path stays allocation-free."""
    if watcher is None:
        return _NULL_CONTEXT
    return watcher.guard(scope, step=step)


__all__ = ["COMPILE_STAGE", "COMPILE_STAGES", "CompileRegistry",
           "CompileWatcher", "guarded"]
