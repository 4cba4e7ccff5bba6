"""Tracing and NaN trapping for training.

Counterpart of ``trustworthy_dl_tpu/utils/profiling.py``, wired into
``DistributedTrainer`` through ``TrainingConfig.profile_dir`` and
``TrainingConfig.debug_nans``:

* :func:`trace` records everything run inside it with ``torch.profiler``
  (CPU activity, and CUDA activity where a card is present) and writes a
  Chrome trace (``chrome://tracing``, Perfetto) under the directory.
* :func:`step_annotation` and :func:`phase_annotation` label a train step
  (``train_step#N``) or a host phase (one of :data:`PHASES`) on the trace's
  timeline through ``torch.profiler.record_function``.  Outside a profiler
  session they are null contexts: the trainer annotates every step, and an
  annotation never costs a run anything or breaks it.
* :func:`enable_nan_debugging` installs a dispatch mode that checks the
  floating inputs and outputs of every op, forward and backward, and
  raises ``FloatingPointError`` naming the first op that made a NaN from
  NaN-free inputs: the counterpart of ``jax_debug_nans``, which raises at
  the primitive that made the NaN (``torch.autograd.set_detect_anomaly``
  would see the backward alone).  A developer mode: it reads every op's
  inputs and outputs back to the host.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, ContextManager, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from trustworthy_dl_tpu_torch.obs.report import PHASES

logger = logging.getLogger(__name__)



@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Profile everything run inside the context into a Chrome trace under
    ``log_dir`` and yield its path; a no-op yielding None when
    ``log_dir`` is falsy, so call sites need no branch."""
    if not log_dir:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    logger.info("profiler: tracing to %s", path)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("profiler: trace written to %s", path)


def _annotation(name: str) -> ContextManager[Any]:
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def step_annotation(step: int) -> ContextManager[Any]:
    """Label one train step on the trace's timeline."""
    return _annotation(f"train_step#{int(step)}")


def phase_annotation(name: str) -> ContextManager[Any]:
    """Label a host phase on the trace's timeline with one of
    :data:`PHASES`."""
    if name not in PHASES:
        raise ValueError(f"unknown phase {name!r}; one of {PHASES}")
    return _annotation(name)


#: Ops that compute nothing: their outputs are uninitialised memory, which
#: may hold NaN bits, or a constant fill (a NaN placeholder that a
#: ``where`` selects only where an input was already NaN, as
#: ``jnp.median`` propagates NaN).
_UNCHECKED = frozenset(
    ("empty", "empty_like", "empty_strided", "new_empty",
     "new_empty_strided", "resize_", "resize_as_", "full", "full_like",
     "new_full", "fill", "fill_", "scalar_tensor"))


def _has_nan(tree: Any) -> bool:
    return any(isinstance(t, torch.Tensor) and t.layout == torch.strided
               and t.device.type != "meta"
               and (t.is_floating_point() or t.is_complex())
               and bool(torch.isnan(t).any()) for t in tree_leaves(tree))


class _NanTrap(TorchDispatchMode):
    """Raises ``FloatingPointError`` at the first op that makes a NaN: a
    floating output holds one and no input held one before the op ran (a
    view of a buffer not yet written, or an op reading an earlier op's
    NaN, is not where the NaN was made)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in _UNCHECKED:
            return func(*args, **kwargs)
        fed_nan = _has_nan((args, kwargs))
        out = func(*args, **kwargs)
        if not fed_nan and _has_nan(out):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {func}")
        return out


_NAN_TRAP: Optional[_NanTrap] = None


def enable_nan_debugging(enabled: bool = True) -> None:
    """Install (or, with ``enabled=False``, remove) the NaN trap for this
    thread and the autograd work it starts: every later op that makes a
    NaN raises ``FloatingPointError`` naming the op."""
    global _NAN_TRAP
    if enabled and _NAN_TRAP is None:
        _NAN_TRAP = _NanTrap()
        _NAN_TRAP.__enter__()
        logger.warning(
            "NaN debugging enabled: every op's output is checked, and the "
            "first op that makes a NaN raises FloatingPointError (debug "
            "runs only: this "
            "also fires on adversarial NaN injections the step would "
            "otherwise gate out)")
    elif not enabled and _NAN_TRAP is not None:
        _NAN_TRAP.__exit__(None, None, None)
        _NAN_TRAP = None


__all__ = ["PHASES", "enable_nan_debugging", "phase_annotation",
           "step_annotation", "trace"]
