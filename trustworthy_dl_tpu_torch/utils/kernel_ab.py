"""Two builds of one kernel source in one process on one card: the shared
half of ``utils/flash_ab`` and ``utils/prefill_ab``.

:func:`other_library` builds another version of a ``csrc/<name>.cu`` (the
parent commit's, say, from ``git show <commit>:<path>``) with the
checkout's ``nvcc`` flags into a library of its own, whose entries keep
the checkout's C signatures.  :func:`in_turns` times callables in a given
order (this, other, other, this, ...) with the L2 cache flushed before
every launch: the median of per-launch CUDA-event timings (``ms``, which
also holds the host's dispatch whenever the card waits for it) and the
profiler's device time of every kernel of one call but the flush's
(``device_ms``).  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, List

import torch

from trustworthy_dl_tpu_torch import ops
from trustworthy_dl_tpu_torch.utils.serve_profile import device_us

#: Bytes zeroed before each timed launch: twice the H100's 50 MB L2.
FLUSH_BYTES = 128 * 1024 * 1024


def other_library(source: Path, name: str) -> ctypes.CDLL:
    """``source`` (another ``csrc/<name>.cu``) built with the checkout's
    flags (``csrc/`` is on the include path, so it takes the checkout's
    headers), loaded, with every entry of ``ops.SIGNATURES[name]``
    declared.  The library is keyed by the flags, the source and every
    ``csrc/*.cuh``, as ``ops.library_path`` keys the checkout's."""
    flags = [*ops.NVCC_FLAGS, "-I", str(ops.CSRC)]
    digest = hashlib.sha256(" ".join(flags).encode() + source.read_bytes())
    for header in sorted(ops.CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = ops.BUILD_DIR / f"ab_{name}_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([ops.nvcc_path(), *flags, "-o", str(tmp),
                              str(source)], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{out.stdout}"
                               f"{out.stderr}")
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for fn, (argtypes, restype) in ops.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def flush_buffer(device: torch.device) -> torch.Tensor:
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)


def event_ms(fn: Callable, flush: torch.Tensor, reps: int) -> float:
    """Median CUDA-event ms of one call, each launch timed alone after the
    L2 flush."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn: Callable, flush: torch.Tensor, reps: int) -> float:
    """Device ms per call of every kernel but the flush's (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(device_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and "FillFunctor" not in e.key) / reps / 1e3


def in_turns(arms: Dict[str, Callable], order: Iterable[str],
             flush: torch.Tensor, reps: int) -> Dict[str, List[float]]:
    """``{name}_ms`` and ``{name}_device_ms``, one entry per turn of
    ``name`` in ``order``."""
    record: Dict[str, List[float]] = {}
    for name in order:
        record.setdefault(f"{name}_ms", []).append(
            event_ms(arms[name], flush, reps))
        record.setdefault(f"{name}_device_ms", []).append(
            device_ms(arms[name], flush, reps))
    return record


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


__all__ = ["FLUSH_BYTES", "card_line", "device_ms", "event_ms",
           "flush_buffer", "in_turns", "other_library"]
