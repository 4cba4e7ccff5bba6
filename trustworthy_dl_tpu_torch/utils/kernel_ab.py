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
(``device_ms``), from a session that recorded every launch.
:func:`graph_ms` times a call's launches replayed as one CUDA graph.
:func:`kernel_names` lists the kernels one call launches (which a library
call picked); :func:`host_us` times the host's enqueue of one call.  Needs
a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import statistics
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from trustworthy_dl_tpu_torch import ops
from trustworthy_dl_tpu_torch.utils.serve_profile import device_us

#: Bytes zeroed before each timed launch: twice the H100's 50 MB L2.
FLUSH_BYTES = 128 * 1024 * 1024


def other_library(source: Path, name: str,
                  defines: Sequence[str] = ()) -> ctypes.CDLL:
    """``source`` (another ``csrc/<name>.cu``) built with the checkout's
    flags (``csrc/`` is on the include path, so it takes the checkout's
    headers) and ``-D`` each of ``defines`` (``"KEY=VALUE"``: a variant
    of a source's compile-time knobs), loaded, with every entry of
    ``ops.SIGNATURES[name]`` declared (an entry the other source lacks,
    such as one added since, is left out: ``hasattr(lib, entry)`` says
    which it has).  The library is keyed by the flags, the source and
    every ``csrc/*.cuh``, as ``ops.library_path`` keys the checkout's."""
    flags = [*ops.NVCC_FLAGS, "-I", str(ops.CSRC),
             *(f"-D{d}" for d in defines)]
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
        if not hasattr(lib, fn):
            continue
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


def graph_ms(fn: Callable, flush: torch.Tensor, reps: int) -> float:
    """Median CUDA-event ms of one replay of ``fn``'s launches captured as
    one CUDA graph, the L2 flushed before each: the card's time for a call
    whose host work (between its launches) would otherwise hold the card
    idle, the gaps between its kernels included.  No profiler, so no
    launch record can go missing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


#: Profiler sessions a device time may take: a session now and then
#: records none of a cluster-launched kernel's runs (seen with B4's
#: ``cudaLaunchKernelEx`` launches), or only some of a library call's
#: kernels, and is then taken again.
PROFILE_ATTEMPTS = 6


def device_ms(fn: Callable, flush: torch.Tensor, reps: int,
              kernel: Optional[str] = None,
              launches: Optional[int] = None) -> float:
    """Device ms per call over ``reps`` calls, the L2 flushed before each
    (profiler): of the kernels whose name holds ``kernel``, else of every
    kernel but the flush's.  A session counts only when it recorded every
    launch: exactly ``launches`` a call, or, where ``launches`` is None (a
    library call, whose kernels are the library's choice), each kernel a
    whole number of times a call and as often as in an earlier session.
    A session that does not count is taken again, up to
    :data:`PROFILE_ATTEMPTS` sessions; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen: List[Dict[str, int]] = []
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and (kernel in e.key if kernel is not None
                      else "FillFunctor" not in e.key)]
        counts = {e.key: e.count for e in found}
        if launches is not None:
            whole = sum(counts.values()) == reps * launches
        else:
            whole = (bool(counts) and counts in seen
                     and all(c % reps == 0 for c in counts.values()))
            seen.append(counts)
        if whole:
            return sum(device_us(e) for e in found) / reps / 1e3
    want = (f"{launches} a call" if launches is not None
            else "the same in two sessions")
    raise RuntimeError(f"the profiler recorded {counts} over {reps} calls "
                       f"of {kernel or 'the call'}, want {want}, in "
                       f"{PROFILE_ATTEMPTS} sessions")


def kernel_names(fn: Callable, flush: torch.Tensor) -> List[str]:
    """The CUDA kernels one call of ``fn`` launches (profiler), by name,
    the flush's left out: which kernels a library call picked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flush.zero_()
        fn()
        torch.cuda.synchronize()
    return sorted(e.key for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "FillFunctor" not in e.key)


def in_turns(arms: Dict[str, Callable], order: Iterable[str],
             flush: torch.Tensor, reps: int,
             launches: Optional[Dict[str, int]] = None
             ) -> Dict[str, List[float]]:
    """``{name}_ms`` and ``{name}_device_ms``, one entry per turn of
    ``name`` in ``order``; ``launches`` gives an arm's kernel launches a
    call where it is known (see :func:`device_ms`)."""
    launches = launches or {}
    record: Dict[str, List[float]] = {}
    for name in order:
        record.setdefault(f"{name}_ms", []).append(
            event_ms(arms[name], flush, reps))
        record.setdefault(f"{name}_device_ms", []).append(
            device_ms(arms[name], flush, reps, launches=launches.get(name)))
    return record


def host_us(fn, calls: int = 200, batches: int = 5) -> float:
    """Median host microseconds to enqueue one call, over ``batches`` runs
    of ``calls`` back-to-back calls (the card drained before each run):
    the launch's cost on the host, which the serve loops wait on."""
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


__all__ = ["FLUSH_BYTES", "PROFILE_ATTEMPTS", "card_line", "device_ms",
           "event_ms", "flush_buffer", "host_us", "in_turns", "kernel_names",
           "other_library"]
