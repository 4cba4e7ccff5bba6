"""Build, load and dispatch of the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/torch_kernels/`` under the checkout,
and is keyed by a hash of the sources and flags, so a fresh checkout builds
what it needs and an unchanged one reuses the libraries.  :func:`build`
starts one ``nvcc`` per missing library, all at once.

Dispatch is by device.  A wrapper given CPU tensors runs its kernel's plain
PyTorch version (that is how the tests run here, on machines without a
card); given CUDA tensors it launches the kernel or raises.  There is no
switch between the two and no fallback from a CUDA tensor to the plain
version: a kernel that fails to build or launch is an error.

Two hooks serve the telemetry plane (``obs/``).  :data:`compile_listener`
is called with (stage, library, seconds) for every ``nvcc`` build
(``nvcc_build``) and every library load (``library_load``): the port's
compilations, which ``obs.compilewatch`` meters.  :func:`count_kernel_flops`
opens a tally, to which every wrapper adds its kernel's products where it
launches it (:func:`tally_flops`), for the cost ledger's analyzed FLOPs
(``obs.hbm.count_flops``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable, Iterator, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ERROR_STRING = ([_I], ctypes.c_char_p)

#: Exported C functions per library: name -> (argtypes, restype).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_attention": {
        "tddl_paged_decode": ([_P] * 6 + [_I] * 7 + [_P], _I),
        "tddl_paged_decode_int8": ([_P] * 8 + [_I] * 7 + [_P], _I),
        "tddl_paged_prefill": ([_P] * 6 + [_I] * 8 + [_P], _I),
        "tddl_paged_prefill_int8": ([_P] * 8 + [_I] * 8 + [_P], _I),
        "tddl_trust_stats": ([_P] * 3 + [_I] * 2 + [_P], _I),
        "tddl_verify_tail": ([_P] * 6 + [_I] * 3 + [_P], _I),
        "tddl_error_string": _ERROR_STRING,
    },
    "fused_dequant_matmul": {
        "tddl_dequant_matmul": ([_P] * 4 + [_I] * 3 + [_P], _I),
        "tddl_error_string": _ERROR_STRING,
    },
    "fused_stats": {
        "tddl_fused_moments": ([ctypes.POINTER(_P), ctypes.POINTER(_L), _I,
                                _L, _P, _P, _P], _I),
        "tddl_error_string": _ERROR_STRING,
    },
    "adapter_delta": {
        "tddl_adapter_delta": ([_P] * 7 + [_L] * 3 + [_I] * 6 + [_P], _I),
        "tddl_error_string": _ERROR_STRING,
    },
    "flash_attention": {
        "tddl_flash_fwd": ([_P] * 5 + [_I] * 3 + [_P], _I),
        "tddl_flash_bwd_dq": ([_P] * 7 + [_I] * 3 + [_P], _I),
        "tddl_flash_bwd_dkv": ([_P] * 8 + [_I] * 3 + [_P], _I),
        "tddl_flash_fwd_full": ([_P] * 5 + [_I] * 3 + [_P], _I),
        "tddl_flash_bwd_dq_full": ([_P] * 7 + [_I] * 3 + [_P], _I),
        "tddl_flash_bwd_dkv_full": ([_P] * 8 + [_I] * 3 + [_P], _I),
        "tddl_error_string": _ERROR_STRING,
    },
}

#: Kernel dtype codes shared with the C interface (of the queries and
#: outputs; an int8 pool has entries of its own, not a code).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

#: The one listener of kernel-library compilations, (stage, library,
#: seconds) with stage ``nvcc_build`` or ``library_load``: set by
#: ``obs.compilewatch``, which fans it out to its installed registries.
compile_listener: Optional[Callable[[str, str, float], None]] = None


def note_compile(stage: str, name: str, seconds: float) -> None:
    """Report one build or load of library ``name`` to the listener."""
    listener = compile_listener
    if listener is not None:
        listener(stage, name, seconds)


#: Open FLOP tallies.  Process-wide, not per thread: on the card the
#: autograd engine runs a backward (B3's launches) on its own thread.
_TALLIES: list = []
_TALLY_LOCK = threading.Lock()


@contextmanager
def count_kernel_flops() -> Iterator[Dict[str, int]]:
    """Open a FLOP tally: inside the block every kernel launch adds its
    kernel's products to the yielded dict, by wrapper name (CPU tensors
    launch nothing and add nothing)."""
    tally: Dict[str, int] = {}
    with _TALLY_LOCK:
        _TALLIES.append(tally)
    try:
        yield tally
    finally:
        with _TALLY_LOCK:
            _TALLIES.remove(tally)


def tally_flops(name: str, flops: int) -> None:
    """Add one launch of wrapper ``name`` to every open tally."""
    if not _TALLIES:
        return
    with _TALLY_LOCK:
        for tally in _TALLIES:
            tally[name] = tally.get(name, 0) + int(flops)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built on this machine")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by a hash of every source
    in ``csrc/`` (shared headers included) and the compiler flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all of
    :data:`SIGNATURES`), one ``nvcc`` process each, all started together.
    Returns seconds spent per library built (0.0 when already built); the
    compiler's ``-Xptxas -v`` report lands beside each library as
    ``.log``.  Raises with the compiler's output on failure."""
    names = list(names) if names is not None else list(SIGNATURES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, float] = {}
    running = []
    nvcc = None
    for name in names:
        target = library_path(name)
        if target.exists():
            out[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, target, tmp, proc, time.perf_counter()))
    failures = []
    for name, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        note_compile("nvcc_build", name, out[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    every exported function's ctypes signature declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
            note_compile("library_load", name, time.perf_counter() - t0)
        return lib


def on_cuda(t: torch.Tensor, op: str) -> bool:
    """Device dispatch: False for a CPU tensor (run the plain version),
    True for a CUDA tensor (launch the kernel); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{op}: tensors on {t.device} are not supported "
                     "(cpu runs the plain version, cuda the kernel)")


def check_launch(lib: ctypes.CDLL, err: int, op: str) -> None:
    """Raise when a kernel's C entry returned a CUDA error."""
    if err != 0:
        msg = lib.tddl_error_string(err).decode()
        raise RuntimeError(f"{op}: CUDA launch failed with error {err} "
                           f"({msg})")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the C entries take it."""
    return torch.cuda.current_stream(device).cuda_stream


def kernel_wrappers() -> tuple:
    """Every kernel wrapper of the port (each carries ``launches``)."""
    from trustworthy_dl_tpu_torch.ops import flash_attention, \
        fused_dequant_matmul, fused_stats, paged_attention

    return (paged_attention.KERNEL_WRAPPERS + fused_stats.KERNEL_WRAPPERS
            + flash_attention.KERNEL_WRAPPERS
            + fused_dequant_matmul.KERNEL_WRAPPERS)


def reset_launch_counts() -> None:
    """Set every kernel wrapper's ``launches`` (and a flash wrapper's
    ``launches_full``) back to 0."""
    for fn in kernel_wrappers():
        fn.launches = 0
        if hasattr(fn, "launches_full"):
            fn.launches_full = 0


def launch_counts() -> Dict[str, int]:
    """``launches`` of every kernel wrapper, by wrapper name; a wrapper
    with a non-causal instance (B2, B3) adds ``<name>_full``, the share of
    its launches that went to that instance."""
    out = {}
    for fn in kernel_wrappers():
        out[fn.__name__] = fn.launches
        if hasattr(fn, "launches_full"):
            out[f"{fn.__name__}_full"] = fn.launches_full
    return out


__all__ = [
    "BUILD_DIR", "CSRC", "DTYPE_CODES", "SIGNATURES", "build",
    "check_launch", "compile_listener", "count_kernel_flops",
    "kernel_library", "kernel_wrappers", "launch_counts", "library_path",
    "note_compile", "nvcc_path", "on_cuda",
    "reset_launch_counts", "stream_handle", "tally_flops",
]
