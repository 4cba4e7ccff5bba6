"""Build, load and dispatch of the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into the kernel cache (``utils/compile_cache.py``:
``build/torch_kernels/`` under the checkout unless the cache was pointed
elsewhere), and is keyed by a hash of the sources and flags, so a fresh
checkout builds what it needs and an unchanged one reuses the libraries.
:func:`build` starts one ``nvcc`` per missing library, all at once.

Dispatch is by device.  A wrapper given CPU tensors runs its kernel's plain
PyTorch version (that is how the tests run here, on machines without a
card); given CUDA tensors it launches the kernel or raises.  There is no
switch between the two and no fallback from a CUDA tensor to the plain
version: a kernel that fails to build or launch is an error.

Two hooks serve the telemetry plane (``obs/``).  :func:`note_compile`
(``compile_cache.note_compile``) reports (stage, library, seconds) for
every ``nvcc`` build (``nvcc_build``) and every library load
(``library_load``): the port's compilations, which ``obs.compilewatch``
meters.  :func:`count_kernel_flops` opens a tally, to which every wrapper
adds its kernel's products where it launches it (:func:`tally_flops`),
for the cost ledger's analyzed FLOPs (``obs.hbm.count_flops``).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

import torch

from trustworthy_dl_tpu_torch.utils import compile_cache
from trustworthy_dl_tpu_torch.utils.compile_cache import note_compile

CSRC = Path(__file__).resolve().parent / "csrc"
#: The kernel cache's default directory (``compile_cache.DEFAULT_DIR``).
BUILD_DIR = compile_cache.DEFAULT_DIR
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
    """Where ``csrc/<name>.cu`` builds to in the kernel cache: keyed by a
    hash of every source in ``csrc/`` (shared headers included) and the
    compiler flags."""
    sources = sorted(p for p in CSRC.iterdir()
                     if p.suffix in (".cu", ".cuh"))
    return compile_cache.library_path(name, sources, NVCC_FLAGS)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library among ``names`` (default: all of
    :data:`SIGNATURES`), one ``nvcc`` process each, all started together.
    Returns seconds spent per library built (0.0 when already built); the
    compiler's ``-Xptxas -v`` report lands beside each library as
    ``.log``.  Raises with the compiler's output on failure."""
    names = list(names) if names is not None else list(SIGNATURES)

    def command(name: str):
        return lambda tmp: [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                            str(CSRC / f"{name}.cu")]

    return compile_cache.build_libraries(
        [(name, library_path(name), command(name)) for name in names],
        "nvcc_build")


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use, with
    every exported function's ctypes signature declared."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = compile_cache.load_library(
                name, library_path(name), SIGNATURES[name])
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
    "check_launch", "count_kernel_flops",
    "kernel_library", "kernel_wrappers", "launch_counts", "library_path",
    "note_compile", "nvcc_path", "on_cuda",
    "reset_launch_counts", "stream_handle", "tally_flops",
]
