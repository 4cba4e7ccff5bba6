"""Persistent kernel-build cache: where the port's compiled libraries are
built and loaded from.

Counterpart of ``trustworthy_dl_tpu/utils/compile_cache.py``.  The port has
no XLA: its "compiles" are the hand-written kernels' libraries, each a
``nvcc`` build of ``ops/csrc/<name>.cu`` (stage ``nvcc_build``), and the
native host tier's ``g++`` build of ``native/dataloader.cpp`` (stage
``gxx_build``), each followed by a ``ctypes`` load (stage
``library_load``).  So the counterpart of XLA's persistent cache is the
directory those libraries build into and load from.  Each library's file
name carries a hash of its sources and compiler flags, so a shared
directory is safe, and a process whose directory already holds a library
only loads it.

Off by default as in JAX: the libraries then build into
:data:`DEFAULT_DIR`, ``build/torch_kernels/`` under the checkout (listed in
``.gitignore``).  :func:`enable_persistent_cache` points the cache at
another directory (``TrainingConfig.compilation_cache_dir``, ``cli train|
serve --compile-cache``); libraries already loaded stay loaded.

The build helper every library shares lives here too:
:func:`library_path` (the hash key, computed once per process per cache
directory), :func:`build_libraries` (every compiler started together, each
writing a per-process tmp file that ``os.replace`` moves into place, so a
concurrent process never loads a half-written library), :func:`load_library`
and :func:`note_compile`, the one hook the compile watcher
(``obs/compilewatch.py``) listens on.

Host-only: imports no torch.  ``python -m
trustworthy_dl_tpu_torch.utils.compile_cache DIR`` warms ``DIR``: it builds
and loads every kernel library (on a machine with ``nvcc``) and the native
library, and prints one JSON line of what the compile hook saw.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

#: Where libraries build while no cache directory was enabled.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

_ENABLED_DIR: Optional[str] = None
_DIGESTS: Dict[Tuple[str, Tuple[str, ...], Tuple[str, ...]], str] = {}
_DIGEST_LOCK = threading.Lock()

#: The one listener of library compilations, (stage, library, seconds)
#: with stage ``nvcc_build``, ``gxx_build`` or ``library_load``: set by
#: ``obs.compilewatch``, which fans it out to its installed registries.
compile_listener: Optional[Callable[[str, str, float], None]] = None


def enable_persistent_cache(cache_dir: str) -> str:
    """Point the kernel-build cache at ``cache_dir`` (created if missing).
    Idempotent; re-pointing at a different directory logs the switch.
    Returns the active cache dir."""
    global _ENABLED_DIR

    cache_dir = os.path.abspath(str(cache_dir))
    if _ENABLED_DIR == cache_dir:
        return cache_dir
    os.makedirs(cache_dir, exist_ok=True)
    if _ENABLED_DIR is not None:
        logger.info("kernel cache re-pointed: %s -> %s", _ENABLED_DIR,
                    cache_dir)
    else:
        logger.info("persistent kernel cache enabled at %s", cache_dir)
    _ENABLED_DIR = cache_dir
    return cache_dir


def active_cache_dir() -> Optional[str]:
    """The directory enabled via :func:`enable_persistent_cache`, or None
    when the cache was never switched on by this module."""
    return _ENABLED_DIR


def cache_dir() -> Path:
    """Where libraries build and load from now: the enabled directory,
    else :data:`DEFAULT_DIR`."""
    return Path(_ENABLED_DIR) if _ENABLED_DIR is not None else DEFAULT_DIR


def note_compile(stage: str, name: str, seconds: float) -> None:
    """Report one build or load of library ``name`` to the listener."""
    listener = compile_listener
    if listener is not None:
        listener(stage, name, seconds)


def library_path(name: str, sources: Sequence[Path],
                 flags: Sequence[str]) -> Path:
    """Where library ``name`` builds to in the active cache directory:
    ``lib<name>_<hash>.so``, the hash over the compiler flags and every
    source's name and bytes.  The sources are read once per process per
    cache directory."""
    base = cache_dir()
    key = (str(base), tuple(str(p) for p in sources), tuple(flags))
    with _DIGEST_LOCK:
        digest = _DIGESTS.get(key)
        if digest is None:
            h = hashlib.sha256(" ".join(flags).encode())
            for path in sources:
                h.update(Path(path).name.encode())
                h.update(Path(path).read_bytes())
            digest = _DIGESTS[key] = h.hexdigest()[:16]
    return base / f"lib{name}_{digest}.so"


#: One library to build: (name, target path, the compiler command given
#: the path it writes).
BuildJob = Tuple[str, Path, Callable[[Path], List[str]]]


def build_libraries(jobs: Sequence[BuildJob], stage: str
                    ) -> Dict[str, float]:
    """Build every job whose target is missing, one compiler process each,
    all started together; each writes a per-process tmp file that
    ``os.replace`` moves onto its target, and its compiler output lands
    beside the target as ``.log``.  Returns seconds per library (0.0 when
    it was there already); notes ``stage`` for each build.  Raises with
    the compiler's output when one fails."""
    out: Dict[str, float] = {}
    running = []
    for name, target, command in jobs:
        if target.exists():
            out[name] = 0.0
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = command(tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as exc:
            raise RuntimeError(f"{cmd[0]} could not start for {name} "
                               f"({exc})") from exc
        running.append((name, target, tmp, proc, time.perf_counter()))
    failures = []
    for name, target, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{stage} failed for {name} "
                            f"(rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        note_compile(stage, name, out[name])
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def load_library(name: str, path: Path,
                 signatures: Mapping[str, tuple]) -> ctypes.CDLL:
    """``ctypes`` load of a built library with every exported function's
    (argtypes, restype) declared; notes ``library_load``."""
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    note_compile("library_load", name, time.perf_counter() - t0)
    return lib


def warm(directory: str, kernels: bool = True) -> Dict[str, object]:
    """Point the cache at ``directory``, then build (where missing) and
    load the native library and, with ``kernels``, every kernel library.
    Returns the compile events the hook saw, by stage, and the seconds of
    each step."""
    global compile_listener

    from trustworthy_dl_tpu_torch import native

    events: List[Tuple[str, str, float]] = []
    previous = compile_listener

    def record(stage: str, name: str, seconds: float) -> None:
        events.append((stage, name, seconds))
        if previous is not None:
            previous(stage, name, seconds)

    compile_listener = record
    try:
        enable_persistent_cache(directory)
        seconds = {}
        t0 = time.perf_counter()
        native.library()
        seconds["native"] = time.perf_counter() - t0
        if kernels:
            from trustworthy_dl_tpu_torch import ops

            t0 = time.perf_counter()
            ops.build()
            for name in ops.SIGNATURES:
                ops.kernel_library(name)
            seconds["kernels"] = time.perf_counter() - t0
    finally:
        compile_listener = previous
    by_stage: Dict[str, List[str]] = {}
    for stage, name, _ in events:
        by_stage.setdefault(stage, []).append(name)
    return {"cache_dir": str(cache_dir()), "events": by_stage,
            "event_seconds": {f"{stage}:{name}": s
                              for stage, name, s in events},
            "seconds": seconds}


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.utils.compile_cache",
        description="Warm a kernel-build cache directory: build and load "
                    "the native library and every kernel library, and "
                    "print the compile events as one JSON line.")
    parser.add_argument("directory")
    parser.add_argument("--native-only", action="store_true",
                        help="skip the CUDA kernel libraries (no nvcc)")
    args = parser.parse_args(argv)
    # Under ``python -m`` this file runs as ``__main__``, a second copy of
    # the module: the hook the libraries report to is the imported one's.
    from trustworthy_dl_tpu_torch.utils import compile_cache

    print(json.dumps(compile_cache.warm(args.directory,
                                        kernels=not args.native_only)),
          flush=True)
    return 0


__all__ = ["DEFAULT_DIR", "active_cache_dir", "build_libraries",
           "cache_dir", "compile_listener", "enable_persistent_cache",
           "library_path", "load_library", "note_compile", "warm"]


if __name__ == "__main__":
    sys.exit(main())
