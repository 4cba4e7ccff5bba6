"""The C++ host tier: the data path's hot loops, with ctypes bindings.

Counterpart of ``trustworthy_dl_tpu/native``.  ``dataloader.cpp`` holds
seven C entries: splitmix64 streams (``tddl_splitmix_fill``), the learnable
synthetic token chain (``tddl_synthetic_tokens``), Fisher-Yates epoch
permutations (``tddl_permutation``), multi-threaded row and window gathers
(``tddl_gather_rows``, ``tddl_window_gather``) and the byte-level BPE
encoder's merge loop over a batch of words (``tddl_bpe_load``,
``tddl_bpe_encode``).  The library builds at first use with ``g++ -O3
-shared -fPIC -std=c++17 -lpthread`` into the kernel cache
(``utils/compile_cache.py``), keyed by a hash of the source and flags, and
loads with ``ctypes``; the build and the load are reported to the compile
hook (stages ``gxx_build`` and ``library_load``) as the CUDA kernels' are.

Unlike the JAX package there is no fallback and no switch: a missing
``g++``, a failed build or a failed load raises with the compiler's output,
as ``ops.build`` does.  The numpy twins (``*_plain``) compute the same
arithmetic, bit for bit; they are what the tests hold the C entries
against, and run only where called by name.

Host-only: imports numpy and ctypes, never torch.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from trustworthy_dl_tpu_torch.utils import compile_cache

SOURCE = Path(__file__).resolve().parent / "dataloader.cpp"
LIBRARY = "tddl_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
#: Threads of the row and window gathers (JAX's; below 64 rows they copy
#: on the calling thread).
GATHER_THREADS = 4

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)

#: Exported C functions: name -> (argtypes, restype).
SIGNATURES = {
    "tddl_splitmix_fill": ([ctypes.c_uint64, ctypes.c_int64, _U64P], None),
    "tddl_synthetic_tokens": ([ctypes.c_int64, ctypes.c_int32,
                               ctypes.c_uint64, _I32P], None),
    "tddl_permutation": ([ctypes.c_uint64, ctypes.c_int64, _I64P], None),
    "tddl_gather_rows": ([_U8P, _I64P, ctypes.c_int64, ctypes.c_int64, _U8P,
                          ctypes.c_int32], None),
    "tddl_window_gather": ([_I32P, ctypes.c_int64, ctypes.c_int64,
                            ctypes.c_int64, ctypes.c_uint64, _I32P, _I32P,
                            ctypes.c_int32], None),
    "tddl_bpe_load": ([_I32P, _I32P, _I32P, ctypes.c_int64], None),
    "tddl_bpe_encode": ([_I32P, _I64P, ctypes.c_int64, _I32P, _I64P], None),
}

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def library_path() -> Path:
    """Where the library builds to in the active kernel cache."""
    return compile_cache.library_path(LIBRARY, [SOURCE], GXX_FLAGS)


def gxx_path() -> str:
    """``g++`` on PATH; raises when there is none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native host tier "
                           "(trustworthy_dl_tpu_torch/native) cannot be "
                           "built on this machine")
    return found


def build() -> float:
    """Compile ``dataloader.cpp`` into the kernel cache where it is missing;
    seconds spent (0.0 when it was built already).  Raises with the
    compiler's output on failure."""
    cmd = (lambda tmp: [gxx_path(), *GXX_FLAGS, "-o", str(tmp), str(SOURCE),
                        "-lpthread"])
    return compile_cache.build_libraries(
        [(LIBRARY, library_path(), cmd)], "gxx_build")[LIBRARY]


def library() -> ctypes.CDLL:
    """The loaded library, built on first use, its signatures declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            build()
            _LIB = compile_cache.load_library(LIBRARY, library_path(),
                                              SIGNATURES)
        return _LIB


def native_available() -> bool:
    """Whether the library builds and loads on this machine (it raises
    where it is used when it does not)."""
    try:
        library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


# ---------------------------------------------------------------------------
# The C entries
# ---------------------------------------------------------------------------


def splitmix_fill(seed: int, n: int) -> np.ndarray:
    """u64 [n] raw stream: splitmix64(seed + i * GOLDEN)."""
    out = np.empty(n, np.uint64)
    if n:
        library().tddl_splitmix_fill(ctypes.c_uint64(seed), n,
                                     _ptr(out, _U64P))
    return out


def synthetic_tokens(n: int, vocab: int, seed: int) -> np.ndarray:
    """i32 [n] affine next-token chain t -> (31 t + 7) mod V with 10 %
    uniform resets: low-entropy enough that a model visibly learns."""
    out = np.empty(n, np.int32)
    if n:
        library().tddl_synthetic_tokens(n, vocab, ctypes.c_uint64(seed),
                                        _ptr(out, _I32P))
    return out


def permutation(seed: int, n: int) -> np.ndarray:
    """i64 [n] Fisher-Yates permutation from the splitmix stream."""
    out = np.empty(n, np.int64)
    if n:
        library().tddl_permutation(ctypes.c_uint64(seed), n,
                                   _ptr(out, _I64P))
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[k] = src[idx[k]]: the batch's row gather, a multi-threaded
    memcpy.  Indices must lie in [0, len(src)): the C entry does no bounds
    checking, and is fed only by a permutation over the same array."""
    if src.ndim < 1:
        raise ValueError("gather_rows needs an array of rows")
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, np.int64)
    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:],
                                                 dtype=np.int64))
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    if len(idx) and row_bytes:
        library().tddl_gather_rows(_ptr(src, _U8P), _ptr(idx, _I64P),
                                   len(idx), row_bytes, _ptr(out, _U8P),
                                   GATHER_THREADS)
    return out


def _window_span(stream: np.ndarray, seq_len: int) -> int:
    # A window takes seq_len + 1 tokens: the offsets [0, len - seq_len - 1]
    # are len - seq_len of them.
    span = len(stream) - seq_len
    if span <= 0:
        raise ValueError(f"stream of {len(stream)} tokens too short for "
                         f"seq_len={seq_len}")
    return span


def window_gather(stream: np.ndarray, seq_len: int, batch: int, seed: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(inputs, targets) i32 [batch, seq_len]: seq_len + 1 windows of a
    token stream at splitmix-derived offsets (row r's offset a function of
    (seed, r) alone), a multi-threaded memcpy."""
    stream = np.ascontiguousarray(stream, np.int32)
    _window_span(stream, seq_len)
    inputs = np.empty((batch, seq_len), np.int32)
    targets = np.empty((batch, seq_len), np.int32)
    if batch:
        library().tddl_window_gather(
            _ptr(stream, _I32P), len(stream), seq_len, batch,
            ctypes.c_uint64(seed), _ptr(inputs, _I32P),
            _ptr(targets, _I32P), GATHER_THREADS)
    return inputs, targets


def bpe_load(lefts: np.ndarray, rights: np.ndarray,
             prods: np.ndarray) -> None:
    """Install the merge table (id pairs -> product id, rank = position,
    the first rank of a pair winning) into the encoder.  The library holds
    one table a process: ``data/tokenizer.py`` re-installs its own when
    another tokenizer's is live."""
    lefts = np.ascontiguousarray(lefts, np.int32)
    rights = np.ascontiguousarray(rights, np.int32)
    prods = np.ascontiguousarray(prods, np.int32)
    library().tddl_bpe_load(_ptr(lefts, _I32P), _ptr(rights, _I32P),
                            _ptr(prods, _I32P), len(lefts))


def bpe_encode(flat: np.ndarray, offsets: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a flat batch of unit-id words (``offsets`` [n + 1] delimits
    each) with the installed table: the lowest-ranked adjacent pair merges
    first, the leftmost on a tie.  Returns (flat ids, out offsets)."""
    flat = np.ascontiguousarray(flat, np.int32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(max(len(flat), 1), np.int32)
    out_offsets = np.zeros(len(offsets), np.int64)
    if len(offsets) > 1:
        library().tddl_bpe_encode(_ptr(flat, _I32P), _ptr(offsets, _I64P),
                                  len(offsets) - 1, _ptr(out, _I32P),
                                  _ptr(out_offsets, _I64P))
    return out[:out_offsets[-1]], out_offsets


# ---------------------------------------------------------------------------
# The numpy twins
# ---------------------------------------------------------------------------


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorised splitmix64 finaliser on uint64 states (wrapping)."""
    with np.errstate(over="ignore"):
        z = x + _GOLDEN
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _splitmix_scalar(x: int) -> int:
    return int(_splitmix64(np.asarray([x], np.uint64))[0])


def splitmix_fill_plain(seed: int, n: int) -> np.ndarray:
    """numpy twin of :func:`splitmix_fill`."""
    with np.errstate(over="ignore"):
        states = np.uint64(seed) + np.arange(n, dtype=np.uint64) * _GOLDEN
    return _splitmix64(states)


def synthetic_tokens_plain(n: int, vocab: int, seed: int) -> np.ndarray:
    """numpy twin of :func:`synthetic_tokens`."""
    a, b = 31, 7
    noise_u = splitmix_fill_plain(
        _splitmix_scalar(seed ^ 0xA5A5A5A5A5A5A5A5), n)
    reset = (noise_u >> np.uint64(48)) < np.uint64(6554)
    resets_tok = (splitmix_fill_plain(
        _splitmix_scalar(seed ^ 0x5A5A5A5A5A5A5A5A), n)
        % np.uint64(vocab)).astype(np.int64)
    out = np.empty(n, np.int32)
    if not n:
        return out
    t = _splitmix_scalar(seed) % vocab
    out[0] = t
    reset_l, tok_l = reset.tolist(), resets_tok.tolist()
    for i in range(1, n):
        t = tok_l[i] if reset_l[i] else (a * t + b) % vocab
        out[i] = t
    return out


def permutation_plain(seed: int, n: int) -> np.ndarray:
    """numpy twin of :func:`permutation`."""
    out = np.arange(n, dtype=np.int64)
    if n:
        us = splitmix_fill_plain(seed, n)
        for i in range(n - 1, 0, -1):
            j = int(us[i] % np.uint64(i + 1))
            out[i], out[j] = out[j], out[i]
    return out


def gather_rows_plain(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`gather_rows`."""
    return src[np.asarray(idx, np.int64)]


def window_gather_plain(stream: np.ndarray, seq_len: int, batch: int,
                        seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """numpy twin of :func:`window_gather`."""
    stream = np.ascontiguousarray(stream, np.int32)
    span = _window_span(stream, seq_len)
    offs = (splitmix_fill_plain(seed, batch)
            % np.uint64(span)).astype(np.int64)
    windows = stream[offs[:, None] + np.arange(seq_len + 1)[None, :]]
    return windows[:, :-1].copy(), windows[:, 1:].copy()


__all__ = [
    "GXX_FLAGS", "SIGNATURES", "SOURCE", "bpe_encode", "bpe_load", "build",
    "gather_rows", "gather_rows_plain", "gxx_path", "library",
    "library_path", "native_available", "permutation", "permutation_plain",
    "splitmix_fill", "splitmix_fill_plain", "synthetic_tokens",
    "synthetic_tokens_plain", "window_gather", "window_gather_plain",
]
