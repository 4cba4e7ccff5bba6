"""The detector moment battery (B1): eight raw moments of many f32
segments in one pass.

Counterpart of ``trustworthy_dl_tpu/ops/fused_stats.py``.  For each segment
of a list (every gradient leaf of every node, or every node's monitored
features) :func:`fused_moments` returns one row (sum x, sum x^2, sum x^3,
sum x^4, min, max, sum |x|, max |x|), all f32.  CPU tensors run the plain
PyTorch twin :func:`fused_moments_plain`; CUDA tensors launch the kernel in
``csrc/fused_stats.cu`` (see the note there for what it replaces, its bound
and its design).  Unlike the TPU version there is no size cut-off: every
segment, of any length, goes through the kernel.

The statistics are diagnostics and constant under differentiation: the
kernel reads the inputs' memory into an output without a gradient, and
the twin detaches them and runs under ``torch.no_grad``.

:func:`fused_moments` carries a plain integer ``launches`` that
:func:`launch_moments` increments where it launches the kernel and
nowhere else; there it also adds its products,
:func:`fused_moments_flops` (none: the battery is reductions), to an
open FLOP tally (``ops.count_kernel_flops``).
"""

from __future__ import annotations

import ctypes
from array import array
from typing import Sequence

import torch

from trustworthy_dl_tpu_torch.ops import check_launch, kernel_library, \
    on_cuda, stream_handle, tally_flops

#: Elements a CTA reads (a multiple of 4).
CHUNK = 32768
#: Segments one launch takes: the kernel's segment table, 16 bytes a
#: segment in its parameter block (``csrc/fused_stats.cu``).
MAX_SEGMENTS = 2000

# Row layout of the moments.
S1, S2, S3, S4, MIN, MAX, L1, LINF = range(8)


def fused_moments_plain(segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """f32 [len(segments), 8] by eight PyTorch reductions per segment; an
    empty segment gives (0, 0, 0, 0, +inf, -inf, 0, 0)."""
    rows = []
    with torch.no_grad():
        for seg in segments:
            x = seg.detach().reshape(-1).float()
            if x.numel() == 0:
                rows.append(torch.tensor(
                    [0.0, 0.0, 0.0, 0.0, float("inf"), float("-inf"), 0.0,
                     0.0], device=x.device))
                continue
            x2 = x * x
            ax = x.abs()
            rows.append(torch.stack([x.sum(), x2.sum(), (x2 * x).sum(),
                                     (x2 * x2).sum(), x.min(), x.max(),
                                     ax.sum(), ax.max()]))
    return torch.stack(rows)


def fused_moments_flops(sizes: Sequence[int]) -> int:
    """Product FLOPs of the battery over segments of ``sizes`` elements:
    0, as ``torch.utils.flop_counter`` counts :func:`fused_moments_plain`
    (sums, minima and maxima are not products)."""
    return 0


def fused_moments(segments: Sequence[torch.Tensor]) -> torch.Tensor:
    """The moment battery of every segment, f32 [len(segments), 8], in one
    kernel launch for CUDA tensors (each a contiguous f32 tensor on one
    card, of any shape, at most :data:`MAX_SEGMENTS` of them)."""
    if not segments:
        raise ValueError("fused_moments: no segments")
    if not on_cuda(segments[0], "fused_moments"):
        return fused_moments_plain(segments)
    return launch_moments(kernel_library("fused_stats"), segments)


def launch_moments(lib: ctypes.CDLL, segments: Sequence[torch.Tensor]
                   ) -> torch.Tensor:
    """:func:`fused_moments`' launch through ``lib``'s
    ``tddl_fused_moments`` (the checkout's library, or a diagnostic build
    of ``csrc/fused_stats.cu`` in ``utils/moments_ab``).  One pass over the
    segments checks them and reads their pointers and lengths; the output
    and the kernel's scratch (partial rows, then one ticket a segment) are
    one allocation, the output its first ``8 len(segments)`` floats."""
    count = len(segments)
    if count > MAX_SEGMENTS:
        raise ValueError(f"fused_moments: {count} segments > "
                         f"{MAX_SEGMENTS} per launch")
    device = segments[0].device
    index = device.index
    for i, seg in enumerate(segments):
        if seg.dtype is not torch.float32 or seg.get_device() != index \
                or not seg.is_contiguous():
            raise ValueError(f"fused_moments: segment {i} must be a "
                             f"contiguous f32 tensor on {device}, got "
                             f"{seg.dtype} on {seg.device}"
                             + ("" if seg.is_contiguous()
                                else ", not contiguous"))
    ptrs = array("Q", [seg.data_ptr() for seg in segments])
    lens = array("q", [seg.numel() for seg in segments])
    # Chunk rows: max(1, ceil(n / CHUNK)) a segment, at most this many.
    rows = sum(lens) // CHUNK + count
    buf = torch.empty(8 * count + 8 * rows + count, dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        err = lib.tddl_fused_moments(
            ptrs.buffer_info()[0], lens.buffer_info()[0], count, CHUNK,
            buf.data_ptr() + 32 * count, buf.data_ptr(),
            stream_handle(device))
    check_launch(lib, err, "tddl_fused_moments")
    fused_moments.launches += 1
    tally_flops("fused_moments", fused_moments_flops(lens))
    return buf[:8 * count].view(count, 8)


fused_moments.launches = 0

#: The kernels of this module, by the wrapper that launches each.
KERNEL_WRAPPERS = (fused_moments,)

__all__ = ["CHUNK", "KERNEL_WRAPPERS", "MAX_SEGMENTS", "fused_moments",
           "fused_moments_flops", "fused_moments_plain", "launch_moments"]
