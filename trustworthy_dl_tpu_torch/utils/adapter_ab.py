"""This checkout's paged adapter delta (B9, over bf16 and int8 pages) against
another build of it, in one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.adapter_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/adapter_delta.cu`` (the
parent commit's, from ``git show <commit>:<path>``, or an edited copy of
this one): it is built with the checkout's ``nvcc`` flags into a library
of its own, and both builds' ``tddl_adapter_delta`` are called the same
way, straight through the C entry.  Every case runs on one site of a
5-page adapter pool [5, 2, D, r] (4 pages and the zero page; the strided
site view the engine passes), bf16 pages from 0.02-scaled normals or int8
pages with per-page f32 scales (seed 5), for both tiers:

* ``decode``, ``chunk``, ``ragged``: ``chip_smoke.py``'s three launches
  at D = 768, rank 16: x [8, 1, D] over pages [0, 1, 2, 2, 3, 0, 4, 1],
  [1, 64, D] over [2], [2, 20, D] over [3, 0];
* ``decode16``: the decode launch of a 16-slot engine, x [16, 1, D];
* ``r64_decode``, ``r64_chunk``: the decode and chunk launches at rank 64;
* ``d1024_r64``, ``d1600_r64``: the decode launch at rank 64 over GPT-2
  medium's and XL's widths.

Both builds are held against ``adapter_delta_plain`` within
:data:`ADAPTER_RTOL` of the plain output's largest magnitude, with the
zero page's rows exactly 0.0, then timed in turns (this, other, other,
this) with the L2 flushed, CUDA events and the profiler's device time,
beside the library call (the page gather and two ``torch.bmm`` in bf16,
scaled; every kernel of the call) (``utils/kernel_ab``).  A case the other
build refuses (its launch returns an error) is printed with
``other_refused`` and timed on this build and the library call alone.
Host microseconds to enqueue one call are taken for this checkout's
wrapper ``adapter_delta`` (``wrapper_host_us``: the checks, the output's
allocation and the launch) and for each build's C entry.  Prints one
JSON line per case, with the least time the card could take for it
(``bound_ms``), then the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

#: Each output within this much of the plain output's largest magnitude
#: (f32 sums of exact products in another order), as ``chip_smoke.py``.
ADAPTER_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12
SMOKE_PAGES = [0, 1, 2, 2, 3, 0, 4, 1]
#: (label, D, rank, T, page of each row).
CASES = (
    ("decode", 768, 16, 1, SMOKE_PAGES),
    ("chunk", 768, 16, 64, [2]),
    ("ragged", 768, 16, 20, [3, 0]),
    ("decode16", 768, 16, 1, SMOKE_PAGES * 2),
    ("r64_decode", 768, 64, 1, SMOKE_PAGES),
    ("r64_chunk", 768, 64, 64, [2]),
    ("d1024_r64", 1024, 64, 1, SMOKE_PAGES),
    ("d1600_r64", 1600, 64, 1, SMOKE_PAGES),
)
POOL_PAGES = 5


def bound_ms(rows: int, t: int, d: int, rank: int, pages, itemsize: int,
             scaled: bool) -> float:
    """Least time for one call: x (bf16), the f32 output, the page row and
    each distinct page's A and B (and two f32 scales) once at the memory
    rate, or 4 R T D r flops at the bf16 tensor rate, whichever is
    longer."""
    distinct = len(set(pages))
    n_bytes = (rows * t * d * 2 + rows * t * d * 4 + rows * 4
               + distinct * 2 * d * rank * itemsize
               + (distinct * 8 if scaled else 0))
    return max(n_bytes / HBM_BYTES_PER_S,
               4 * rows * t * d * rank / BF16_FLOPS) * 1e3


def library_delta(x, a, b, pages, a_scale=None, b_scale=None):
    """The yardstick: the same delta in library calls, the page gather
    and two ``torch.bmm`` in bf16, scaled (``h`` rounded to bf16 for the
    second product, so it is no reference for the kernel's numbers)."""
    idx = pages.long()
    h = torch.bmm(x, a[idx].to(torch.bfloat16)).float()
    if a_scale is not None:
        h = h * a_scale[idx][:, None, None]
    out = torch.bmm(h.to(torch.bfloat16), b[idx].to(torch.bfloat16)).float()
    if b_scale is not None:
        out = out * b_scale[idx][:, None, None]
    return out


def site_pools(d: int, rank: int, tier: str, gen, dev):
    """One site view (site 1) of a pool of :data:`POOL_PAGES` pages, page
    0 all zeros: (A [P, D, r], B [P, r, D], a_scale, b_scale)."""
    shape_a, shape_b = (POOL_PAGES, 2, d, rank), (POOL_PAGES, 2, rank, d)
    if tier == "int8":
        a = torch.randint(-127, 128, shape_a, device=dev, generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, shape_b, device=dev, generator=gen,
                          dtype=torch.int8)
        sa = torch.rand(POOL_PAGES, 2, device=dev, generator=gen) * 1e-3
        sb = torch.rand(POOL_PAGES, 2, device=dev, generator=gen) * 1e-3
        sa[0] = 1.0
        sb[0] = 1.0
        sa, sb = sa[:, 1], sb[:, 1]
    else:
        a = (torch.randn(shape_a, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        b = (torch.randn(shape_b, device=dev, generator=gen) * 0.02).to(
            torch.bfloat16)
        sa = sb = None
    a[0] = 0
    b[0] = 0
    return a[:, 1], b[:, 1], sa, sb


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another adapter_delta.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("adapter_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.ops import paged_attention as pa
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    libs = {"this": ops.kernel_library("adapter_delta"),
            "other": ab.other_library(args.other, "adapter_delta")}
    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(5)

    def entry(lib, x, a, b, pages, sa, sb):
        rows, t, d = x.shape
        npg, _, rank = a.shape
        out = torch.empty(rows, t, d, dtype=torch.float32, device=dev)
        err = lib.tddl_adapter_delta(
            x.data_ptr(), a.data_ptr(), b.data_ptr(),
            None if sa is None else sa.data_ptr(),
            None if sb is None else sb.data_ptr(), pages.data_ptr(),
            out.data_ptr(), a.stride(0), b.stride(0),
            0 if sa is None else sa.stride(0), rows, t, d, rank, npg,
            pa._ADAPTER_POOL_CODES[a.dtype],
            torch.cuda.current_stream().cuda_stream)
        ops.check_launch(lib, err, "tddl_adapter_delta")
        return out

    for tier in ("bf16", "int8"):
        for label, d, rank, t, page_list in CASES:
            a, b, sa, sb = site_pools(d, rank, tier, gen, dev)
            rows = len(page_list)
            x = torch.randn(rows, t, d, device=dev, generator=gen).to(
                torch.bfloat16)
            pages = torch.tensor(page_list, dtype=torch.int32, device=dev)
            args_ = (x, a, b, pages, sa, sb)
            ref = pa.adapter_delta_plain(*args_)
            limit = ADAPTER_RTOL * float(ref.abs().max())
            zero_rows = [i for i, p in enumerate(page_list) if p == 0]
            arms = {name: (lambda lib=lib: entry(lib, *args_))
                    for name, lib in libs.items()}
            record = {"case": label, "tier": tier, "x": [rows, t, d],
                      "rank": rank, "pages": page_list,
                      "bound_ms": bound_ms(rows, t, d, rank, page_list,
                                           a.element_size(), sa is not None),
                      "plain_max_abs": float(ref.abs().max())}
            for name in list(arms):
                try:
                    got = arms[name]()
                except RuntimeError as exc:
                    if name == "this":
                        raise
                    record[f"{name}_refused"] = str(exc)
                    del arms[name]
                    continue
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                record[f"{name}_within_tolerance"] = bool(
                    err <= limit and torch.isfinite(got).all()
                    and all(bool((got[i] == 0.0).all()) for i in zero_rows))
                record[f"{name}_max_abs_err"] = err
            record["wrapper_host_us"] = ab.host_us(
                lambda: pa.adapter_delta(*args_))
            for name in list(arms):
                record[f"{name}_host_us"] = ab.host_us(arms[name])

            arms["library"] = lambda: library_delta(*args_)
            order = [name for name in ("this", "other", "other", "this",
                                       "library") if name in arms]
            record.update(ab.in_turns(arms, order, flush, args.reps,
                                      launches={"this": 1, "other": 1}))
            if "other" in arms:
                record["other_over_this_device"] = (
                    min(record["other_device_ms"]) /
                    min(record["this_device_ms"]))
            record["library_over_this_device"] = (
                min(record["library_device_ms"]) /
                min(record["this_device_ms"]))
            print(json.dumps(record), flush=True)
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
