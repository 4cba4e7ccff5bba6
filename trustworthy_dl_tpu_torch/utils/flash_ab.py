"""This checkout's flash attention forward (B2) against another build of it,
in one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.flash_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/flash_attention.cu`` (for
example the parent commit's, from ``git show <commit>:<path>``): it is
built with the same ``nvcc`` flags into a library of its own beside the
checkout's kernels, and its ``tddl_flash_fwd`` is called through the same
C signature.  At GPT-2 small's training shape [96, 1024, 64] and at D = 32
and 128 (bf16, causal), both builds are held against ``flash_fwd_plain``
with ``chip_smoke.py``'s tolerances, then timed in turns (this, other,
other, this) with the L2 flushed before each launch: the median of
per-launch CUDA-event timings (``ms``, which also holds the host's
dispatch whenever the card waits for it) and the profiler's device time
of the kernel (``device_ms``), beside SDPA's on the same inputs.  Prints
one JSON line per shape, then the card's name and power limit.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SHAPES = ((96, 1024, 64), (96, 1024, 32), (48, 1024, 128))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another flash_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    lib = ab.other_library(args.other, "flash_attention")
    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)

    def other_fwd(q, k, v):
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
        err = lib.tddl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), *q.shape,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{args.other}: CUDA error {err}")
        return o, lse

    gen = torch.Generator(device=dev).manual_seed(4)
    for bh, t, d in SHAPES:
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen).to(
            torch.bfloat16) for _ in range(3))
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v)
        arms = {"this": lambda: fa.flash_attention_fwd(q, k, v),
                "other": lambda: other_fwd(q, k, v)}
        record = {"bhtd": [bh, t, d]}
        for name, fn in arms.items():
            o, lse = fn()
            torch.cuda.synchronize()
            err = (o.float() - o_ref.float()).abs()
            record[f"{name}_within_tolerance"] = bool(
                (err <= 2e-3 + 2.0 ** -7 * o_ref.float().abs()).all()
                and float((lse - lse_ref).abs().max()) <= 1e-3)
        q4, k4, v4 = (a.view(1, bh, t, d) for a in (q, k, v))
        arms["sdpa"] = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True)
        record.update(ab.in_turns(arms, ("this", "other", "other", "this",
                                         "sdpa"), flush, args.reps))
        flops = 2 * bh * d * (t * (t + 1) // 2) * 2
        record["this_device_tflops"] = flops / (
            min(record["this_device_ms"]) * 1e-3) / 1e12
        print(json.dumps(record), flush=True)
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
