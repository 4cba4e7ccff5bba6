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
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SHAPES = ((96, 1024, 64), (96, 1024, 32), (48, 1024, 128))


def _other_library(source: Path):
    from trustworthy_dl_tpu_torch import ops

    ops.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = ops.BUILD_DIR / f"flash_ab_{source.stem}.so"
    out = subprocess.run([ops.nvcc_path(), *ops.NVCC_FLAGS, "-o",
                          str(target), str(source)], capture_output=True,
                         text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(target))
    argtypes, restype = ops.SIGNATURES["flash_attention"]["tddl_flash_fwd"]
    lib.tddl_flash_fwd.argtypes = argtypes
    lib.tddl_flash_fwd.restype = restype
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another flash_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trustworthy_dl_tpu_torch.ops import flash_attention as fa
    from trustworthy_dl_tpu_torch.utils.serve_profile import device_us

    lib = _other_library(args.other)
    dev = torch.device("cuda")
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def other_fwd(q, k, v):
        o = torch.empty_like(q)
        lse = torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
        err = lib.tddl_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), *q.shape,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{args.other}: CUDA error {err}")
        return o, lse

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(fn):
        """Device time per call of every kernel but the flush's."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        return sum(device_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "FillFunctor" not in e.key) / args.reps / 1e3

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
        for name in ("this", "other", "other", "this", "sdpa"):
            record.setdefault(f"{name}_ms", []).append(event_ms(arms[name]))
            record.setdefault(f"{name}_device_ms", []).append(
                device_ms(arms[name]))
        flops = 2 * bh * d * (t * (t + 1) // 2) * 2
        record["this_device_tflops"] = flops / (
            min(record["this_device_ms"]) * 1e-3) / 1e12
        print(json.dumps(record), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
