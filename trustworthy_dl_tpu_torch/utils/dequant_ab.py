"""This checkout's int8 dequant matmul (B4) against another build of it, in
one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.dequant_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/fused_dequant_matmul.cu``
(the parent commit's, from ``git show <commit>:<path>``, or an edited copy
of this one): it is built with the checkout's ``nvcc`` flags into a
library of its own, and both builds' ``tddl_dequant_matmul`` are called
the same way, straight through the C entry.  The cases are GPT-2 small's
four block matrices at M = 1, 8, 16 (decode and draft rows), 64 (a
prefill chunk) and 320 (a local prefill), and n_embd 96's qkv and mlp
proj at M = 8 (``d96``: K and N multiples of 16, not of 64).  x is bf16
unit normals, w_q and the scales the int8 quantization of 0.02-scaled
normals (seed 3).  Both builds are held against ``dequant_matmul_plain``
within ``DQ_RTOL`` of sum |x| |w| scale over each output (``chip_smoke.py``'s
bound), then timed in turns (this, other, other, this) with the L2 flushed,
beside the library call ``(x @ w_bf16).float() * scale`` on a bf16 copy of
the weight made beforehand (every kernel of the call: GEMM, cast, scale;
``utils/kernel_ab``, whose profiler sessions must record every launch:
one a call for either build).  A case the other build refuses (its launch returns
an error) is printed with ``other_refused`` and timed on this build and
the library call alone.  Each build's host time to enqueue one call
through its C entry (``this_host_us``, ``other_host_us``) is taken too.
Prints one JSON line per case, with the least
time the card could take for it (``bound_ms``: the weight, scales, x and
output bytes once at 3.35 TB/s, or the products at 989 TFLOP/s, whichever
is longer), then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

#: GPT-2 small's four block matrices (K, N).
GPT2_MATRICES = {"qkv": (768, 2304), "attn_proj": (768, 768),
                 "fc": (768, 3072), "mlp_proj": (3072, 768)}
#: Rows of x: decode and draft batches, a prefill chunk, a local prefill.
GPT2_ROWS = (1, 8, 16, 64, 320)
#: (label, K, N, M), every case of a run.
CASES = tuple((f"{name}_m{m}", k, n, m)
              for name, (k, n) in GPT2_MATRICES.items() for m in GPT2_ROWS
              ) + (("d96_qkv_m8", 96, 288, 8), ("d96_mlp_proj_m8", 384, 96, 8))
#: Each output within this much of sum |x| |w| scale over its terms (f32
#: summation order only: bf16 x int8 products are exact in f32).
DQ_RTOL = 1e-5
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12


def bound_ms(m: int, k: int, n: int) -> float:
    """Least time for one call: int8 weight, f32 scales, bf16 x and the f32
    output once at the memory rate, or 2 M K N flops at the bf16 tensor
    rate, whichever is longer."""
    n_bytes = k * n + 4 * n + 2 * m * k + 4 * m * n
    return max(n_bytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS) * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path,
                        help="another fused_dequant_matmul.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("dequant_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.ops import fused_dequant_matmul as fdm
    from trustworthy_dl_tpu_torch.quant import int8 as q8
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    libs = {"this": ops.kernel_library("fused_dequant_matmul"),
            "other": ab.other_library(args.other, "fused_dequant_matmul")}
    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(3)

    def entry(lib, x, wq, scale):
        m, k = x.shape
        n = wq.shape[1]
        out = torch.empty(m, n, dtype=torch.float32, device=dev)
        err = lib.tddl_dequant_matmul(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(), out.data_ptr(), m,
            k, n, torch.cuda.current_stream().cuda_stream)
        ops.check_launch(lib, err, "tddl_dequant_matmul")
        return out

    for label, k, n, m in CASES:
        wq, scale = q8.quantize_int8(
            torch.randn(k, n, device=dev, generator=gen) * 0.02, axis=0)
        wq, scale = wq.contiguous(), scale.contiguous()
        w_bf = wq.float().to(torch.bfloat16)
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        ref = fdm.dequant_matmul_plain(x, wq, scale)
        mag = (x.float().abs() @ wq.float().abs()) * scale
        arms = {name: (lambda lib=lib: entry(lib, x, wq, scale))
                for name, lib in libs.items()}
        record = {"case": label, "m": m, "k": k, "n": n,
                  "bound_ms": bound_ms(m, k, n)}
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
            err = (got - ref).abs()
            record[f"{name}_within_tolerance"] = bool(
                (err <= DQ_RTOL * mag + 1e-30).all()
                and torch.isfinite(got).all())
            record[f"{name}_max_abs_err"] = float(err.max())
        for name in list(arms):
            record[f"{name}_host_us"] = ab.host_us(arms[name])
        arms["library"] = lambda: (x @ w_bf).float() * scale
        order = [name for name in ("this", "other", "other", "this",
                                   "library") if name in arms]
        record.update(ab.in_turns(arms, order, flush, args.reps,
                                  launches={"this": 1, "other": 1}))
        if "other" in arms:
            record["other_over_this_device"] = (
                min(record["other_device_ms"]) /
                min(record["this_device_ms"]))
        record["library_over_this_device"] = (
            min(record["library_device_ms"]) / min(record["this_device_ms"]))
        print(json.dumps(record), flush=True)
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
