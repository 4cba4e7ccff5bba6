"""This checkout's int8 chunked-prefill attention (B6-int8, bf16 queries)
against another build of it, in one process on one card.

    python -m trustworthy_dl_tpu_torch.utils.prefill_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/paged_attention.cu`` (the
parent commit's, from ``git show <commit>:<path>``, or an edited copy
of this one): it is built with the checkout's ``nvcc`` flags into a
library of its own, and both builds' ``tddl_paged_prefill_int8`` are
called the same way, straight through the C entry.  Over GPT-2 small's int8 pool geometry (12 heads, 16-position
blocks, a 32-block table, int8 K/V quantized from unit normals with f32
per-position scales) it runs the serve_spec launch (q [1, 12, 512, 64]
from position 128, the last 128 rows past the table), a fresh 512-row
chunk from position 0, the ``chunk64`` case ([1, 12, 64, 64] from 128),
and the serve_spec launch at D = 32 and 128.  Both builds are held
against ``paged_attention_plain`` with ``chip_smoke.py``'s tolerances on
the rows inside the table, then timed in turns (this, other, other, this)
with the L2 flushed, beside SDPA over the dequantized gathered view with
the same mask (``utils/kernel_ab``).  Prints one JSON line per case, then
the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

# (label, heads, query rows, head width, start)
CASES = (("serve_spec", 12, 512, 64, 128), ("start0", 12, 512, 64, 0),
         ("chunk64", 12, 64, 64, 128), ("d32", 12, 512, 32, 128),
         ("d128", 12, 512, 128, 128))
BLOCK, NBPS = 16, 32
ATTN_ATOL, ATTN_RTOL = 2e-3, 2.0 ** -7


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another paged_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("prefill_ab: needs a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.ops import paged_attention as pa
    from trustworthy_dl_tpu_torch.quant import int8 as q8
    from trustworthy_dl_tpu_torch.utils import kernel_ab as ab

    libs = {"this": ops.kernel_library("paged_attention"),
            "other": ab.other_library(args.other, "paged_attention")}
    dev = torch.device("cuda")
    flush = ab.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    def entry(lib, q, kq, vq, table, start, ks, vs):
        out = torch.empty_like(q)
        r, h, t, d = q.shape
        err = lib.tddl_paged_prefill_int8(
            q.data_ptr(), kq.data_ptr(), vq.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), table.data_ptr(), start.data_ptr(),
            out.data_ptr(), r, h, t, d, BLOCK, NBPS, pa.QROWS,
            ops.DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream)
        ops.check_launch(lib, err, "tddl_paged_prefill_int8")
        return out

    for label, h, t, d, s0 in CASES:
        nb = NBPS + 1
        kq, ks = q8.quantize_kv(torch.randn(nb, h, BLOCK, d, device=dev,
                                            generator=gen))
        vq, vs = q8.quantize_kv(torch.randn(nb, h, BLOCK, d, device=dev,
                                            generator=gen))
        table = (torch.randperm(NBPS, device=dev, generator=gen) + 1).to(
            torch.int32)[None]
        start = torch.tensor([s0], dtype=torch.int32, device=dev)
        q = torch.randn(1, h, t, d, device=dev, generator=gen).to(
            torch.bfloat16)
        ref = pa.paged_attention_plain(q, kq, vq, table, start, ks, vs)
        inside = (torch.arange(t, device=dev) + s0 < NBPS * BLOCK)[
            None, None, :, None].expand_as(ref)
        arms = {name: (lambda lib=lib: entry(lib, q, kq, vq, table, start,
                                             ks, vs))
                for name, lib in libs.items()}
        record = {"case": label, "q": [1, h, t, d], "start": s0,
                  "pool": list(kq.shape)}
        for name, fn in arms.items():
            got = fn()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
            record[f"{name}_within_tolerance"] = bool(
                within[inside].all() and torch.isfinite(got).all())
            record[f"{name}_max_abs_err"] = float(err[inside].max())
        view_k = (kq.float() * ks[..., None]).to(torch.bfloat16)[
            table.long()].permute(0, 2, 1, 3, 4).reshape(1, h, -1, d)
        view_v = (vq.float() * vs[..., None]).to(torch.bfloat16)[
            table.long()].permute(0, 2, 1, 3, 4).reshape(1, h, -1, d)
        kpos = torch.arange(view_k.shape[2], device=dev)
        mask = (kpos[None, :] <= s0 + torch.arange(t, device=dev)[:, None])
        arms["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, view_k, view_v, attn_mask=mask)
        record.update(ab.in_turns(arms, ("this", "other", "other", "this",
                                         "sdpa"), flush, args.reps))
        record["other_over_this_device"] = (
            min(record["other_device_ms"]) / min(record["this_device_ms"]))
        print(json.dumps(record), flush=True)
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
