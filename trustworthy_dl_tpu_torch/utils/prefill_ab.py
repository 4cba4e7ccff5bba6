"""This checkout's chunked-prefill attention (B6 with bf16 queries, over
the bf16 and the int8 pool) against another build of it, in one process
on one card.

    python -m trustworthy_dl_tpu_torch.utils.prefill_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/paged_attention.cu`` (the
parent commit's, from ``git show <commit>:<path>``, or an edited copy
of this one): it is built with the checkout's ``nvcc`` flags into a
library of its own, and both builds' ``tddl_paged_prefill`` (bf16 pool)
and ``tddl_paged_prefill_int8`` (int8 pool) are called the same way,
straight through the C entries.  Over GPT-2 small's pool geometry (12
heads, 16-position blocks, a 32-block table; the int8 pool quantized from
unit normals with f32 per-position scales) it runs, over the int8 pool,
the serve_spec launch (q [1, 12, 512, 64] from position 128, the last 128
rows past the table), a fresh 512-row chunk from position 0, the
``chunk64`` case ([1, 12, 64, 64] from 128), and the serve_spec launch at
D = 32 and 128; over the bf16 pool, the serve drive's launch (``bf16_
chunk64``: [1, 12, 64, 64] from 128), 512 rows from 0 and from 128, the
latter at D = 32 and 128, and a 128-row chunk from 128 over 128-position
blocks (a 4-block table).  Both builds are held against
``paged_attention_plain`` with ``chip_smoke.py``'s tolerances on the rows
inside the table, then timed in turns (this, other, other, this) with the
L2 flushed, beside SDPA over the (dequantized) gathered view with the
same mask (``utils/kernel_ab``).  A case the other build refuses (its
launch returns an error) is printed with ``other_refused`` and timed on
this build and SDPA alone.  Prints one JSON line per case, then the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

# (label, pool, heads, query rows, head width, start, block size)
CASES = (("serve_spec", "int8", 12, 512, 64, 128, 16),
         ("start0", "int8", 12, 512, 64, 0, 16),
         ("chunk64", "int8", 12, 64, 64, 128, 16),
         ("d32", "int8", 12, 512, 32, 128, 16),
         ("d128", "int8", 12, 512, 128, 128, 16),
         ("bf16_chunk64", "bf16", 12, 64, 64, 128, 16),
         ("bf16_start0", "bf16", 12, 512, 64, 0, 16),
         ("bf16_512", "bf16", 12, 512, 64, 128, 16),
         ("bf16_d32", "bf16", 12, 512, 32, 128, 16),
         ("bf16_d128", "bf16", 12, 512, 128, 128, 16),
         ("bf16_block128", "bf16", 12, 128, 64, 128, 128))
#: Positions every case's table holds.
TABLE_POSITIONS = 512
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

    def entry(lib, q, pk, pv, table, start, scales):
        out = torch.empty_like(q)
        r, h, t, d = q.shape
        name = "tddl_paged_prefill_int8" if scales else "tddl_paged_prefill"
        err = getattr(lib, name)(
            q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
            *(a.data_ptr() for a in scales), table.data_ptr(),
            start.data_ptr(), out.data_ptr(), r, h, t, d, pk.shape[2],
            table.shape[1], pa.QROWS, ops.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream().cuda_stream)
        ops.check_launch(lib, err, name)
        return out

    for label, pool, h, t, d, s0, bsz in CASES:
        nbps = TABLE_POSITIONS // bsz
        nb = nbps + 1
        k = torch.randn(nb, h, bsz, d, device=dev, generator=gen)
        v = torch.randn(nb, h, bsz, d, device=dev, generator=gen)
        if pool == "int8":
            (pk, ks), (pv, vs) = q8.quantize_kv(k), q8.quantize_kv(v)
            scales = (ks, vs)
            view_k = (pk.float() * ks[..., None]).to(torch.bfloat16)
            view_v = (pv.float() * vs[..., None]).to(torch.bfloat16)
        else:
            pk, pv = k.to(torch.bfloat16), v.to(torch.bfloat16)
            scales = ()
            view_k, view_v = pk, pv
        table = (torch.randperm(nbps, device=dev, generator=gen) + 1).to(
            torch.int32)[None]
        start = torch.tensor([s0], dtype=torch.int32, device=dev)
        q = torch.randn(1, h, t, d, device=dev, generator=gen).to(
            torch.bfloat16)
        ref = pa.paged_attention_plain(q, pk, pv, table, start, *scales)
        inside = (torch.arange(t, device=dev) + s0 < TABLE_POSITIONS)[
            None, None, :, None].expand_as(ref)
        arms = {name: (lambda lib=lib: entry(lib, q, pk, pv, table, start,
                                             scales))
                for name, lib in libs.items()}
        record = {"case": label, "pool": pool, "q": [1, h, t, d],
                  "start": s0, "pool_shape": list(pk.shape)}
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
            err = (got.float() - ref.float()).abs()
            within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
            record[f"{name}_within_tolerance"] = bool(
                within[inside].all() and torch.isfinite(got).all())
            record[f"{name}_max_abs_err"] = float(err[inside].max())
        view_k = view_k[table.long()].permute(0, 2, 1, 3, 4).reshape(
            1, h, -1, d)
        view_v = view_v[table.long()].permute(0, 2, 1, 3, 4).reshape(
            1, h, -1, d)
        kpos = torch.arange(view_k.shape[2], device=dev)
        mask = (kpos[None, :] <= s0 + torch.arange(t, device=dev)[:, None])
        arms["sdpa"] = lambda: F.scaled_dot_product_attention(
            q, view_k, view_v, attn_mask=mask)
        order = [name for name in ("this", "other", "other", "this", "sdpa")
                 if name in arms]
        record.update(ab.in_turns(arms, order, flush, args.reps))
        if "other" in arms:
            record["other_over_this_device"] = (
                min(record["other_device_ms"]) /
                min(record["this_device_ms"]))
        print(json.dumps(record), flush=True)
    print(ab.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
