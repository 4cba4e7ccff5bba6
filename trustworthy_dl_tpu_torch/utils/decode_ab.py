"""This checkout's paged-decode attention (B5 with bf16 queries, over the
bf16 and the int8 pool) against another build of it, in one process on
one card.

    python -m trustworthy_dl_tpu_torch.utils.decode_ab OTHER.cu [--reps 25]

``OTHER.cu`` is another version of ``ops/csrc/paged_attention.cu`` (the
parent commit's, from ``git show <commit>:<path>``, or an edited copy of
this one): it is built with the checkout's ``nvcc`` flags into a library
of its own, and both builds' ``tddl_paged_decode`` and
``tddl_paged_decode_int8`` are called the same way, straight through the
C entries.  Over GPT-2 small's pool geometry (8 rows, 12 heads,
16-position blocks, 32-block tables; bf16 K/V from unit normals, int8
K/V quantized from them with f32 per-position scales) it runs

* ``smoke_bf16``: ``chip_smoke.py``'s bf16 decode launch, q [8, 12, 1,
  64] at the smoke's starts;
* ``int8_t1`` and ``int8_verify``: the int8 pool at T = 1 and at the
  speculative verify window T = 5, at the same starts (less 8);
* ``bf16_t4``: the bf16 pool at T = 4 (``spec_k=3``'s verify window),
  the kernel's middle query-row instance;
* ``full512``: every row's window the whole 512-position table, both
  pools;
* ``table1024``: 64-block tables, every window 1,024 positions, both
  pools;
* ``d128``: head width 128 at the smoke's starts, both pools.

Both builds are held against ``paged_attention_plain`` with
``chip_smoke.py``'s tolerances (atol 2e-3, rtol 2^-7), then timed in
turns (this, other, other, this) with the L2 flushed, CUDA events and
the profiler's device time, beside SDPA over the gathered (or
dequantized) view with the same mask (``utils/kernel_ab``).  Prints one
JSON line per case, then the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROWS, HEADS, BLOCK, NBPS = 8, 12, 16, 32
ATTN_ATOL, ATTN_RTOL = 2e-3, 2.0 ** -7


def smoke_starts():
    """The starts of ``chip_smoke.py``'s bf16 decode case: its seed-0
    generator after the table's permutation."""
    rng = np.random.default_rng(0)
    rng.permutation(ROWS * NBPS)
    return [int(s) for s in rng.integers(0, NBPS * BLOCK, size=ROWS)]


def cases():
    """(label, pool, T, head width, blocks a table, starts)."""
    smoke = smoke_starts()
    inside = [min(s, NBPS * BLOCK - 8) for s in smoke]
    out = [("smoke_bf16", "bf16", 1, 64, NBPS, smoke),
           ("int8_t1", "int8", 1, 64, NBPS, inside),
           ("int8_verify", "int8", 5, 64, NBPS, inside),
           ("bf16_t4", "bf16", 4, 64, NBPS, inside)]
    for pool in ("bf16", "int8"):
        out += [(f"full512_{pool}", pool, 1, 64, NBPS,
                 [NBPS * BLOCK - 1] * ROWS),
                (f"table1024_{pool}", pool, 1, 64, 2 * NBPS,
                 [2 * NBPS * BLOCK - 1] * ROWS),
                (f"d128_{pool}", pool, 1, 128, NBPS, smoke)]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", type=Path, help="another paged_attention.cu")
    parser.add_argument("--reps", type=int, default=25)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_ab: needs a CUDA card", file=sys.stderr)
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
    stream = torch.cuda.current_stream().cuda_stream

    def entry(lib, q, pk, pv, table, start, scales):
        out = torch.empty_like(q)
        r, h, t, d = q.shape
        ptrs = [q, pk, pv, *scales, table, start, out]
        name = "tddl_paged_decode_int8" if scales else "tddl_paged_decode"
        err = getattr(lib, name)(*(a.data_ptr() for a in ptrs), r, h, t, d,
                                 BLOCK, table.shape[1],
                                 ops.DTYPE_CODES[q.dtype], stream)
        ops.check_launch(lib, err, name)
        return out

    for label, pool, t, d, nbps, starts in cases():
        nb = ROWS * nbps + 1
        k = torch.randn(nb, HEADS, BLOCK, d, device=dev, generator=gen)
        v = torch.randn(nb, HEADS, BLOCK, d, device=dev, generator=gen)
        if pool == "int8":
            (pk, ks), (pv, vs) = q8.quantize_kv(k), q8.quantize_kv(v)
            scales = (ks, vs)
            view_pool_k = (pk.float() * ks[..., None]).to(torch.bfloat16)
            view_pool_v = (pv.float() * vs[..., None]).to(torch.bfloat16)
        else:
            pk, pv = k.to(torch.bfloat16), v.to(torch.bfloat16)
            scales = ()
            view_pool_k, view_pool_v = pk, pv
        table = (torch.randperm(ROWS * nbps, device=dev, generator=gen) + 1
                 ).to(torch.int32).reshape(ROWS, nbps)
        start = torch.tensor(starts, dtype=torch.int32, device=dev)
        q = torch.randn(ROWS, HEADS, t, d, device=dev, generator=gen).to(
            torch.bfloat16)
        ref = pa.paged_attention_plain(q, pk, pv, table, start, *scales)
        arms = {name: (lambda lib=lib: entry(lib, q, pk, pv, table, start,
                                             scales))
                for name, lib in libs.items()}
        record = {"case": label, "pool": pool, "q": [ROWS, HEADS, t, d],
                  "blocks_per_table": nbps, "starts": starts}
        for name, fn in arms.items():
            got = fn()
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
            record[f"{name}_within_tolerance"] = bool(
                within.all() and torch.isfinite(got).all())
            record[f"{name}_max_abs_err"] = float(err.max())
        view_k = pa.gather_pool(view_pool_k, table)
        view_v = pa.gather_pool(view_pool_v, table)
        kpos = torch.arange(view_k.shape[2], device=dev)
        qpos = start.long()[:, None] + torch.arange(t, device=dev)[None]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
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
