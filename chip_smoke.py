#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port builds and serves on the card.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):

1. device: require CUDA; print the card's name and power limit.
2. build: compile the CUDA kernels from ``trustworthy_dl_tpu_torch/ops/
   csrc`` with nvcc for sm_90a (one nvcc per source, started together).
3. kernels: call each kernel's wrapper at the serving path's shapes, hold
   it against its plain PyTorch version on the same inputs, and time the
   kernel, the plain version and a library yardstick (median of per-launch
   CUDA-event timings, L2 flushed before each launch).
4. serve: drive ``ServingEngine`` at the full width of GPT-2 small (12
   layers, 768 wide, 12 heads, vocab 50257, bf16; random weights from
   seed 0) over 16 requests, with every kernel launch counter set to 0
   just before and read just after; hold the greedy streams against the
   same engine on the plain path.

The line before the last two is the ``kernels`` summary, then the card's
``nvidia-smi`` name and power limit, then ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

# Kernel-vs-plain tolerances.  bf16 attention outputs: the kernel and the
# plain version both accumulate in f32 and round to bf16, in another
# summation order, so they may differ by one bf16 step, 2^-7 relative.
# The outputs are weighted means of unit-normal V rows over hundreds of
# keys, about 0.1 in size, where one step is about 5e-4: atol 2e-3 +
# rtol 2^-7, a few steps and not a tenth of a typical value.  The trust
# epilogue: margin exactly equal (max/min only), entropy within 1e-4 (one
# f32 pass over 50257 terms against log_softmax's two).
ATTN_ATOL = 2e-3
ATTN_RTOL = 2.0 ** -7
ENTROPY_ATOL = 1e-4
# Greedy streams of the kernel path and the plain path are compared while
# their tokens agree.  At the first disagreement the plain path's top-1
# margin there must be below NEAR_TIE_MARGIN: under it the two paths'
# last-bit differences may flip the argmax legitimately (the parity
# tolerance of the JAX package's int8 probe).  At every agreeing position
# the two paths' margins differ by less than that same bound, and their
# entropies by less than about one bf16 step of logits of size 1-2
# (2^-7), which bounds how far the entropy moves when every logit moves
# by at most one step and the logits' spread is about 1.
NEAR_TIE_MARGIN = 0.05
SERVE_MARGIN_ATOL = NEAR_TIE_MARGIN
SERVE_ENTROPY_ATOL = 1e-2
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
SOURCE = "trustworthy_dl_tpu_torch/ops/csrc/paged_attention.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def one_card() -> str:
    """Make the first visible card the only one this process sees, so the
    run and its report name one card; returns its index or UUID."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.strip() or "0"
    return os.environ["CUDA_VISIBLE_DEVICES"]


def nvidia_smi_line(card: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--id={card}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 25) -> float:
    """Median ms of one call of ``fn``, each launch timed alone between
    CUDA events with the L2 cache flushed before it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_bound(starts, t, h, dh, itemsize):
    """Least time for the attention work these rows need: each row reads
    K and V of positions [0, start + t) once, reads q and writes out once;
    2 flops per multiply-add in q.k and p.v over each query's window."""
    rows = len(starts)
    kv_bytes = sum((s + t) for s in starts) * h * dh * 2 * itemsize
    io_bytes = 2 * rows * h * t * dh * itemsize + rows * 4
    flops = sum(sum(s + i + 1 for i in range(t)) for s in starts) \
        * h * dh * 4
    return kv_bytes + io_bytes, flops


def bound_entry(n_bytes, flops, dtype_name):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def check_kernels(torch, pa):
    """Phase 3: every kernel at the serving path's shapes vs its plain
    version; returns the kernels entries (launches filled in later)."""
    import numpy as np
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    r, h, dh, bsz, nbps = 8, 12, 64, 16, 32
    nb = r * nbps + 1
    pool_k = torch.randn(nb, h, bsz, dh, device=dev).to(torch.bfloat16)
    pool_v = torch.randn(nb, h, bsz, dh, device=dev).to(torch.bfloat16)
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=dev)
    entries = {}

    def attn_case(name, wrapper, plain, q, tab, start_list, replaces):
        start = torch.tensor(start_list, dtype=torch.int32, device=dev)
        got = wrapper(q, pool_k, pool_v, tab, start)
        torch.cuda.synchronize()
        ref = plain(q, pool_k, pool_v, tab, start)
        err = (got.float() - ref.float()).abs()
        ok = bool((err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()).all())
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"(max abs err {float(err.max())})")
        # Yardstick: SDPA over the already-gathered view (gather not
        # timed), with the same causal + ragged mask.
        rows, _, t, _ = q.shape
        view_k = pool_k[tab.long()].permute(0, 2, 1, 3, 4).reshape(
            rows, h, -1, dh)
        view_v = pool_v[tab.long()].permute(0, 2, 1, 3, 4).reshape(
            rows, h, -1, dh)
        kpos = torch.arange(view_k.shape[2], device=dev)
        qpos = start.long()[:, None] + torch.arange(t, device=dev)[None]
        mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
        n_bytes, flops = attention_bound(start_list, t, h, dh, 2)
        bound_ms, bound_by = bound_entry(n_bytes, flops, "bfloat16")
        entries[name] = {
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": 0,
            "max_abs_err": float(err.max()),
            "ms": time_ms(torch, lambda: wrapper(q, pool_k, pool_v, tab,
                                                 start), flush),
            "plain_ms": time_ms(torch, lambda: plain(q, pool_k, pool_v, tab,
                                                     start), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, view_k, view_v, attn_mask=mask), flush),
            "shape": {"q": list(q.shape), "pool": list(pool_k.shape),
                      "starts": start_list},
        }

    starts = [int(s) for s in rng.integers(0, nbps * bsz, size=r)]
    q1 = torch.randn(r, h, 1, dh, device=dev).to(torch.bfloat16)
    attn_case("paged_decode_attention", pa.paged_attention,
              pa.paged_attention_plain, q1, table, starts,
              "trustworthy_dl_tpu/ops/paged_attention.py:429")
    # Prefill: one 64-position chunk resuming after a 128-token prefix
    # hit, the shape the serve path gives it (R = 1).
    q64 = torch.randn(1, h, 64, dh, device=dev).to(torch.bfloat16)
    attn_case("paged_prefill_attention", pa.paged_prefill_attention,
              pa.paged_prefill_attention_plain, q64, table[:1], [128],
              "trustworthy_dl_tpu/ops/paged_attention.py:649")
    # A ragged multi-row prefill check (not timed): 8 rows, mid-block
    # starts, chunks crossing block boundaries.
    q20 = torch.randn(r, h, 20, dh, device=dev).to(torch.bfloat16)
    start20 = torch.tensor([0, 5, 13, 30, 77, 200, 301, 490],
                           dtype=torch.int32, device=dev)
    got = pa.paged_prefill_attention(q20, pool_k, pool_v, table, start20)
    ref = pa.paged_prefill_attention_plain(q20, pool_k, pool_v, table,
                                           start20)
    keep = torch.arange(20, device=dev)[None, :] + start20.long()[:, None] \
        < nbps * bsz                     # rows inside each table
    err = (got.float() - ref.float()).abs()
    within = err <= ATTN_ATOL + ATTN_RTOL * ref.float().abs()
    inside = keep[:, None, :, None].expand_as(got)
    if not bool(within[inside].all()):
        raise AssertionError("ragged prefill: max abs err "
                             f"{float(err[inside].max())}")

    b, v = 8, 50257
    logits = torch.randn(b, v, device=dev) * 2.0
    logits[0, 11] = logits[0, 4000] = float(logits[0].max()) + 1.0
    ent, mar = pa.logit_trust_stats(logits)
    torch.cuda.synchronize()
    ent_ref, mar_ref = pa.logit_trust_stats_plain(logits)
    ent_err = float((ent - ent_ref).abs().max())
    if not torch.equal(mar, mar_ref) or ent_err > ENTROPY_ATOL \
            or float(mar[0]) != 0.0:
        raise AssertionError(f"trust epilogue disagrees: entropy err "
                             f"{ent_err}, margins equal "
                             f"{torch.equal(mar, mar_ref)}")
    bound_ms, bound_by = bound_entry(b * v * 4 + 2 * b * 4, b * v * 6,
                                     "float32")
    entries["logit_trust_stats"] = {
        "name": "logit_trust_stats", "route": "cuda", "source": SOURCE,
        "replaces": "trustworthy_dl_tpu/ops/paged_attention.py:787",
        "launches": 0, "max_abs_err": ent_err,
        "ms": time_ms(torch, lambda: pa.logit_trust_stats(logits), flush),
        "plain_ms": time_ms(torch, lambda: pa.logit_trust_stats_plain(
            logits), flush),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # Yardstick: logsumexp + top-2, the two library calls that give
        # logZ and the margin (entropy has no single library call).
        "library_ms": time_ms(torch, lambda: (
            torch.logsumexp(logits, -1), torch.topk(logits, 2, -1)), flush),
        "shape": {"logits": [b, v]},
    }
    return entries


def serve_drive(torch, pa, entries, card):
    """Phase 4: GPT-2 small through the port's engine, kernel path, with
    the launch counters set to 0 just before and read just after; then the
    same traffic on the plain path for the greedy-stream comparison."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import (serve_smoke,
                                                              smoke_traffic)

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gpt2.init_params(cfg, gen, device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    serve_smoke(cfg, params, "kernel", requests[:1])        # warm-up

    pa.reset_launch_counts()
    engine, results, wall = serve_smoke(cfg, params, "kernel", requests)
    launches = {fn.__name__: fn.launches for fn in pa.KERNEL_WRAPPERS}
    summary = engine.metrics_summary()
    for res in results.values():
        if res.status != "completed" or len(res.tokens) != 32:
            raise AssertionError(f"request {res.request_id} ended "
                                 f"{res.status} with {len(res.tokens)} "
                                 "tokens")
        if not all(map(math.isfinite, res.entropies + res.margins)):
            raise AssertionError(f"request {res.request_id}: non-finite "
                                 "trust signals")
    if len(results) != len(requests):
        raise AssertionError(f"{len(results)} of {len(requests)} done")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    if launches["paged_attention"] != cfg.n_layer * summary["decode_ticks"]:
        raise AssertionError(f"decode launches {launches} != n_layer x "
                             f"{summary['decode_ticks']} ticks")
    if summary["prefix_hits"] == 0:
        raise AssertionError("traffic produced no prefix-cache hit")

    _, plain_results, plain_wall = serve_smoke(cfg, params, "plain",
                                               requests)
    compared = near_ties = 0
    ent_err = mar_err = 0.0
    for rid, (prompt, temp) in enumerate(requests):
        if temp > 0.0:
            continue
        mine, ref = results[rid], plain_results[rid]
        for i, (a, b) in enumerate(zip(mine.tokens, ref.tokens)):
            if a != b:
                if ref.margins[i] >= NEAR_TIE_MARGIN:
                    raise AssertionError(
                        f"request {rid} token {i}: kernel path {a} != plain "
                        f"path {b} at plain margin {ref.margins[i]}")
                near_ties += 1
                break
            compared += 1
            ent_err = max(ent_err, abs(mine.entropies[i] - ref.entropies[i]))
            mar_err = max(mar_err, abs(mine.margins[i] - ref.margins[i]))
    if compared == 0 or ent_err > SERVE_ENTROPY_ATOL \
            or mar_err > SERVE_MARGIN_ATOL:
        raise AssertionError(
            f"greedy streams vs plain path over {compared} agreeing tokens: "
            f"entropy err {ent_err} (limit {SERVE_ENTROPY_ATOL}), margin err "
            f"{mar_err} (limit {SERVE_MARGIN_ATOL})")
    for name, n in launches.items():
        key = {"paged_attention": "paged_decode_attention"}.get(name, name)
        entries[key]["launches"] = n
    emit({"phase": "serve", "card": card, "model": "gpt2 (12L, 768, 12H, V50257, bf16, "
          "random init seed 0)", "requests": len(requests),
          "wall_s": wall, "plain_path_wall_s": plain_wall,
          "tokens_per_s": summary["tokens_per_s"],
          "ttft_p50_ms": summary.get("ttft_p50_ms"),
          "ttft_p99_ms": summary.get("ttft_p99_ms"),
          "itl_p50_ms": summary.get("itl_p50_ms"),
          "itl_p99_ms": summary.get("itl_p99_ms"),
          "itl_samples": summary["itl_samples"],
          "decode_ticks": summary["decode_ticks"],
          "prefill_chunks": summary["prefill_chunks"],
          "prefix_hits": summary["prefix_hits"],
          "mean_occupancy": summary["mean_occupancy"],
          "launches": launches,
          "greedy_tokens": 32 * sum(temp == 0.0 for _, temp in requests),
          "greedy_tokens_compared": compared,
          "greedy_streams_split_at_near_tie": near_ties,
          "greedy_entropy_max_abs_err": ent_err,
          "greedy_margin_max_abs_err": mar_err,
          "near_tie_margin": NEAR_TIE_MARGIN})


def main() -> int:
    card = one_card()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from trustworthy_dl_tpu_torch import ops
        from trustworthy_dl_tpu_torch.ops import paged_attention as pa
    except ImportError as exc:
        print(f"chip_smoke: run from the repo root ({exc})", file=sys.stderr)
        return 1
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: {torch.cuda.device_count()} cards visible, "
              "want 1", file=sys.stderr)
        return 1
    smi = nvidia_smi_line(card)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    built = ops.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": built})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = check_kernels(torch, pa)
    emit({"phase": "kernel_checks", "ok": True})
    serve_drive(torch, pa, entries, smi)
    emit({"kernels": list(entries.values())})
    print(nvidia_smi_line(card), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
