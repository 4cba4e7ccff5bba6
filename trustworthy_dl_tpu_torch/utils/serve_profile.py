"""Where a serve run's time goes on the card.

    python -m trustworthy_dl_tpu_torch.utils.serve_profile [--attn-impl kernel]
        [--kv-dtype int8] [--weight-dtype int8] [--spec-k 4]
        [--adapter-rank 16 [--adapter-dtype int8]]

Serves the smoke traffic (:func:`smoke_traffic`, the same 16 requests
``chip_smoke.py`` drives; with ``--adapter-rank`` from the tenants of
:func:`smoke_adapter_traffic`) on GPT-2 small (bf16, random weights from
seed 0) once without and once under ``torch.profiler``, and prints one JSON
line: the unprofiled wall time, the profiled one, the device time summed
over kernels and its share of the unprofiled wall (the rest is the
device's idle share), and the top kernels by device time with their call
counts.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

import numpy as np
import torch


def smoke_traffic(vocab: int) -> List[Tuple[List[int], float]]:
    """16 (prompt, temperature) requests: 8 prompts of 96-320 tokens
    (multi-chunk prefill) and 8 sharing a 128-token system prefix with
    16-64 token tails (prefix-cache resumes); 12 greedy, 4 sampled at 0.8.
    The first shared-prefix request goes first, so its prefix is
    published before the others arrive."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, 128).tolist()
    longs = [rng.integers(0, vocab, int(n)).tolist()
             for n in rng.integers(96, 321, size=8)]
    shared = [system + rng.integers(0, vocab, int(n)).tolist()
              for n in rng.integers(16, 65, size=8)]
    prompts = [shared[0]] + longs[:7] + shared[1:] + [longs[7]]
    return [(p, 0.8 if i % 4 == 3 else 0.0) for i, p in enumerate(prompts)]


#: Adapters the smoke's Zipf tenant map draws from (one per tenant).
SMOKE_ADAPTERS = 8


def smoke_adapter_traffic(n_requests: int):
    """(tenant of each request, tenant -> adapter map, adapter pool pages)
    of the adapter drives: request i comes from tenant ``i % 8`` of
    ``make_tenant_population(8)``, the map is
    ``zipf_adapter_assignments`` over :data:`SMOKE_ADAPTERS` adapters
    (seed 0), and the pool holds one page fewer than the distinct adapters
    the map assigns (at least 1), so the drive evicts."""
    from trustworthy_dl_tpu_torch.serve.workload import (
        make_tenant_population, zipf_adapter_assignments)

    names = [t.name for t in make_tenant_population(8)]
    adapter_map = zipf_adapter_assignments(names, SMOKE_ADAPTERS, seed=0)
    pages = max(len(set(adapter_map.values())) - 1, 1)
    return ([names[i % len(names)] for i in range(n_requests)], adapter_map,
            pages)


def smoke_engine(cfg, params, attn_impl: str, **engine_kwargs):
    """A fresh engine with the smoke geometry (8 slots, 512 positions,
    16-token blocks, 64-token chunks unless ``engine_kwargs`` say
    otherwise, prefix cache); ``engine_kwargs`` pass through to
    ``ServingEngine`` (``kv_dtype``, ``weight_dtype``, ``spec_k``,
    ``prefill_chunk``, ...)."""
    from trustworthy_dl_tpu_torch.serve import ServingEngine

    kwargs = dict(max_slots=8, max_seq=512, block_size=16, prefill_chunk=64,
                  prefix_cache=True, attn_impl=attn_impl, device="cuda")
    kwargs.update(engine_kwargs)
    return ServingEngine(params, cfg, **kwargs)


def serve_smoke(cfg, params, attn_impl: str, requests, max_new: int = 32,
                tenants=None, **engine_kwargs):
    """Serve ``requests`` on a fresh :func:`smoke_engine`.  Returns
    (engine, results, wall seconds)."""
    engine = smoke_engine(cfg, params, attn_impl, **engine_kwargs)
    results, wall = drive_smoke(engine, requests, max_new, tenants)
    return engine, results, wall


def drive_smoke(engine, requests, max_new: int = 32, tenants=None):
    """Submit ``requests`` to ``engine`` (request i as ``tenants[i]`` when
    given) and run it until idle.  Returns (results, wall seconds)."""
    from trustworthy_dl_tpu_torch.serve import ServeRequest

    for i, (prompt, temp) in enumerate(requests):
        tenant = tenants[i] if tenants is not None else None
        if engine.submit(ServeRequest(prompt=prompt, max_new_tokens=max_new,
                                      temperature=temp,
                                      tenant=tenant)) is None:
            raise RuntimeError("request shed by backpressure")
    t0 = time.perf_counter()
    results = engine.run_until_idle()
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def drive_closed_loop(engine, requests, max_new: int = 32):
    """Submit ``requests`` in order, at most one a free row (so a queue
    never outgrows the free rows and an SLO or anomaly watcher has nothing
    to shed), stepping ``engine`` until idle.  Returns (results, wall
    seconds)."""
    from trustworthy_dl_tpu_torch.serve import ServeRequest

    pending = list(requests)
    rows = engine.scheduler.allocator.max_slots
    t0 = time.perf_counter()
    while pending or engine.busy:
        while pending and engine.open_requests < rows:
            prompt, temp = pending.pop(0)
            if engine.submit(ServeRequest(prompt=prompt,
                                          max_new_tokens=max_new,
                                          temperature=temp)) is None:
                raise RuntimeError("request shed by backpressure")
        engine.step()
    torch.cuda.synchronize()
    return engine.results, time.perf_counter() - t0


#: The engine steps ``busy_window`` profiles by default: steady decode
#: ticks of the smoke traffic (each wave of 8 requests decodes ~31).
BUSY_FIRST, BUSY_LAST = 12, 27


def busy_window(engine, requests, max_new: int = 32, first: int = BUSY_FIRST,
                last: int = BUSY_LAST) -> dict:
    """Submit ``requests`` to ``engine`` and step it until idle, with the
    profiler recording device activity only from the start of step
    ``first`` to the start of step ``last + 1``: the window's wall, the
    device time (kernels and copies) in it and their ratio, the device's
    busy share.  A window, not the whole run: reading a whole serve run's
    trace back takes the profiler far longer than the run itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from trustworthy_dl_tpu_torch.serve import ServeRequest

    found = {}

    def ready(prof):
        found["device_s"] = sum(
            device_us(e) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("tddl.")) / 1e6

    for prompt, temp in requests:
        if engine.submit(ServeRequest(prompt=prompt, max_new_tokens=max_new,
                                      temperature=temp)) is None:
            raise RuntimeError("request shed by backpressure")
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=first - 1, warmup=1,
                                     active=last - first + 1, repeat=1),
                   on_trace_ready=ready)
    marks = []
    with prof:
        while engine.busy:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            prof.step()          # engine step i is profiler step i
            engine.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
    if len(marks) <= last + 1 or "device_s" not in found:
        raise RuntimeError(f"busy_window: {len(marks) - 1} steps; the "
                           f"window needs more than {last + 1}")
    wall = marks[last] - marks[first - 1]
    return {"steps": [first, last], "wall_s": wall,
            "device_kernel_s": found["device_s"],
            "busy_share": found["device_s"] / wall}


def device_us(evt) -> float:
    """Device microseconds of a profiler row (the attribute's name differs
    between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--attn-impl", default="kernel",
                        choices=["kernel", "plain"])
    parser.add_argument("--kv-dtype", default="model",
                        choices=["model", "bfloat16", "float32", "int8"])
    parser.add_argument("--weight-dtype", default="model",
                        choices=["model", "int8"])
    parser.add_argument("--spec-k", type=int, default=0)
    parser.add_argument("--prefill-chunk", type=int, default=64,
                        help="0 = the engine's default for the pool")
    parser.add_argument("--adapter-rank", type=int, default=0,
                        help="> 0: the adapters arm (smoke tenants)")
    parser.add_argument("--adapter-dtype", default="model",
                        choices=["model", "int8"])
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    knobs = dict(kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
                 spec_k=args.spec_k, prefill_chunk=args.prefill_chunk or None)
    tenants = None
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trustworthy_dl_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    adapter_map = None
    if args.adapter_rank > 0:
        tenants, adapter_map, pages = smoke_adapter_traffic(len(requests))
        knobs.update(adapter_rank=args.adapter_rank, adapter_pool_pages=pages,
                     adapter_dtype=args.adapter_dtype)
    serve_smoke(cfg, params, args.attn_impl, requests[:1],  # warm-up
                tenants=tenants and tenants[:1], adapter_map=adapter_map,
                **knobs)
    engine, _, wall = serve_smoke(cfg, params, args.attn_impl, requests,
                                  tenants=tenants, adapter_map=adapter_map,
                                  **knobs)
    summary = engine.metrics_summary()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, prof_wall = serve_smoke(cfg, params, args.attn_impl, requests,
                                      tenants=tenants,
                                      adapter_map=adapter_map, **knobs)
    # Device-side events only: an operator's own row repeats the time of
    # the kernels it launched.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernel_us = sum(device_us(e) for e in kernels)
    top = sorted(kernels, key=device_us, reverse=True)[:args.top]
    print(json.dumps({
        "attn_impl": args.attn_impl, **knobs,
        "spec": {k: summary[k] for k in ("spec_ticks", "accepted_rate",
                                         "spec_draft_s", "spec_verify_s")
                 if k in summary},
        "adapters": summary.get("adapters"),
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "profiled_wall_s": prof_wall,
        "device_kernel_s": kernel_us / 1e6,
        # Kernel time barely moves under the profiler; the host does.
        "device_busy_share": kernel_us / 1e6 / wall,
        "tokens_per_s": summary["tokens_per_s"],
        "decode_ticks": summary["decode_ticks"],
        "prefill_chunks": summary["prefill_chunks"],
        "decode_tick_fraction": summary["decode_tick_fraction"],
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": device_us(e) / 1e3} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
