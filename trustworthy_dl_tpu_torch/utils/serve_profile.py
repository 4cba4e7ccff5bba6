"""Where a serve run's time goes on the card.

    python -m trustworthy_dl_tpu_torch.utils.serve_profile [--attn-impl kernel]

Serves the smoke traffic (:func:`smoke_traffic`, the same 16 requests
``chip_smoke.py`` drives) on GPT-2 small (bf16, random weights from seed
0) once without and once under ``torch.profiler``, and prints one JSON
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


def serve_smoke(cfg, params, attn_impl: str, requests, max_new: int = 32):
    """Serve ``requests`` on a fresh engine with the smoke geometry (8
    slots, 512 positions, 16-token blocks, 64-token chunks, prefix cache);
    returns (engine, results, wall seconds)."""
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    engine = ServingEngine(params, cfg, max_slots=8, max_seq=512,
                           block_size=16, prefill_chunk=64,
                           prefix_cache=True, attn_impl=attn_impl,
                           device="cuda")
    for prompt, temp in requests:
        if engine.submit(ServeRequest(prompt=prompt, max_new_tokens=max_new,
                                      temperature=temp)) is None:
            raise RuntimeError("request shed by backpressure")
    t0 = time.perf_counter()
    results = engine.run_until_idle()
    torch.cuda.synchronize()
    return engine, results, time.perf_counter() - t0


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--attn-impl", default="kernel",
                        choices=["kernel", "plain"])
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
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
    serve_smoke(cfg, params, args.attn_impl, requests[:1])      # warm-up
    engine, _, wall = serve_smoke(cfg, params, args.attn_impl, requests)
    summary = engine.metrics_summary()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, prof_wall = serve_smoke(cfg, params, args.attn_impl, requests)
    # Device-side events only: an operator's own row repeats the time of
    # the kernels it launched.
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(_device_us(e) for e in kernels)
    top = sorted(kernels, key=_device_us, reverse=True)[:args.top]
    print(json.dumps({
        "attn_impl": args.attn_impl,
        "device": torch.cuda.get_device_name(0),
        "wall_s": wall, "profiled_wall_s": prof_wall,
        "device_kernel_s": device_us / 1e6,
        # Kernel time barely moves under the profiler; the host does.
        "device_busy_share": device_us / 1e6 / wall,
        "tokens_per_s": summary["tokens_per_s"],
        "decode_ticks": summary["decode_ticks"],
        "prefill_chunks": summary["prefill_chunks"],
        "decode_tick_fraction": summary["decode_tick_fraction"],
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
