"""Command line of the port: ``python -m trustworthy_dl_tpu_torch.cli serve``.

Counterpart of ``trustworthy-dl-serve`` (``trustworthy_dl_tpu/cli.py:
serve_main``) with the flags this slice supports.  It serves GPT-2 from
random weights drawn from ``--seed`` (checkpoint loading is not ported
yet), drives a synthetic heterogeneous workload and prints the serving
metrics.  It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def build_serve_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli serve",
        description="Serve GPT-2 (random weights) with the paged "
                    "continuous-batching engine on the card and print "
                    "serving metrics for a synthetic workload.")
    parser.add_argument("--model", type=str, default="gpt2")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cpu runs every kernel's plain PyTorch version")
    parser.add_argument("--max-slots", type=int, default=8)
    parser.add_argument("--max-seq", type=int, default=256,
                        help="per-request KV depth (prompt + generated)")
    parser.add_argument("--queue-limit", type=int, default=64)
    parser.add_argument("--num-requests", type=int, default=32)
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--prompt-len", type=int, default=16,
                        help="mean synthetic prompt length")
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--deadline-ms", type=float, default=None)
    parser.add_argument("--no-monitor", action="store_true",
                        help="disable the trust-aware output monitor")
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--num-blocks", type=int, default=None)
    parser.add_argument("--no-prefix-cache", action="store_true")
    parser.add_argument("--prefill-chunk", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    return parser


def serve_main(argv: Optional[List[str]] = None,
               model_overrides: Optional[dict] = None) -> int:
    """Entry point of ``serve``; ``model_overrides`` shrinks the model
    (tests)."""
    import torch

    from trustworthy_dl_tpu_torch.core.config import ServeConfig
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
    from trustworthy_dl_tpu_torch.serve.engine import resolve_device

    args = build_serve_parser().parse_args(argv)
    serve_config = ServeConfig(
        max_slots=args.max_slots, max_seq=args.max_seq,
        queue_limit=args.queue_limit, block_size=args.block_size,
        num_blocks=args.num_blocks, prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk)
    cfg = gpt2.GPT2Config.from_name(args.model, **(model_overrides or {}))
    if args.max_seq > cfg.n_positions:
        print(f"--max-seq {args.max_seq} exceeds the model's "
              f"n_positions={cfg.n_positions}")
        return 2
    if args.prompt_len + args.max_new_tokens > args.max_seq:
        print(f"--prompt-len + --max-new-tokens = "
              f"{args.prompt_len + args.max_new_tokens} exceeds "
              f"--max-seq {args.max_seq}")
        return 2
    device = resolve_device(args.device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = gpt2.init_params(cfg, generator, device=device)
    print(f"serving {args.model} from random init (seed {args.seed}) on "
          f"{device}")
    engine = ServingEngine.from_config(
        params, cfg, serve_config, seed=args.seed,
        enable_monitor=not args.no_monitor, device=device)
    rng = np.random.default_rng(args.seed)
    deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
    submitted = 0
    for _ in range(args.num_requests):
        plen = int(np.clip(rng.integers(max(args.prompt_len // 2, 1),
                                        args.prompt_len * 2 + 1),
                           1, args.max_seq - args.max_new_tokens))
        request = ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=int(rng.integers(1, args.max_new_tokens + 1)),
            temperature=args.temperature, deadline_s=deadline)
        rid = engine.submit(request)
        if rid is None:
            engine.run_until_idle()      # drain, then retry the arrival
            rid = engine.submit(request)
        if rid is not None:
            submitted += 1
    engine.run_until_idle()
    summary = engine.metrics_summary()
    print(f"served {submitted} request(s) on {args.max_slots} slot(s)")
    for key in ("requests_completed", "requests_deadline_exceeded",
                "requests_flagged", "tokens_emitted", "tokens_per_s",
                "itl_p50_ms", "itl_p99_ms", "ttft_p50_ms", "ttft_p99_ms",
                "mean_occupancy", "peak_tokens_in_flight", "blocks_in_use",
                "prefix_hits", "prefix_hit_rate"):
        if key in summary:
            value = summary[key]
            shown = f"{value:.3f}" if isinstance(value, float) else value
            print(f"  {key}: {shown}")
    if summary["quarantined_slots"]:
        print(f"  quarantined_slots: {summary['quarantined_slots']}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] != "serve":
        print("usage: python -m trustworthy_dl_tpu_torch.cli serve "
              "[--help | options]", file=sys.stderr)
        return 2
    return serve_main(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
