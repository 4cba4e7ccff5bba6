"""Command line of the port: ``python -m trustworthy_dl_tpu_torch.cli
serve|train|experiment``.

``serve`` is the counterpart of ``trustworthy-dl-serve``
(``trustworthy_dl_tpu/cli.py:serve_main``) with the flags the port
supports: it serves GPT-2 from random weights drawn from ``--seed``
(checkpoint loading is not ported yet), drives a synthetic heterogeneous
workload and prints the serving metrics.  ``train`` is the counterpart of
``trustworthy-dl-train`` (``trustworthy_dl_tpu/cli.py:main``) on its
data-parallel path: trusted training of GPT-2, ResNet or VGG over
``--nodes`` logical nodes on ``--dataset`` (default the config's,
``openwebtext``; the synthetic source stands in for a corpus or image file
that is absent), validated each epoch on the dataset's validation split,
printing the run's statistics; it checkpoints under
``--checkpoint-dir`` (and at the end), resumes with ``--resume``, and
with ``--supervise`` (or ``--chaos-seed``, a seeded fault plan) runs
under the self-healing supervisor.  ``experiment`` forwards to the
experiment runner (``experiments/runner.main``).  All run on the card
unless ``--device cpu`` is given.
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
    parser.add_argument("--kv-dtype", type=str, default="model",
                        choices=["model", "bfloat16", "float32", "int8"],
                        help="KV pool storage (int8: per-position scales, "
                             "parity-probed at startup)")
    parser.add_argument("--weight-dtype", type=str, default="model",
                        choices=["model", "int8"],
                        help="int8: weight-only int8 block matrices")
    parser.add_argument("--spec-k", type=int, default=0,
                        help="speculative decoding: draft tokens per tick "
                             "with the int8 weight tier (0 = off)")
    parser.add_argument("--adapter-rank", type=int, default=0,
                        help="per-tenant low-rank adapters of this rank "
                             "(0 = off); the synthetic traffic then comes "
                             "from 8 Zipf-weighted tenants")
    parser.add_argument("--adapter-pool-pages", type=int, default=None,
                        help="resident adapter pages (default max-slots)")
    parser.add_argument("--adapter-dtype", type=str, default="model",
                        choices=["model", "int8"])
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
    from trustworthy_dl_tpu_torch.serve.workload import (
        make_tenant_population, zipf_adapter_assignments)

    args = build_serve_parser().parse_args(argv)
    serve_config = ServeConfig(
        max_slots=args.max_slots, max_seq=args.max_seq,
        queue_limit=args.queue_limit, block_size=args.block_size,
        num_blocks=args.num_blocks, prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk, kv_dtype=args.kv_dtype,
        weight_dtype=args.weight_dtype, spec_k=args.spec_k,
        adapter_rank=args.adapter_rank,
        adapter_pool_pages=args.adapter_pool_pages,
        adapter_dtype=args.adapter_dtype)
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
    tenant_names: List[str] = []
    adapter_map = None
    if serve_config.adapter_rank > 0:
        # Tenants for the adapter tier to resolve: a Zipf tenant ->
        # adapter map over one adapter more than the pool's pages, so the
        # run churns the pool (LRU eviction).
        tenant_names = [t.name for t in make_tenant_population(8)]
        pages = args.adapter_pool_pages or args.max_slots
        adapter_map = zipf_adapter_assignments(tenant_names, pages + 1,
                                               seed=args.seed)
    engine = ServingEngine.from_config(
        params, cfg, serve_config, seed=args.seed,
        enable_monitor=not args.no_monitor, device=device,
        adapter_map=adapter_map)
    rng = np.random.default_rng(args.seed)
    deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
    submitted = 0
    for i in range(args.num_requests):
        plen = int(np.clip(rng.integers(max(args.prompt_len // 2, 1),
                                        args.prompt_len * 2 + 1),
                           1, args.max_seq - args.max_new_tokens))
        request = ServeRequest(
            prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
            max_new_tokens=int(rng.integers(1, args.max_new_tokens + 1)),
            temperature=args.temperature, deadline_s=deadline,
            tenant=tenant_names[i % len(tenant_names)]
            if tenant_names else None)
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
                "prefix_hits", "prefix_hit_rate", "kv_dtype", "weight_dtype",
                "kv_fallback_reason", "spec_ticks", "spec_proposed",
                "spec_accepted", "accepted_rate"):
        if key in summary:
            value = summary[key]
            shown = f"{value:.3f}" if isinstance(value, float) else value
            print(f"  {key}: {shown}")
    if summary["quarantined_slots"]:
        print(f"  quarantined_slots: {summary['quarantined_slots']}")
    adapters = summary.get("adapters")
    if adapters:
        print(f"  adapters: rank={adapters['rank']} "
              f"dtype={adapters['dtype']} pages={adapters['pages']} "
              f"resident={adapters['resident']} "
              f"hit_rate={adapters['hit_rate']:.3f} "
              f"evictions={adapters['evictions']} "
              f"uploads={adapters['uploads']}")
    return 0


def build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli train",
        description="Trust-gated data-parallel training of GPT-2, ResNet "
                    "or VGG (random init) on the card.")
    parser.add_argument("--model", type=str, default="gpt2",
                        help="gpt2[-medium|-large|-xl], resnet32/50/101, "
                             "vgg11/13/16")
    parser.add_argument("--dataset", type=str, default=None,
                        help="openwebtext, wikitext, cifar10, cifar100, "
                             "imagenet, ... (default: the config's)")
    parser.add_argument("--nodes", type=int, default=4)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--learning-rate", type=float, default=5e-5)
    parser.add_argument("--seq-len", type=int, default=128,
                        help="token window (language models)")
    parser.add_argument("--no-detection", action="store_true",
                        help="disable the in-step attack detector")
    parser.add_argument("--steps-per-epoch", type=int, default=50,
                        help="synthetic-data epoch length")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint every transformer block")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cpu runs every kernel's plain PyTorch version")
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoint before training")
    parser.add_argument("--async-host-depth", type=int, default=None,
                        help="steps kept in flight by the async host "
                             "pipeline (engine/async_host.py): dispatch "
                             "runs up to this many steps ahead of the "
                             "host bookkeeping, which reads one packed "
                             "device-to-host copy a step; 0 = "
                             "synchronous (config default: 2).  Chaos "
                             "drills asserting exact retry counts need 0")
    # The self-healing supervisor (engine/supervisor.py) and chaos drills.
    parser.add_argument("--supervise", action="store_true",
                        help="wrap training in the self-healing supervisor: "
                             "non-finite step guard, bounded retries, "
                             "verified-checkpoint rollback, SIGTERM "
                             "save-on-signal and capped auto-resume")
    parser.add_argument("--max-retries", type=int, default=2,
                        help="per-step retry budget before a step counts "
                             "as bad (supervisor)")
    parser.add_argument("--rollback-after", type=int, default=3,
                        help="consecutive bad steps before rolling back to "
                             "the last verified checkpoint (supervisor)")
    parser.add_argument("--max-restarts", type=int, default=3,
                        help="auto-resume budget after preemptions "
                             "(supervisor)")
    parser.add_argument("--chaos-seed", type=int, default=None,
                        help="run under a seeded chaos fault plan (implies "
                             "--supervise): non-finite state, stalls, lost "
                             "batches, preemptions, checkpoint crashes and "
                             "corruption (chaos/plan.py)")
    parser.add_argument("--chaos-rate", type=float, default=0.02,
                        help="per-step probability of each drill fault "
                             "kind under --chaos-seed")
    return parser


def train_main(argv: Optional[List[str]] = None,
               model_overrides: Optional[dict] = None) -> int:
    """Entry point of ``train``; ``model_overrides`` shrinks the model
    (tests)."""
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    args = build_train_parser().parse_args(argv)
    config = TrainingConfig(
        model_name=args.model, num_nodes=args.nodes,
        **({"dataset_name": args.dataset} if args.dataset else {}),
        num_epochs=args.epochs, batch_size=args.batch_size,
        learning_rate=args.learning_rate, remat=args.remat, seed=args.seed,
        attack_detection_enabled=not args.no_detection,
        **({"checkpoint_dir": args.checkpoint_dir}
           if args.checkpoint_dir else {}),
        **({"async_host_depth": args.async_host_depth}
           if args.async_host_depth is not None else {}))
    lm = not args.model.lower().startswith(("resnet", "vgg"))
    overrides = {**({"seq_len": args.seq_len} if lm else {}),
                 **(model_overrides or {})}
    trainer = DistributedTrainer(config, model_overrides=overrides,
                                 device=args.device)
    trainer.initialize()
    print(f"training {args.model} from random init (seed {args.seed}) on "
          f"{trainer.device} over {args.nodes} node(s)")
    if args.resume:
        trainer.load_checkpoint()
        print(f"resumed from checkpoint step {trainer.global_step}")
    num_examples = args.batch_size * args.steps_per_epoch
    # The loader by model kind: token windows need the LM's geometry.
    geometry = dict(seq_len=args.seq_len,
                    vocab_size=trainer.model.config.vocab_size) \
        if trainer.model.kind == "lm" else {}
    train_dl = get_dataloader(
        config.dataset_name, split="train", batch_size=args.batch_size,
        num_examples=num_examples, seed=args.seed, **geometry)
    val_dl = get_dataloader(
        config.dataset_name, split="validation", batch_size=args.batch_size,
        num_examples=max(num_examples // 10, args.batch_size),
        seed=args.seed, **geometry)
    if args.supervise or args.chaos_seed is not None:
        from trustworthy_dl_tpu_torch.chaos import FaultInjector, \
            FaultKind, FaultPlan
        from trustworthy_dl_tpu_torch.engine.supervisor import \
            TrainingSupervisor

        injector = None
        max_restarts = args.max_restarts
        if args.chaos_seed is not None:
            horizon = args.steps_per_epoch * config.num_epochs
            rate = args.chaos_rate
            plan = FaultPlan.generate(args.chaos_seed, horizon, {
                FaultKind.GRAD_NAN: rate,
                FaultKind.DATA_LOSS: rate,
                FaultKind.STALL: rate,
                FaultKind.PREEMPT: rate / 4,
                FaultKind.CKPT_CRASH: rate / 4,
                FaultKind.CKPT_CORRUPT: rate / 4,
            }, severity=0.05)
            injector = FaultInjector(plan)
            # Every planned preemption costs a restart; keep the budget
            # above the plan so the drill exercises resume, not give-up.
            max_restarts = max(max_restarts,
                               plan.count(FaultKind.PREEMPT) + 1)
            print(f"chaos drill: seed {args.chaos_seed}, "
                  f"{len(plan.events)} fault(s) over {horizon} steps")
        supervisor = TrainingSupervisor(
            trainer, max_retries=args.max_retries,
            rollback_after=args.rollback_after, max_restarts=max_restarts,
            chaos=injector, handle_signals=True)
        result = supervisor.run(train_dl, val_dl)
        print(f"supervisor report: {result['supervisor']}")
    else:
        result = trainer.train(train_dl, val_dl)
    stats = result["stats"]
    for record in result["epochs"]:
        print(f"  epoch {record['epoch']}: train_loss "
              f"{record['train_loss']:.4f} val_loss "
              f"{record['val_loss']:.4f}")
    print(f"Training completed: {stats['global_step']} steps, final state "
          f"{stats['training_state']}, attacks recorded "
          f"{stats['attack_count']}")
    trainer.save_checkpoint()
    trainer.cleanup()
    return 0


def experiment_main(argv: Optional[List[str]] = None) -> int:
    """Entry point of ``experiment``: the experiment runner's command
    line."""
    from trustworthy_dl_tpu_torch.experiments.runner import main as run_main

    return run_main(argv)


COMMANDS = {"serve": serve_main, "train": train_main,
            "experiment": experiment_main}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m trustworthy_dl_tpu_torch.cli "
              "serve|train|experiment [--help | options]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
