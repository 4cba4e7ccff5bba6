"""Command line of the port: ``python -m trustworthy_dl_tpu_torch.cli
prepare|generate|serve|train|experiment|obs``.

``prepare`` is the counterpart of ``trustworthy-dl-prepare-data``
(``trustworthy_dl_tpu/cli.py:prepare_main``), host-only: a ``.txt``
corpus to the loader's uint16 ``.bin`` and GPT-2-format tokenizer files
(``data/tokenizer.py``).  ``generate`` is the counterpart of
``trustworthy-dl-generate`` (``generate_main``): it restores the newest
checkpoint under ``--checkpoint-dir`` (random init, said so, when there
is none) and samples a continuation of ``--prompt`` token ids or of
``--prompt-text`` through ``--tokenizer-dir``, top-k 40 at temperature
0.8 by default.  ``serve`` is the counterpart of ``trustworthy-dl-serve``
(``serve_main``) with the flags the port supports: the same restore as
``generate``, then a synthetic heterogeneous workload through the paged
engine (the legacy stripe pool with ``--legacy-stripe``) and the serving
metrics; ``--no-spec-decode`` forces ``--spec-k`` to 0, and a ``--spec-k``
past ``--max-new-tokens`` is refused (rc 2).  ``serve --fleet-replicas N``
(N > 1) serves the seeded workload generator's traffic through a
``serve.ServingFleet`` of N replicas (``--hedge-deadline-ms``,
``--vote-k``, ``--vote-outvote-limit``, ``--no-live-migration``) and prints
JAX's fleet summary; the control plane's flags (``--autoscale-min``,
``--autoscale-max``, ``--tenant-quota``, ``--tenant-quota-refill``,
``--slo-class``, ``--pool-roles``) parse with JAX's defaults and errors
(rc 2), and any of the first four serves through a fleet even at one
replica.  Both refuse the non-GPT-2
and MoE families and a checkpoint trained with pipeline parallelism (rc
2), and fail loudly on a checkpoint whose weights do not fit the model.
``train`` is the counterpart of ``trustworthy-dl-train``
(``trustworthy_dl_tpu/cli.py:main``): trusted training of GPT-2 (dense or
MoE), ResNet or VGG over logical nodes on the configured dataset (the
synthetic source stands in for a corpus or image file that is absent),
validated each epoch on the dataset's validation split, printing the
run's statistics; ``--parallelism`` takes JAX's modes and trains each:
``data``, ``model`` (pipeline stages of the dense GPT-2 family),
``sequence`` (ring attention), ``tensor`` and ``expert`` (without a mesh,
JAX's one-device layout: one position, a ring or TP group of 1) and
``hybrid``, which needs the config's ``mesh_shape`` (JAX's "requires
mesh_shape" error otherwise) and runs on as many positions of the device
as it names; what the port cannot run (a DCN extent above 1) exits 2
naming its ROADMAP item.  Its configuration is
``core.config.load_config(--config)`` or the ``TrainingConfig``
defaults, with only the flags given on top; it checkpoints under the
configured directory (and at the end), resumes with ``--resume``, and
with ``--supervise`` (or ``--chaos-seed``, a seeded fault plan) runs
under the self-healing supervisor.  ``experiment`` forwards to the
experiment runner (``experiments/runner.main``), which always writes its
telemetry under ``<output_dir>/<name>/obs``.  All but ``prepare`` run on
the card unless ``--device cpu`` is given.

``train --obs-dir DIR`` and ``serve --obs-dir DIR`` attach an
``obs.ObsSession`` and write its artifacts there, as the JAX commands do:
``trace.jsonl`` (rotated past ``--trace-max-bytes``),
``metrics_snapshot.json`` and ``metrics.prom``, ``obs_report.json`` (with
the cost ledger and the analyzed-FLOPs MFU), ``slo_status.json``,
``trace_events.json`` (Chrome/Perfetto), ``PERF_LEDGER.jsonl`` (the perf
sentinel's fingerprints; ``TDDL_PERF_LEDGER`` names another file), with
forensics ``incident_*.json`` beside each flight dump and
``VERDICTS.jsonl``, and for ``serve`` ``attribution.jsonl``; the
supervisor's flight dumps and their incidents land beside the
checkpoints.  Both run under the compile watcher and print the compile
count, the storms and the sentinel's verdict.  ``serve``'s SLO rules take
``--slo-ttft-ms`` and ``--slo-itl-ms``.  ``train --compile-cache`` and
``serve --compile-cache`` point the kernel-build cache
(``utils/compile_cache.py``) at ``<obs-dir or checkpoint-dir>/kernel_cache``
(JAX's flag names ``jax_cache`` there, XLA's cache), so a repeat run loads
the kernel and native libraries instead of building them.

``obs`` is the counterpart of ``trustworthy-dl-obs`` (``obs_main``), the
reader of such a directory: tail and filter the trace, a Chrome timeline,
the report and the SLO status, ``obs diff A B`` and ``obs incident
list|show|blast``.  It runs on the host and imports no torch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np


def _kernel_cache_dir(run_dir: str) -> str:
    """``--compile-cache``'s directory under a run directory."""
    return os.path.join(run_dir, "kernel_cache")


def _dense_gpt2(model: str) -> bool:
    return model.startswith("gpt") and not model.endswith("-moe")


def _refuses_pipeline_checkpoint(checkpoint_dir: str, what: str) -> bool:
    """True (after saying why) when the newest checkpoint under
    ``checkpoint_dir`` was trained with pipeline parallelism: its block
    params are stage-stacked, another tree than the decoder's.  Reads the
    topology sidecar alone; the restore checks the payload."""
    from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager

    probe = CheckpointManager(checkpoint_dir)
    latest = probe.latest_step(verified=False)
    if latest is None:
        return False
    meta = probe.load_metadata(latest) or {}
    if meta.get("parallelism") == "model":
        print("checkpoint was trained with pipeline (stage) parallelism; "
              f"{what} needs a data-parallel checkpoint (params "
              "stage-stacked)")
        return True
    return False


def _restore_for_inference(trainer: Any, checkpoint_dir: str,
                           what: str) -> Any:
    """The params of the newest verified checkpoint under
    ``checkpoint_dir`` (the trainer adopts the saved node count), or of a
    random init when there is none.  Raises ``ValueError`` when the saved
    weights do not fit the trainer's model: such a checkpoint never turns
    into random weights."""
    step = trainer.checkpointer.latest_step()
    if step is None:
        print(f"no checkpoint under {checkpoint_dir!r}; {what} from random "
              "init")
        trainer.initialize()
        return trainer.state.params
    try:
        trainer.load_checkpoint(step)
    except (ValueError, RuntimeError, KeyError) as exc:
        raise ValueError(f"the checkpoint under {checkpoint_dir!r} does not "
                         f"fit this model: {exc}") from exc
    from trustworthy_dl_tpu_torch.engine.checkpoint import leaf_shapes

    # A checkpoint of another structure restores by name, keeping the
    # template's values where it lacks a weight: compare the saved leaf
    # table with the model's weights.
    saved = trainer.checkpointer.saved_shapes(step, "params")
    ours = leaf_shapes(trainer.state.params)
    if saved != ours:
        differ = sorted(set(saved.items()) ^ set(ours.items()))
        raise ValueError(
            f"the checkpoint under {checkpoint_dir!r} (step {step}) does "
            f"not fit this model: weights (path, shape) not in both "
            f"{differ[:4]}")
    print(f"restored step {step} from {checkpoint_dir}")
    return trainer.state.params


def _inference_trainer(args: Any, model_overrides: Optional[dict]) -> Any:
    """A one-node trainer for ``args.model`` over ``args.checkpoint_dir``
    (JAX's ``TrainingConfig(num_nodes=1, batch_size=1)``): the model
    config and the checkpoint restore of ``generate`` and ``serve``."""
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    config = TrainingConfig(model_name=args.model, num_nodes=1,
                            batch_size=1,
                            checkpoint_dir=args.checkpoint_dir,
                            seed=args.seed)
    return DistributedTrainer(config, model_overrides=model_overrides,
                              device=args.device)


def build_prepare_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli prepare",
        description="Tokenize a raw .txt corpus into the loader's .bin "
                    "token memmap (byte-level BPE, trained on the corpus "
                    "or loaded from GPT-2-format vocab.json/merges.txt)")
    parser.add_argument("txt", type=str, help="input UTF-8 text file")
    parser.add_argument("--out", type=str, default=None,
                        help="output .bin path (default: alongside input)")
    parser.add_argument("--vocab-size", type=int, default=8192)
    parser.add_argument("--tokenizer-dir", type=str, default=None,
                        help="directory holding (or to receive) "
                             "vocab.json + merges.txt")
    parser.add_argument("--val-fraction", type=float, default=0.0,
                        help="also write a *_val.bin holdout split")
    return parser


def prepare_main(argv: Optional[List[str]] = None) -> int:
    """Entry point of ``prepare``: the offline .txt -> .bin step, on the
    host."""
    from trustworthy_dl_tpu_torch.data.tokenizer import prepare_data

    args = build_prepare_parser().parse_args(argv)
    if not os.path.exists(args.txt):
        print(f"no such file: {args.txt}")
        return 2
    info = prepare_data(args.txt, out_path=args.out,
                        vocab_size=args.vocab_size,
                        tokenizer_dir=args.tokenizer_dir,
                        val_fraction=args.val_fraction)
    print(f"wrote {info['num_tokens']} tokens (vocab {info['vocab_size']}) "
          f"to {info['out_path']}"
          + (f" + val split {info['val_path']}" if info["val_path"] else ""))
    print(f"tokenizer files in {info['tokenizer_dir']}")
    return 0


def build_generate_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli generate",
        description="Sample from a trained GPT-2 checkpoint with the "
                    "KV-cache decoder on the card.")
    parser.add_argument("--model", type=str, default="gpt2")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints",
                        help="restore the latest checkpoint from here "
                             "(falls back to a random init, said so, when "
                             "there is none)")
    parser.add_argument("--prompt", type=str, default="1,2,3,4",
                        help="comma-separated token ids")
    parser.add_argument("--prompt-text", type=str, default=None,
                        help="raw text prompt; needs --tokenizer-dir "
                             "(output is decoded back to text)")
    parser.add_argument("--tokenizer-dir", type=str, default=None,
                        help="vocab.json + merges.txt directory (the "
                             "prepare command writes one)")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.8)
    parser.add_argument("--top-k", type=int, default=40)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the sampling torch.Generator (and of "
                             "the random init without a checkpoint)")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cpu runs the decoder on the CPU")
    return parser


def generate_main(argv: Optional[List[str]] = None,
                  model_overrides: Optional[dict] = None) -> int:
    """Entry point of ``generate``; ``model_overrides`` shrinks the model
    (tests), the command line restores what the checkpoint was trained
    as."""
    import torch

    from trustworthy_dl_tpu_torch.models.generate import generate

    args = build_generate_parser().parse_args(argv)
    if not _dense_gpt2(args.model):
        print("generation supports the dense GPT-2 family")
        return 2
    if _refuses_pipeline_checkpoint(args.checkpoint_dir, "generation"):
        return 2
    # The prompt is checked before the restore: the int parse needs
    # nothing, the vocab bound only the model config.
    tokenizer = None
    if args.prompt_text is not None:
        if not args.tokenizer_dir:
            print("--prompt-text requires --tokenizer-dir")
            return 2
        from trustworthy_dl_tpu_torch.data.tokenizer import BPETokenizer

        try:
            tokenizer = BPETokenizer.load(args.tokenizer_dir)
        except (OSError, ValueError) as exc:
            print(f"could not load tokenizer from {args.tokenizer_dir!r}: "
                  f"{exc}")
            return 2
        tokens = tokenizer.encode(args.prompt_text)
    else:
        try:
            tokens = [int(t) for t in args.prompt.split(",") if t.strip()]
        except ValueError:
            print(f"--prompt must be comma-separated token ids, got "
                  f"{args.prompt!r}")
            return 2
    trainer = _inference_trainer(args, model_overrides)
    vocab = trainer.model.config.vocab_size
    if not tokens or any(not 0 <= t < vocab for t in tokens):
        if tokenizer is not None:
            print(f"--prompt-text encoded to {len(tokens)} token id(s); "
                  f"the model accepts ids in [0, {vocab}) — the tokenizer "
                  f"(vocab {tokenizer.vocab_size}) and model vocabularies "
                  "must be compatible and the prompt non-empty")
        else:
            print(f"--prompt needs at least one token id in [0, {vocab})")
        return 2
    try:
        params = _restore_for_inference(trainer, args.checkpoint_dir,
                                        "sampling")
    except ValueError as exc:
        print(exc)
        return 1
    generator = torch.Generator(device=trainer.device).manual_seed(
        args.seed)
    out = generate(params, trainer.model.config,
                   torch.tensor([tokens], device=trainer.device),
                   max_new_tokens=args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, generator=generator)
    new_ids = out[0, len(tokens):].tolist()
    if tokenizer is not None:
        print("prompt:    ", args.prompt_text)
        print("generated: ", tokenizer.decode(new_ids))
    else:
        print("prompt:    ", tokens)
        print("generated: ", new_ids)
    trainer.cleanup()
    return 0


def build_serve_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli serve",
        description="Serve a GPT-2 checkpoint with the paged "
                    "continuous-batching engine on the card and print "
                    "serving metrics for a synthetic workload.")
    parser.add_argument("--model", type=str, default="gpt2")
    parser.add_argument("--checkpoint-dir", type=str, default="checkpoints",
                        help="restore the latest checkpoint from here "
                             "(falls back to a random init from --seed, "
                             "said so, when there is none)")
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
    parser.add_argument("--legacy-stripe", action="store_true",
                        help="serve from the legacy per-request stripe KV "
                             "pool instead of the paged block pool")
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
    parser.add_argument("--no-spec-decode", action="store_true",
                        help="force speculative decoding off even when "
                             "--spec-k is set (the A/B switch)")
    parser.add_argument("--adapter-rank", type=int, default=0,
                        help="per-tenant low-rank adapters of this rank "
                             "(0 = off); the synthetic traffic then comes "
                             "from 8 Zipf-weighted tenants")
    parser.add_argument("--adapter-pool-pages", type=int, default=None,
                        help="resident adapter pages (default max-slots)")
    parser.add_argument("--adapter-dtype", type=str, default="model",
                        choices=["model", "int8"])
    parser.add_argument("--compile-cache", action="store_true",
                        help="point the kernel-build cache (the nvcc and "
                             "g++ libraries, utils/compile_cache.py) at "
                             "<obs-dir or checkpoint-dir>/kernel_cache, so "
                             "repeat serves load the libraries instead of "
                             "building them")
    parser.add_argument("--obs-dir", type=str, default=None,
                        help="write serving telemetry here: trace.jsonl "
                             "(request lifecycle events + spans "
                             "correlated by request id), "
                             "attribution.jsonl (per-request ledger: "
                             "slot/blocks/weight-tier/verdict), "
                             "slo_status.json, trace_events.json "
                             "(Chrome/Perfetto timeline) + metrics "
                             "snapshot/Prometheus export")
    parser.add_argument("--slo-ttft-ms", type=float, default=2000.0,
                        help="TTFT SLO target per request (needs "
                             "--obs-dir); breaches emit slo_breach "
                             "events, burn the tddl_slo_burn_rate gauge "
                             "and shed lowest-priority admissions")
    parser.add_argument("--slo-itl-ms", type=float, default=250.0,
                        help="inter-token-latency SLO target (needs "
                             "--obs-dir)")
    parser.add_argument("--fleet-replicas", type=int, default=1,
                        help="serve through a ServingFleet of N engine "
                             "replicas on the card (lifecycle "
                             "supervision, trust-aware routing, fail-over "
                             "with bounded retries, drain and "
                             "quarantine); 1 = one engine (default)")
    parser.add_argument("--pool-roles", type=str, default=None,
                        metavar="ROLE[,ROLE...]",
                        help="fleet: disaggregate the replicas into "
                             "prefill and decode pools, one comma-"
                             "separated role per replica ('prefill' or "
                             "'decode', at least one of each); requests "
                             "prefill on a prefill replica and move to a "
                             "decode replica at their first decode token "
                             "as a live KV block copy")
    parser.add_argument("--no-live-migration", action="store_true",
                        help="fleet: no live KV block migration (drains "
                             "run out, failures replay from the prompt)")
    parser.add_argument("--hedge-deadline-ms", type=float, default=None,
                        help="fleet: launch a hedged duplicate on a "
                             "second replica when a request's remaining "
                             "deadline drops below this")
    parser.add_argument("--vote-k", type=int, default=0,
                        help="fleet: replay a suspected replica's "
                             "completed requests on this many others and "
                             "majority-vote the streams (0 = off)")
    parser.add_argument("--vote-outvote-limit", type=int, default=2,
                        help="fleet: outvoted verdicts before the suspect "
                             "enters the drain -> quarantine ladder")
    parser.add_argument("--autoscale-min", type=int, default=None,
                        help="fleet: autoscaler floor; with "
                             "--autoscale-max it enables the autoscaler "
                             "(scale-up builds a replica, scale-down "
                             "drains one); --fleet-replicas is the "
                             "starting count inside [min, max] (default "
                             "min: --fleet-replicas)")
    parser.add_argument("--autoscale-max", type=int, default=None,
                        help="fleet: autoscaler ceiling")
    parser.add_argument("--tenant-quota", type=int, default=None,
                        help="fleet: per-tenant token-bucket capacity (a "
                             "submission costs prompt + max_new tokens; "
                             "over-budget submissions are throttled)")
    parser.add_argument("--tenant-quota-refill", type=float, default=None,
                        help="fleet: bucket refill in tokens per fleet "
                             "tick (default: capacity / 64)")
    parser.add_argument("--slo-class", action="append", default=None,
                        metavar="NAME:PRIO:TTFT_MS:ITL_MS:WEIGHT",
                        help="fleet, repeatable: an SLO class (priority "
                             "orders shedding, higher sheds last; weight "
                             "scales its DRR share; '-' leaves a target "
                             "untracked); the single value 'default' "
                             "installs the batch/standard/premium "
                             "ladder")
    parser.add_argument("--trace-max-bytes", type=int, default=0,
                        help="rotate trace.jsonl once it exceeds this "
                             "many bytes (trace.1.jsonl, ...; 0 = no "
                             "rotation; env TDDL_TRACE_MAX_BYTES is the "
                             "default)")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def _parse_slo_classes(specs: Optional[List[str]]) -> Any:
    """``--slo-class NAME:PRIO:TTFT_MS:ITL_MS:WEIGHT`` (repeatable; '-'
    leaves a latency target untracked; the single spec 'default' installs
    the built-in ladder).  Raises ValueError naming the offending spec."""
    if not specs:
        return None
    from trustworthy_dl_tpu_torch.serve import DEFAULT_SLO_CLASSES, \
        SLOClass

    if len(specs) == 1 and specs[0].strip().lower() == "default":
        return DEFAULT_SLO_CLASSES
    classes = []
    for spec in specs:
        parts = spec.split(":")
        if len(parts) != 5:
            raise ValueError(
                f"--slo-class {spec!r}: expected "
                "NAME:PRIO:TTFT_MS:ITL_MS:WEIGHT (use '-' for an "
                "untracked target), or the single value 'default'")
        name, prio, ttft, itl, weight = (p.strip() for p in parts)
        try:
            classes.append(SLOClass(
                name=name, priority=int(prio),
                ttft_target_s=(None if ttft in ("-", "")
                               else float(ttft) / 1e3),
                itl_target_s=(None if itl in ("-", "")
                              else float(itl) / 1e3),
                weight=float(weight)))
        except ValueError as exc:
            raise ValueError(f"--slo-class {spec!r}: {exc}")
    return tuple(classes)


def _parse_autoscale(args: Any) -> Any:
    """``--autoscale-min/--autoscale-max`` -> ``AutoscalerConfig`` (None
    when neither is given); ``--fleet-replicas`` is the starting count and
    must sit inside the bounds."""
    if args.autoscale_min is None and args.autoscale_max is None:
        return None
    from trustworthy_dl_tpu_torch.serve import AutoscalerConfig

    lo = (args.autoscale_min if args.autoscale_min is not None
          else args.fleet_replicas)
    hi = (args.autoscale_max if args.autoscale_max is not None
          else max(args.fleet_replicas, lo))
    if not lo <= args.fleet_replicas <= hi:
        raise ValueError(
            f"--fleet-replicas {args.fleet_replicas} must start inside "
            f"the autoscale bounds [{lo}, {hi}]")
    return AutoscalerConfig(
        min_replicas=lo, max_replicas=hi,
        scale_up_queue_per_replica=float(args.max_slots),
        scale_down_queue_per_replica=max(args.max_slots / 8.0, 0.5),
        itl_p99_target_s=(args.slo_itl_ms / 1e3
                          if args.obs_dir else None))


def _control_plane(args: Any) -> Dict[str, Any]:
    """The fleet's control-plane fields from ``serve``'s flags (ValueError
    on a bad value)."""
    tenant_quota = None
    if args.tenant_quota is not None:
        from trustworthy_dl_tpu_torch.serve import TenantQuotaConfig

        refill = (args.tenant_quota_refill
                  if args.tenant_quota_refill is not None
                  else args.tenant_quota / 64.0)
        tenant_quota = TenantQuotaConfig(capacity_tokens=args.tenant_quota,
                                         refill_per_tick=refill)
    pool_roles = None
    if args.pool_roles:
        pool_roles = tuple(r.strip() for r in args.pool_roles.split(","))
    return dict(slo_classes=_parse_slo_classes(args.slo_class),
                autoscale=_parse_autoscale(args),
                tenant_quota=tenant_quota, pool_roles=pool_roles)


def serve_main(argv: Optional[List[str]] = None,
               model_overrides: Optional[dict] = None) -> int:
    """Entry point of ``serve``; ``model_overrides`` shrinks the model
    (tests)."""
    from trustworthy_dl_tpu_torch.core.config import ServeConfig
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
    from trustworthy_dl_tpu_torch.serve.workload import (
        make_tenant_population, zipf_adapter_assignments)

    args = build_serve_parser().parse_args(argv)
    if not _dense_gpt2(args.model):
        print("serving supports the dense GPT-2 family")
        return 2
    spec_k = 0 if args.no_spec_decode else args.spec_k
    if spec_k > args.max_new_tokens:
        print(f"--spec-k {spec_k} exceeds --max-new-tokens "
              f"{args.max_new_tokens}: every draft past the request "
              "budget is discarded; lower --spec-k")
        return 2
    serve_config = ServeConfig(
        max_slots=args.max_slots, max_seq=args.max_seq,
        queue_limit=args.queue_limit, paged=not args.legacy_stripe,
        block_size=args.block_size,
        num_blocks=args.num_blocks, prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk, kv_dtype=args.kv_dtype,
        weight_dtype=args.weight_dtype, spec_k=spec_k,
        adapter_rank=args.adapter_rank,
        adapter_pool_pages=args.adapter_pool_pages,
        adapter_dtype=args.adapter_dtype)
    if _refuses_pipeline_checkpoint(args.checkpoint_dir, "serving"):
        return 2
    if args.compile_cache:
        from trustworthy_dl_tpu_torch.utils.compile_cache import \
            enable_persistent_cache

        enable_persistent_cache(_kernel_cache_dir(args.obs_dir
                                                  or args.checkpoint_dir))
    trainer = _inference_trainer(args, model_overrides)
    cfg = trainer.model.config
    if args.max_seq > cfg.n_positions:
        print(f"--max-seq {args.max_seq} exceeds the model's "
              f"n_positions={cfg.n_positions}")
        return 2
    if args.prompt_len + args.max_new_tokens > args.max_seq:
        print(f"--prompt-len + --max-new-tokens = "
              f"{args.prompt_len + args.max_new_tokens} exceeds "
              f"--max-seq {args.max_seq}")
        return 2
    try:
        params = _restore_for_inference(trainer, args.checkpoint_dir,
                                        "serving")
    except ValueError as exc:
        print(exc)
        return 1
    device = trainer.device
    # Only the weights go on: the optimizer, trust and detector state of
    # the restored checkpoint are dropped here.
    trainer.cleanup()
    print(f"serving {args.model} on {device}")
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
    obs_session = None
    # Any control-plane knob serves through a fleet, even at one replica:
    # quotas, classes and the autoscaler live in the fleet's tick loop.
    fleet = args.fleet_replicas > 1 or (
        args.autoscale_min is not None or args.autoscale_max is not None
        or args.tenant_quota is not None or bool(args.slo_class))
    if args.obs_dir:
        from trustworthy_dl_tpu_torch.obs import ObsSession
        from trustworthy_dl_tpu_torch.obs.slo import default_serve_rules

        obs_session = ObsSession(args.obs_dir,
                                 trace_max_bytes=args.trace_max_bytes)
        obs_session.enable_spans()
        obs_session.open_ledger()
        # Forensics: every flight-dump-grade episode gets a paired
        # incident_NNN_<reason>.json (causal timeline + blast radius) and
        # a VERDICTS.jsonl row, what 'obs incident' renders offline.
        obs_session.enable_forensics()
        # Performance tier: the compile watcher (the decode loop's
        # compile-once contract held live), the memory gauges and the
        # pool headroom gate, the cost ledger and the perf fingerprint.
        obs_session.enable_compile_watch()
        obs_session.enable_hbm()
        if fleet:
            # A fleet builds per-replica watchers from the SLO flags (a
            # breach is a replica-local signal).
            return _serve_fleet(args, params, cfg, serve_config,
                                obs_session, device, default_serve_rules(
                                    ttft_target_s=args.slo_ttft_ms / 1e3,
                                    itl_target_s=args.slo_itl_ms / 1e3))
        obs_session.install_watchers(slo_rules=default_serve_rules(
            ttft_target_s=args.slo_ttft_ms / 1e3,
            itl_target_s=args.slo_itl_ms / 1e3))
    elif fleet:
        return _serve_fleet(args, params, cfg, serve_config, None, device,
                            None)
    engine = ServingEngine.from_config(
        params, cfg, serve_config, seed=args.seed,
        enable_monitor=not args.no_monitor, device=device,
        adapter_map=adapter_map, obs=obs_session)
    del params
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
                "requests_shed_slo", "requests_flagged", "tokens_emitted", "tokens_per_s",
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
    if obs_session is not None:
        ok, problems = engine.verify_attribution()
        print(f"attribution: {engine.ledger.total} record(s), "
              f"block-lifecycle reconciliation "
              f"{'OK' if ok else 'FAILED'}")
        for problem in problems[:5]:
            print(f"  !! {problem}")
        if obs_session.slo.active:
            print(f"SLO breaches active: {obs_session.slo.active}")
        # The cost ledger's serve programs, a final memory sweep, and the
        # compile watch's verdict (zero storms: the contract held).
        engine.analyze_programs(obs_session.cost_ledger)
        obs_session.hbm.sweep(emit=True)
        compiles = obs_session.compiles.summary()
        print(f"compiles: {compiles['total']} "
              f"({compiles['seconds']:.2f}s), decode storms: "
              f"{obs_session.compilewatch.storm_total}")
        obs_session.finalize()
        print(f"obs artifacts in {args.obs_dir}")
        _print_perf_verdict(obs_session)
    return 0


def _serve_fleet(args: Any, params: Any, cfg: Any, serve_config: Any,
                 obs_session: Any, device: Any, slo_rules: Any) -> int:
    """``serve --fleet-replicas N``: a ``ServingFleet`` over the seeded
    workload generator's traffic (bursty arrivals, heavy-tailed lengths,
    tenant priorities), replayed open loop, with the control plane's
    flags; JAX's summary lines."""
    from trustworthy_dl_tpu_torch.serve import (FleetConfig, ServeRequest,
                                                ServingFleet)
    from trustworthy_dl_tpu_torch.serve.workload import (
        DEFAULT_TENANTS, WorkloadConfig, generate_workload, replay_workload,
        zipf_adapter_assignments)

    try:
        control = _control_plane(args)
    except ValueError as exc:
        print(f"control plane: {exc}")
        return 2

    adapter_map = None
    if serve_config.adapter_rank > 0:
        # The workload's own tenants, Zipf-mapped onto one adapter more
        # than the pool holds, so the run churns residency.
        adapter_map = zipf_adapter_assignments(
            [t.name for t in DEFAULT_TENANTS],
            (args.adapter_pool_pages or 4) + 1, seed=args.seed)
    fleet = ServingFleet.from_config(
        params, cfg, serve_config,
        fleet_config=FleetConfig(
            num_replicas=args.fleet_replicas,
            hedge_deadline_s=(args.hedge_deadline_ms / 1e3
                              if args.hedge_deadline_ms else None),
            vote_k=args.vote_k,
            vote_outvote_limit=args.vote_outvote_limit,
            live_migration=not args.no_live_migration, **control),
        seed=args.seed, obs=obs_session, slo_rules=slo_rules,
        enable_monitor=not args.no_monitor, device=device,
        adapter_map=adapter_map)
    del params
    workload = generate_workload(
        WorkloadConfig(seed=args.seed, num_requests=args.num_requests,
                       prompt_median=args.prompt_len,
                       output_median=max(args.max_new_tokens // 2, 1),
                       max_output=args.max_new_tokens),
        cfg.vocab_size, args.max_seq)
    deadline = args.deadline_ms / 1e3 if args.deadline_ms else None
    submitted = replay_workload(fleet, workload, lambda item: ServeRequest(
        prompt=list(item.prompt), max_new_tokens=item.max_new_tokens,
        temperature=args.temperature, priority=item.priority,
        deadline_s=(deadline if deadline is not None
                    else item.deadline_s),
        tenant=item.tenant))
    if fleet.autoscaler is not None:
        # Room for a trailing scale-down: the replay ends at drain.
        for _ in range(64):
            fleet.step()
    summary = fleet.metrics_summary()
    print(f"fleet served {submitted} request(s) on "
          f"{args.fleet_replicas} replica(s) x {args.max_slots} slot(s)")
    for key in ("statuses", "completed_tokens", "replica_states", "ticks",
                "fleet_failovers", "fleet_migrations", "fleet_preempts",
                "fleet_hedges", "fleet_drains",
                "fleet_quarantines", "fleet_restarts",
                "fleet_suspicions", "fleet_votes", "fleet_outvotes",
                "fleet_tenant_floods", "fleet_throttles",
                "fleet_scale_ups", "fleet_scale_downs",
                "replicas_in_service", "replica_trace",
                "per_class", "class_queue_depth",
                "replica_suspicion", "replica_slo_active"):
        if key in summary:
            print(f"  {key}: {summary[key]}")
    if obs_session is not None:
        ok, problems = fleet.verify_attribution()
        print(f"attribution: {fleet.ledger.total} record(s), "
              f"fleet block-lifecycle reconciliation "
              f"{'OK' if ok else 'FAILED'}")
        for problem in problems[:5]:
            print(f"  !! {problem}")
        engine = next((r.engine for r in fleet.replicas
                       if r.engine is not None), None)
        if engine is not None:
            engine.analyze_programs(obs_session.cost_ledger)
        obs_session.hbm.sweep(emit=True)
        compiles = obs_session.compiles.summary()
        print(f"compiles: {compiles['total']} "
              f"({compiles['seconds']:.2f}s), decode storms: "
              f"{obs_session.compilewatch.storm_total}")
        obs_session.finalize()
        print(f"obs artifacts in {args.obs_dir}")
        _print_perf_verdict(obs_session)
    return 0


def build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli train",
        description="Trust-gated training of GPT-2 (dense or MoE), "
                    "ResNet or VGG (random init) on the card, data-"
                    "parallel or in pipeline stages.  "
                    "The configuration is --config's file or the "
                    "TrainingConfig defaults; a flag given on the command "
                    "line wins over both.")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML/JSON config: the nested README schema "
                             "(model / training / distributed / security) "
                             "or flat TrainingConfig field names")
    parser.add_argument("--model", type=str, default=None,
                        help="gpt2[-medium|-large|-xl], their MoE variants "
                             "gpt2[-size]-moe (data mode), resnet32/50/101, "
                             "vgg11/13/16 (default: the config's)")
    parser.add_argument("--dataset", type=str, default=None,
                        help="openwebtext, wikitext, cifar10, cifar100, "
                             "imagenet, ... (default: the config's)")
    parser.add_argument("--nodes", type=int, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--learning-rate", type=float, default=None)
    parser.add_argument("--parallelism", type=str, default=None,
                        choices=["data", "model", "tensor", "sequence",
                                 "expert", "hybrid"],
                        help="'data' or 'model' (pipeline stages, dense "
                             "GPT-2); the other modes are refused (rc 2)")
    parser.add_argument("--seq-len", type=int, default=128,
                        help="token window (language models)")
    parser.add_argument("--no-detection", action="store_true",
                        help="disable the in-step attack detector")
    parser.add_argument("--steps-per-epoch", type=int, default=50,
                        help="synthetic-data epoch length")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint every transformer block")
    parser.add_argument("--seed", type=int, default=None,
                        help="init, generator and loader seed (default: "
                             "the config's)")
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
    parser.add_argument("--compile-cache", action="store_true",
                        help="point the kernel-build cache (the nvcc and "
                             "g++ libraries, utils/compile_cache.py) at "
                             "<obs-dir or checkpoint-dir>/kernel_cache, so "
                             "repeat runs load the libraries instead of "
                             "building them")
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
    parser.add_argument("--obs-dir", type=str, default=None,
                        help="write run telemetry here: trace.jsonl "
                             "(structured events with step correlation "
                             "ids), metrics_snapshot.json + metrics.prom "
                             "(registry export), obs_report.json "
                             "(per-phase step-time breakdown + MFU), "
                             "slo_status.json and trace_events.json")
    parser.add_argument("--metrics-snapshot-every", type=int, default=0,
                        help="re-write the metrics snapshot every N steps "
                             "(0 = only at run end); needs --obs-dir")
    parser.add_argument("--trace-max-bytes", type=int, default=0,
                        help="rotate trace.jsonl once it exceeds this "
                             "many bytes (trace.1.jsonl, trace.2.jsonl, "
                             "...; 0 = no rotation; env "
                             "TDDL_TRACE_MAX_BYTES is the default)")
    return parser


def build_parser() -> argparse.ArgumentParser:
    """The parser of ``cli train`` (JAX's ``cli.build_parser``)."""
    return build_train_parser()


def train_main(argv: Optional[List[str]] = None,
               model_overrides: Optional[dict] = None) -> int:
    """Entry point of ``train``; ``model_overrides`` shrinks the model
    (tests)."""
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig, \
        load_config
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    args = build_train_parser().parse_args(argv)
    overrides = {k: v for k, v in {
        "model_name": args.model,
        "dataset_name": args.dataset,
        "num_nodes": args.nodes,
        "num_epochs": args.epochs,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "parallelism": args.parallelism,
        "seed": args.seed,
        "checkpoint_dir": args.checkpoint_dir,
        "async_host_depth": args.async_host_depth,
    }.items() if v is not None}
    if args.no_detection:
        overrides["attack_detection_enabled"] = False
    if args.remat:
        overrides["remat"] = True
    if args.config:
        config = load_config(args.config, **overrides)
    else:
        config = TrainingConfig(**overrides)
    if args.compile_cache:
        config = dataclasses.replace(config, compilation_cache_dir=(
            _kernel_cache_dir(args.obs_dir or config.checkpoint_dir)))
    lm = not config.model_name.lower().startswith(("resnet", "vgg"))
    model_kw = {**({"seq_len": args.seq_len} if lm else {}),
                **(model_overrides or {})}
    try:
        trainer = DistributedTrainer(config, model_overrides=model_kw,
                                     device=args.device)
    except NotImplementedError as exc:
        print(exc)
        return 2
    trainer.initialize()
    print(f"training {config.model_name} from random init (seed "
          f"{config.seed}) on {trainer.device} over {config.num_nodes} "
          "node(s)")
    obs_session = None
    if args.obs_dir:
        from trustworthy_dl_tpu_torch.obs import ObsSession

        obs_session = ObsSession(
            args.obs_dir,
            metrics_snapshot_every=args.metrics_snapshot_every,
            trace_max_bytes=args.trace_max_bytes)
        # Per-step spans (train.step and its phases) and the anomaly
        # watcher on step time, loss and gradient norm; no serving SLO
        # rules, but the step_time_s sketch lands in slo_status.json.
        obs_session.enable_spans()
        obs_session.install_watchers(slo_rules=())
        # Forensics: the supervisor's guard-trip/rollback/preemption dumps
        # each get a paired incident with the causal ladder.
        obs_session.enable_forensics()
        # Performance tier: every library load metered and the train
        # step's compile-once contract held live, the memory watermark,
        # the counted first step (the analyzed MFU) and the fingerprint.
        obs_session.enable_compile_watch()
        obs_session.enable_hbm()
        trainer.attach_obs(obs_session)
    if args.resume:
        trainer.load_checkpoint()
        print(f"resumed from checkpoint step {trainer.global_step}")
    num_examples = config.batch_size * args.steps_per_epoch
    # The loader by model kind: token windows need the LM's geometry.
    geometry = dict(seq_len=args.seq_len,
                    vocab_size=trainer.model.config.vocab_size) \
        if trainer.model.kind == "lm" else {}
    train_dl = get_dataloader(
        config.dataset_name, split="train", batch_size=config.batch_size,
        num_examples=num_examples, seed=config.seed, **geometry)
    val_dl = get_dataloader(
        config.dataset_name, split="validation",
        batch_size=config.batch_size,
        num_examples=max(num_examples // 10, config.batch_size),
        seed=config.seed, **geometry)
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
            chaos=injector, handle_signals=True, obs=obs_session)
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
    if obs_session is not None:
        obs_session.hbm.sweep(emit=True)
        compiles = obs_session.compiles.summary()
        print(f"compiles: {compiles['total']} "
              f"({compiles['seconds']:.2f}s), train-step storms: "
              f"{obs_session.compilewatch.storm_total}")
        obs_session.finalize()
        print(f"obs artifacts in {args.obs_dir}: trace.jsonl, "
              "metrics_snapshot.json, metrics.prom, obs_report.json")
        _print_perf_verdict(obs_session)
    trainer.cleanup()
    return 0


def _print_perf_verdict(obs_session) -> None:
    """One-line sentinel summary at the end of an instrumented run."""
    verdict = obs_session.perf_verdict
    if verdict is None:
        return
    if verdict["regressed"]:
        bad = [f"{c['metric']} {c.get('delta_pct', 0):+.1f}%"
               for c in verdict["checks"] if c.get("regressed")]
        print(f"perf sentinel: REGRESSION vs {verdict['baseline_n']} "
              f"baseline run(s): {', '.join(bad)}")
    else:
        print(f"perf sentinel: within the noise band "
              f"({verdict['baseline_n']} baseline run(s), ledger "
              f"{obs_session.perf_ledger_path})")


def build_obs_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli obs",
        description="Render an obs directory: tail/filter trace.jsonl by "
                    "request/step id (rotated trace.N.jsonl segments are "
                    "walked in order), convert spans to a Chrome/Perfetto "
                    "timeline, pretty-print obs_report.json and the "
                    "SLO/anomaly status.  With no action flags, prints a "
                    "summary of everything the directory holds.  The "
                    "'diff' subcommand (obs diff A B) "
                    "renders two obs_report/perf-ledger artifacts side "
                    "by side with deltas; the 'incident' subcommand "
                    "(obs incident list|show|blast) "
                    "renders assembled incident forensics.",
    )
    parser.add_argument("obs_dir", type=str,
                        help="directory a run wrote with --obs-dir")
    parser.add_argument("--tail", type=int, default=None, metavar="N",
                        help="print the last N trace events (after any "
                             "filters)")
    parser.add_argument("--request-id", type=int, default=None,
                        help="only events correlated to this request id")
    parser.add_argument("--step", type=int, default=None,
                        help="only events correlated to this step id")
    parser.add_argument("--type", type=str, default=None,
                        help="only events of this type (e.g. span, "
                             "anomaly, serve_retire)")
    parser.add_argument("--chrome", type=str, default=None, metavar="OUT",
                        help="convert the trace's span events to a Chrome/"
                             "Perfetto trace_events JSON at OUT (load in "
                             "chrome://tracing or ui.perfetto.dev)")
    parser.add_argument("--report", action="store_true",
                        help="pretty-print obs_report.json (step-time "
                             "breakdown + MFU)")
    parser.add_argument("--slo", action="store_true",
                        help="print SLO burn rates / anomaly status "
                             "(slo_status.json + snapshot gauges)")
    return parser


def obs_main(argv: Optional[List[str]] = None) -> int:
    """Entry point of ``obs``: the reader side of an obs directory
    (host-only; imports no torch)."""
    import json
    import sys as _sys

    from trustworthy_dl_tpu_torch.obs.events import read_jsonl_rotated
    from trustworthy_dl_tpu_torch.obs.spans import chrome_trace_from_events

    if argv is None:
        argv = _sys.argv[1:]
    if argv and argv[0] == "diff":
        return _obs_diff(argv[1:])
    if argv and argv[0] == "incident":
        return _obs_incident(argv[1:])
    args = build_obs_parser().parse_args(argv)
    if not os.path.isdir(args.obs_dir):
        print(f"no such obs directory: {args.obs_dir}")
        return 2
    trace_path = os.path.join(args.obs_dir, "trace.jsonl")
    # Rotated segments (trace.1.jsonl, ...) are walked oldest-first so a
    # size-capped long run reads exactly like an uncapped one.
    events = read_jsonl_rotated(trace_path)

    filtered = events
    if args.request_id is not None:
        filtered = [e for e in filtered
                    if e.get("request_id") == args.request_id]
    if args.step is not None:
        filtered = [e for e in filtered if e.get("step") == args.step]
    if args.type is not None:
        filtered = [e for e in filtered if e.get("type") == args.type]

    acted = False
    if args.tail is not None or args.request_id is not None \
            or args.step is not None or args.type is not None:
        acted = True
        for e in filtered[-(args.tail or 20):]:
            print(json.dumps(e))
    if args.chrome is not None:
        acted = True
        payload = chrome_trace_from_events(events, args.chrome)
        print(f"wrote {len(payload['traceEvents'])} span event(s) to "
              f"{args.chrome}")
    if args.report:
        acted = True
        path = os.path.join(args.obs_dir, "obs_report.json")
        if os.path.exists(path):
            with open(path) as f:
                print(json.dumps(json.load(f), indent=2))
        else:
            print(f"no obs_report.json under {args.obs_dir}")
    if args.slo:
        acted = True
        _print_slo_status(args.obs_dir)
    if not acted:
        _print_obs_summary(args.obs_dir, events)
    return 0


def _obs_diff(argv: List[str]) -> int:
    """``obs diff A B`` — two obs artifact sets side by side (obs dirs,
    obs_report.json files, or PERF_LEDGER.jsonl files; host-only, imports
    no torch)."""
    import argparse as _argparse

    from trustworthy_dl_tpu_torch.obs.sentinel import (
        load_perf_artifact,
        render_diff,
    )

    parser = _argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli obs diff",
        description="Pretty-print two obs_report/perf-ledger artifacts "
                    "side by side: step time, phase fractions, MFU "
                    "(nominal + analyzed), per-program FLOPs/temp "
                    "bytes, compile counts, HBM watermark — with "
                    "relative deltas.",
    )
    parser.add_argument("a", type=str, help="first artifact (obs dir, "
                                            "obs_report.json, or "
                                            "PERF_LEDGER.jsonl)")
    parser.add_argument("b", type=str, help="second artifact")
    args = parser.parse_args(argv)
    try:
        view_a = load_perf_artifact(args.a)
        view_b = load_perf_artifact(args.b)
    except FileNotFoundError as exc:
        print(f"diff: {exc}")
        return 2
    print(render_diff(view_a, view_b))
    return 0


def _obs_incident(argv: List[str]) -> int:
    """``obs incident list|show|blast`` — render the forensic incident
    artifacts a run assembled next to its flight dumps (obs/forensics.py;
    host-only, imports no torch)."""
    import argparse as _argparse

    from trustworthy_dl_tpu_torch.obs.forensics import (
        find_incident,
        load_incidents,
        render_blast,
        render_incident,
    )

    parser = _argparse.ArgumentParser(
        prog="python -m trustworthy_dl_tpu_torch.cli obs incident",
        description="Offline incident forensics: 'list' the assembled "
                    "incident_NNN_<reason>.json reports in a directory, "
                    "'show' one causal timeline (trigger event -> "
                    "contributing signals -> actions taken, each with "
                    "trace seq ids), or 'blast' one blast radius (every "
                    "request that decoded off the suspect's KV blocks "
                    "or adapter page, with per-journal block sets).",
    )
    parser.add_argument("action", choices=("list", "show", "blast"))
    parser.add_argument("ident", nargs="?", default=None,
                        help="incident id, bare index, or reason "
                             "substring (show/blast)")
    parser.add_argument("--dir", dest="directory", default=".",
                        help="directory holding the incident artifacts "
                             "(an obs dir or a checkpoint dir; "
                             "default: cwd)")
    args = parser.parse_args(argv)
    if args.action == "list":
        incidents = load_incidents(args.directory)
        if not incidents:
            print(f"no incident artifacts under {args.directory}")
            return 0
        for inc in incidents:
            radius = inc.get("blast_radius") or {}
            print(f"{inc.get('incident_id'):<40} "
                  f"tick={str(inc.get('tick')):<6} "
                  f"suspects={inc.get('suspect_replicas')} "
                  f"actions={len(inc.get('actions') or [])} "
                  f"blast={len(radius.get('requests') or [])}")
        return 0
    if args.ident is None:
        print(f"incident {args.action}: an incident id (or index, or "
              f"reason substring) is required")
        return 2
    inc = find_incident(args.directory, args.ident)
    if inc is None:
        print(f"no incident matching {args.ident!r} under "
              f"{args.directory}")
        return 2
    print(render_incident(inc) if args.action == "show"
          else render_blast(inc))
    return 0


def _print_slo_status(obs_dir: str) -> None:
    import json

    path = os.path.join(obs_dir, "slo_status.json")
    if os.path.exists(path):
        with open(path) as f:
            status = json.load(f)
        for rule in status.get("slo", {}).get("rules", ()):
            flag = " BREACHED" if rule["active"] else ""
            print(f"  slo {rule['name']:<12} ({rule['signal']} <= "
                  f"{rule['target']:g}): burn {rule['burn_rate']:.2f}"
                  f"{flag}")
        anomaly = status.get("anomaly", {})
        if anomaly:
            print(f"  anomaly events: {anomaly.get('event_total', 0)}, "
                  f"active: {anomaly.get('active', [])}")
        return
    # Fall back to the burn-rate gauges in the metrics snapshot (a run
    # that died before finalize still snapshotted on cadence).
    snap_path = os.path.join(obs_dir, "metrics_snapshot.json")
    if not os.path.exists(snap_path):
        print(f"  no slo_status.json or metrics_snapshot.json under "
              f"{obs_dir}")
        return
    with open(snap_path) as f:
        snap = json.load(f)
    for name in ("tddl_slo_burn_rate", "tddl_anomaly_active"):
        metric = snap.get("metrics", {}).get(name)
        if not metric:
            continue
        for row in metric.get("series", ()):
            labels = ",".join(f"{k}={v}" for k, v in row["labels"].items())
            print(f"  {name}{{{labels}}} = {row['value']}")


def _print_obs_summary(obs_dir: str, events: list) -> None:
    import json

    print(f"obs dir: {obs_dir}")
    counts: dict = {}
    for e in events:
        counts[e.get("type", "?")] = counts.get(e.get("type", "?"), 0) + 1
    if counts:
        print(f"trace.jsonl: {len(events)} event(s)")
        for etype, n in sorted(counts.items()):
            print(f"  {etype}: {n}")
    report_path = os.path.join(obs_dir, "obs_report.json")
    if os.path.exists(report_path):
        with open(report_path) as f:
            report = json.load(f)
        line = f"obs_report.json: {report.get('num_steps', 0)} step(s)"
        mfu = report.get("mfu", {})
        if isinstance(mfu, dict) and mfu.get("mfu") is not None:
            line += f", MFU {mfu['mfu']:.1%} ({mfu['peak_flops_source']})"
        print(line)
    ledger_path = os.path.join(obs_dir, "attribution.jsonl")
    if os.path.exists(ledger_path):
        from trustworthy_dl_tpu_torch.obs.attribution import read_ledger

        _, records = read_ledger(ledger_path)
        flagged = sum(1 for r in records if r.get("flagged"))
        print(f"attribution.jsonl: {len(records)} record(s), "
              f"{flagged} flagged")
    _print_slo_status(obs_dir)
    dumps = sorted(p for p in os.listdir(obs_dir)
                   if p.startswith("flight_") and p.endswith(".json"))
    if dumps:
        print(f"flight dumps: {', '.join(dumps)}")
    incidents = sorted(p for p in os.listdir(obs_dir)
                       if p.startswith("incident_")
                       and p.endswith(".json"))
    if incidents:
        print(f"incidents: {', '.join(incidents)} "
              f"(render with 'python -m trustworthy_dl_tpu_torch.cli obs "
              f"incident list --dir {obs_dir}')")
    verdicts_path = os.path.join(obs_dir, "VERDICTS.jsonl")
    if os.path.exists(verdicts_path):
        from trustworthy_dl_tpu_torch.obs.verdicts import VerdictStore

        rows = VerdictStore(verdicts_path).read()
        kinds: dict = {}
        for row in rows:
            key = f"{row.get('kind')}:{row.get('outcome')}"
            kinds[key] = kinds.get(key, 0) + 1
        print(f"VERDICTS.jsonl: {len(rows)} row(s)"
              + (" — " + ", ".join(f"{k}={n}" for k, n in
                                   sorted(kinds.items()))
                 if kinds else ""))


def experiment_main(argv: Optional[List[str]] = None) -> int:
    """Entry point of ``experiment``: the experiment runner's command
    line."""
    from trustworthy_dl_tpu_torch.experiments.runner import main as run_main

    return run_main(argv)


COMMANDS = {"prepare": prepare_main, "generate": generate_main,
            "serve": serve_main, "train": train_main,
            "experiment": experiment_main, "obs": obs_main}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m trustworthy_dl_tpu_torch.cli "
              "prepare|generate|serve|train|experiment|obs "
              "[--help | options]",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
