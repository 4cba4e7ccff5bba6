"""One rank of a multi-process trusted training run, and the one-process
run it must equal.

Counterpart of the JAX package's ``tests/multiproc_worker.py``.  There each
process owns 4 virtual CPU devices and the 8 form one ``data`` mesh; here
each process is one rank on one device (the PyTorch idiom: one process a
card), joined over gloo (``core.mesh.initialize_multihost``).  The worker
builds the data mesh over the ranks, the same params and state on every
rank from the same seeds, and this rank's contiguous node rows of a
seeded global batch; it runs the gathered trusted step
(``engine.step.build_train_step``'s ``process_group``) for ``--steps``
steps and prints one parseable line,

    MULTIPROC_OK process=<r> loss=<last loss> losses=<each step's>
    trust=<last trust vector> params=<sha256 of the final params>

(floats as ``repr``, so equal lines mean equal bits), then one
``MULTIPROC_STATS <json>`` line: per step its wall ms and the gather's ms
and bytes, the peak device memory, the kernel launches and, with
``--profile``, the last step's device time (kernels and copies) over its
wall (the profiler's own read-back left out).  :func:`run_steps` without
a process group is the one-process run over the same global batches,
for comparison.

Run (every rank, the same port; ``--device`` defaults to the card):

    python -m trustworthy_dl_tpu_torch.utils.multiproc_worker <rank> \\
        <world> <port> [--device cpu|cuda] [--size tiny|gpt2-small] \\
        [--steps N] [--plan null|live] [--profile]

Sizes: ``tiny`` is the JAX worker's (8 nodes x 2 rows, GPT-2 with 2
layers, width 32, 4 heads, vocab 128, T 16, AdamW at lr 1e-3, f32);
``gpt2-small`` GPT-2 small at full width over 4 nodes x 8 rows of 1024
tokens (bf16 over f32 master weights, block remat, flash attention), the
card smoke's training geometry.  The live plan poisons the gradients
and the data of node 1 and node n - 2 (one on each rank of two) from
step 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

SIZES: Dict[str, Dict[str, Any]] = {
    "tiny": dict(nodes=8, rows=2, seq_len=16, lr=1e-3, warmup=2,
                 model=dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128,
                            n_positions=32, dtype=torch.float32),
                 training=dict(dtype="float32")),
    "gpt2-small": dict(nodes=4, rows=8, seq_len=1024, lr=1e-4, warmup=10,
                       model=dict(attn_impl="auto"),
                       training=dict(remat=True)),
}
PLANS = ("null", "live")
BATCH_SEED, PARAM_SEED = 0, 0


def build_trainer(size: str, device: str, params: Any = None):
    """The size's trainer, initialised from :data:`PARAM_SEED` or with
    ``params`` (its mesh is the data axis over the ranks when a process
    group is up)."""
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    spec = SIZES[size]
    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext",
        batch_size=spec["nodes"] * spec["rows"], num_nodes=spec["nodes"],
        optimizer="adamw", learning_rate=spec["lr"],
        detector_warmup=spec["warmup"], checkpoint_interval=10 ** 9,
        async_host_depth=0, prefetch_depth=0, seed=PARAM_SEED,
        **spec["training"])
    tr = DistributedTrainer(config, model_overrides=dict(
        spec["model"], seq_len=spec["seq_len"]), device=device)
    tr.initialize(params=params)
    return tr


def global_batches(size: str, steps: int, vocab: int) -> List[Dict]:
    """``steps`` seeded global batches {input, target}: [n, rows, T]."""
    spec = SIZES[size]
    rng = np.random.default_rng(BATCH_SEED)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, vocab, (spec["nodes"], spec["rows"],
                                       spec["seq_len"] + 1))
        out.append({"input": toks[..., :-1], "target": toks[..., 1:]})
    return out


def make_plan(kind: str, num_nodes: int, device: Any):
    """The null plan, or gradient and data poisoning of nodes 1 and
    ``num_nodes - 2`` from step 1."""
    from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan, \
        plan_from_config
    from trustworthy_dl_tpu_torch.core.config import AttackConfig

    if kind == "null":
        return null_plan(num_nodes, device=device)
    return plan_from_config(AttackConfig(
        attack_types=["gradient_poisoning", "data_poisoning"],
        target_nodes=[1, num_nodes - 2], intensity=1.0, start_step=1),
        num_nodes, active=True, device=device)


def params_hash(params: Any) -> str:
    """sha256 over every param leaf's bytes, in tree order."""
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    digest = hashlib.sha256()
    for leaf in tree_leaves(params):
        digest.update(leaf.detach().contiguous().reshape(-1)
                      .view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(size: str, device: str, steps: int, plan_kind: str,
              process_group: Any = None, profile: bool = False,
              params: Any = None, metrics_out: Optional[list] = None
              ) -> Dict[str, Any]:
    """``steps`` trusted steps of ``size``: across the ranks of
    ``process_group`` (this rank's rows of each global batch), or in one
    process over the whole batch (None), from ``params`` if given.
    Returns the run's summary (losses, trust, params hash, timings,
    launches); ``metrics_out`` collects each step's metrics."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.core.mesh import process_node_rows
    from trustworthy_dl_tpu_torch.engine.step import build_train_step

    tr = build_trainer(size, device, params)
    dev = tr.device
    world, rank = 1, 0
    if process_group is not None:
        import torch.distributed as dist

        world = dist.get_world_size(process_group)
        rank = dist.get_rank(process_group)
    n = tr.config.num_nodes
    rows = process_node_rows(n, rank, world)
    step = build_train_step(tr.model, tr.config, tr.optimizer,
                            process_group=process_group)
    plan = make_plan(plan_kind, n, dev)
    state = tr.state
    losses, step_ms, gather = [], [], []
    prof_out: Optional[Dict[str, float]] = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    for s, batch in enumerate(global_batches(size, steps,
                                             tr.model.config.vocab_size)):
        local = {k: torch.from_numpy(v[rows.start:rows.stop]).to(dev)
                 for k, v in batch.items()}
        last = s == steps - 1
        _sync(dev)
        if profile and last and dev.type == "cuda":
            state, metrics, prof_out = _profiled(step, state, local, plan,
                                                 dev)
            step_ms.append(prof_out["wall_ms"])
        else:
            t0 = time.perf_counter()
            state, metrics = step(state, local, plan)
            _sync(dev)
            step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(metrics.loss))
        gather.append(step.last_gather)
        if metrics_out is not None:
            metrics_out.append(metrics)
    out = {
        "process": rank, "world": world, "device": str(dev),
        "nodes": n, "rows": [rows.start, rows.stop], "losses": losses,
        "trust": [float(x) for x in metrics.trust_scores.cpu()],
        "attacked": [bool(x) for x in metrics.attacked.cpu()],
        "params": params_hash(state.params), "step_ms": step_ms,
        "gather_ms": [g["ms"] if g else 0.0 for g in gather],
        "gather_bytes": [g["bytes"] if g else 0 for g in gather],
        "launches": {k: v for k, v in ops.launch_counts().items() if v},
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None),
    }
    if prof_out is not None:
        out["profile"] = prof_out
    return out


def _profiled(step, state, batch, plan, dev):
    """One step under the profiler (device activity): (state, metrics,
    {wall_ms, device_kernel_ms, busy_share})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trustworthy_dl_tpu_torch.utils.train_profile import _device_us

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch, plan)
        _sync(dev)
        wall = time.perf_counter() - t0
    device_s = sum(_device_us(e) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("tddl.")) / 1e6
    return state, metrics, {"wall_ms": 1e3 * wall,
                            "device_kernel_ms": 1e3 * device_s,
                            "busy_share": device_s / wall}


def ok_line(summary: Dict[str, Any]) -> str:
    """The parseable verdict line of a run's summary."""
    return ("MULTIPROC_OK process={} loss={!r} losses={} trust={} "
            "params={}".format(
                summary["process"], summary["losses"][-1],
                ",".join(repr(x) for x in summary["losses"]),
                ",".join(repr(x) for x in summary["trust"]),
                summary["params"]))


def parse_ok_line(line: str) -> Dict[str, Any]:
    """:func:`ok_line` back into {process, loss, losses, trust, params}."""
    fields = dict(part.split("=", 1) for part in line.split()[1:])
    return {"process": int(fields["process"]),
            "loss": float(fields["loss"]),
            "losses": [float(x) for x in fields["losses"].split(",")],
            "trust": [float(x) for x in fields["trust"].split(",")],
            "params": fields["params"]}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("rank", type=int)
    parser.add_argument("world", type=int)
    parser.add_argument("port", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", choices=sorted(SIZES), default="tiny")
    parser.add_argument("--steps", type=int, default=1)
    parser.add_argument("--plan", choices=PLANS, default="null")
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, build_mesh, \
        initialize_multihost, process_count, shutdown_multihost

    if args.device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(coordinator_address=f"127.0.0.1:{args.port}",
                         num_processes=args.world, process_id=args.rank)
    try:
        assert process_count() == args.world, process_count()
        mesh = build_mesh(SIZES[args.size]["nodes"], "data",
                          device=args.device)
        assert mesh.shape == {DATA_AXIS: args.world}, mesh
        summary = run_steps(args.size, args.device, args.steps, args.plan,
                            process_group=dist.group.WORLD,
                            profile=args.profile)
        print(ok_line(summary), flush=True)
        print("MULTIPROC_STATS " + json.dumps(summary), flush=True)
    finally:
        shutdown_multihost()
    return 0


if __name__ == "__main__":
    sys.exit(main())
