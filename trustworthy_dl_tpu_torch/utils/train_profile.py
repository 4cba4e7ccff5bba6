"""Where a training step's time goes on the card, and what detection
costs.

    python -m trustworthy_dl_tpu_torch.utils.train_profile [--steps 6]

Builds two trainers on GPT-2 small at full width (T = 1024, 4 nodes x 8
sequences, AdamW, block remat, ``attn_impl="auto"``, random weights from
seed 0), one with detection and verification ON and one with both OFF,
warms both up, then runs their steps in turns (ON, OFF, OFF, ON, ...) so
that clock and allocator drift hit both alike, and prints one JSON line:
the per-step wall times (host batch in, record kept), split into the
batch's copy, the step's dispatch, the one host copy and the
record-keeping, and tokens/s of each, their ratio
(``vs_baseline``, ON over OFF), and one profiled ON step: device time
summed over kernels, its share of that step's wall (the rest is the
device's idle share), device time per step phase (the ``tddl.*`` ranges of
``engine/step.py``: per-node forward/backward, detection, update) and the
top kernels by device time.  :func:`busy_window` profiles a steady window
of steps inside a ``train_epoch`` the same way (``chip_smoke.py``'s
``async_host`` phase and ``utils/async_ab`` read the busy share of each
pipeline depth from it).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


#: :func:`busy_window`'s steady window: from the dispatch of the epoch's
#: step BUSY_FIRST to that of step BUSY_LAST + 1 (1-based), inside an
#: epoch of BUSY_STEPS steps, clear of the prefetch thread's start, the
#: pipeline's fill and the epoch's closing drain and bookkeeping.
BUSY_FIRST, BUSY_LAST, BUSY_STEPS = 3, 10, 12


def busy_window(trainer, loader, epoch: int = 0, first: int = BUSY_FIRST,
                last: int = BUSY_LAST) -> dict:
    """``trainer.train_epoch(loader, epoch)`` with the profiler (device
    activity only) recording from the dispatch of step ``first`` to the
    dispatch of step ``last + 1`` of the epoch: the window's wall, the
    device time summed over the kernels and copies that ran in it, and
    their ratio, the device's busy share; and the host's time to enqueue
    each of the window's steps (the step call, which returns before the
    card finishes), their median.  The loader must give more than
    ``last`` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    if not 2 <= first <= last:
        raise ValueError(f"busy_window: want 2 <= first <= last, got "
                         f"{first}, {last}")
    found = {}

    def ready(prof):
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("tddl.")]
        found["device_s"] = sum(_device_us(e) for e in kernels) / 1e6

    # Device activity only: tracing every host op would slow the very
    # enqueue the window measures.  The trace is prepared one step ahead
    # (warmup), so the window does not pay for it.
    prof = profile(activities=[ProfilerActivity.CUDA],
                   schedule=schedule(wait=first - 1, warmup=1,
                                     active=last - first + 1, repeat=1),
                   on_trace_ready=ready)
    step_fn, marks, enqueue = trainer._train_step, [], []

    def stepped(*args):
        marks.append(time.perf_counter())
        prof.step()         # step i of the epoch is profiler step i
        t = time.perf_counter()
        out = step_fn(*args)
        enqueue.append(time.perf_counter() - t)
        return out

    trainer._train_step = stepped
    try:
        with prof:
            trainer.train_epoch(loader, epoch)
    finally:
        trainer._train_step = step_fn
    if len(marks) <= last or "device_s" not in found:
        raise RuntimeError(f"busy_window: the epoch ran {len(marks)} "
                           f"steps; the window needs more than {last}")
    wall = marks[last] - marks[first - 1]
    window = enqueue[first - 1:last]
    return {"steps": [first, last], "wall_s": wall,
            "device_kernel_s": found["device_s"],
            "busy_share": found["device_s"] / wall,
            "enqueue_ms_median": 1e3 * statistics.median(window),
            "enqueue_ms": [1e3 * x for x in window]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=6,
                        help="timed steps of each trainer")
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    nodes, batch, seq = 4, 32, 1024

    def trainer(detection):
        tr = DistributedTrainer(TrainingConfig(
            model_name="gpt2", batch_size=batch, num_nodes=nodes,
            learning_rate=1e-4, remat=True, seed=0,
            attack_detection_enabled=detection,
            gradient_verification_enabled=detection),
            model_overrides=dict(seq_len=seq), device="cuda")
        tr.initialize()
        return tr

    on, off = trainer(True), trainer(False)
    n_batches = args.warmup + args.steps + 1
    loader = get_dataloader("openwebtext", batch_size=batch, seq_len=seq,
                            vocab_size=on.model.config.vocab_size,
                            num_examples=batch * n_batches, seed=0)
    batches = list(loader)

    def step(tr, b):
        """One step as ``DistributedTrainer.train_step`` runs it, each host
        part timed: the batch's copy to the card, the step's dispatch
        (returns once its kernels are queued), the one host copy (waits
        for the card to finish) and the record-keeping."""
        t = [time.perf_counter()]
        tr.global_step += 1
        node_batch = tr._node_batch(b)
        t.append(time.perf_counter())
        tr.state, metrics = tr._train_step(tr.state, node_batch,
                                           tr.attack_plan)
        t.append(time.perf_counter())
        host = tr._host_view(metrics)     # pack, wait for the copy, unpack
        t.append(time.perf_counter())
        tr._record_batch(host, 0)
        t.append(time.perf_counter())
        return [t1 - t0 for t0, t1 in zip(t, t[1:])]

    times = {"on": [], "off": []}
    it = iter(batches)
    for i in range(args.warmup + args.steps):
        order = (("on", on), ("off", off)) if i % 2 == 0 else \
            (("off", off), ("on", on))
        b = next(it)
        for name, tr in order:
            parts = step(tr, b)
            if i >= args.warmup:
                times[name].append(parts)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = sum(step(on, batches[-1]))
    events = prof.key_averages()
    # Device-side kernels only: the tddl.* ranges also appear on the
    # device timeline, as spans that cover the kernels inside them.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("tddl.")]
    device_us = sum(_device_us(e) for e in kernels)
    phases = {e.key: _device_us(e) / 1e3 for e in events
              if e.key.startswith("tddl.") and e.device_type == DeviceType.CUDA}
    top = sorted(kernels, key=_device_us, reverse=True)[:args.top]
    tokens = batch * seq
    step_s = {k: [sum(p) for p in v] for k, v in times.items()}
    on_s = statistics.mean(step_s["on"])
    off_s = statistics.mean(step_s["off"])
    host_ms = {k: {part: 1e3 * statistics.mean(p[i] for p in v)
                   for i, part in enumerate(("batch_copy", "dispatch",
                                             "host_copy", "record"))}
               for k, v in times.items()}
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "shape": {"nodes": nodes, "batch": batch, "seq_len": seq},
        "step_s_on": step_s["on"], "step_s_off": step_s["off"],
        "step_parts_ms_mean": host_ms,
        "tokens_per_s_on": tokens / on_s, "tokens_per_s_off": tokens / off_s,
        "vs_baseline": off_s / on_s,
        "profiled_step_wall_s": prof_wall,
        "profiled_step_device_kernel_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / prof_wall,
        "phase_device_ms": phases,
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
