"""What the async host pipeline and the prefetch thread do to a training
step on the card, in turns within one process.

    python -m trustworthy_dl_tpu_torch.utils.async_ab [--rounds 10]

One detection-ON trainer on ``chip_smoke.py``'s train geometry (GPT-2
small at full width, 4 nodes x 8 sequences x 1024 tokens, AdamW, block
remat, ``attn_impl="auto"``, random weights from seed 0, node 2 poisoned
from step 4) runs four arms of (``async_host_depth``, ``prefetch_depth``):
(0, 0) the synchronous loop without the thread, (0, 2), (2, 0) and (2, 2),
the default.  Each round runs one epoch of ``BUSY_STEPS`` steps an arm
from the same state and data (``reset_for_run(0)``), the arms in ``ARMS``
order on even rounds and reversed on odd ones.  A run's step time is the
median ``step_s`` of its records over the steady steps ``BUSY_FIRST`` to
``BUSY_LAST`` (``utils/train_profile``), clear of the pipeline's fill and
drain; its epoch time is the wall of the whole ``train_epoch`` over its
steps.  Then one more epoch an arm, in turns, under the profiler over the
same steady steps (``train_profile.busy_window``: the device's busy
share).

Prints one JSON line: per arm the step ms of each round with their median
and quartiles, the epoch ms a step, the busy window; per comparison
(``COMPARISONS``: change against base) the rounds won and lost and the
verdict: ``faster`` where the change wins at least nine tenths of the
rounds and its median beats the base's by more than the base's
interquartile range, ``regressed`` where the same holds the other way,
else ``unresolved``.  Then the card's name and power limit.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

#: (async_host_depth, prefetch_depth) of each arm.
ARMS = ((0, 0), (0, 2), (2, 0), (2, 2))
#: (change, base): the depth with and without the thread, the thread at
#: each depth, and the default against the synchronous loop.
COMPARISONS = (((2, 2), (0, 2)), ((2, 0), (0, 0)), ((2, 2), (2, 0)),
               ((0, 2), (0, 0)), ((2, 2), (0, 0)))
NODES, BATCH, SEQ, ATTACK_STEP = 4, 32, 1024, 4


def quartiles(xs):
    q1, q2, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"q1": q1, "median": q2, "q3": q3}


def verdict(change, base) -> dict:
    """Paired rounds of step ms (lower is better), judged as the module
    docstring says."""
    won = sum(c < b for c, b in zip(change, base))
    lost = sum(c > b for c, b in zip(change, base))
    qb = quartiles(base)
    iqr = qb["q3"] - qb["q1"]
    diff = statistics.median(change) - qb["median"]
    need = 0.9 * len(base)
    word = ("faster" if won >= need and -diff > iqr else
            "regressed" if lost >= need and diff > iqr else "unresolved")
    return {"won": won, "lost": lost, "rounds": len(base),
            "median_ratio": statistics.median(change) / qb["median"],
            "base_iqr_ms": iqr, "verdict": word}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("async_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.utils.train_profile import BUSY_FIRST, \
        BUSY_LAST, BUSY_STEPS, busy_window

    tr = DistributedTrainer(TrainingConfig(
        model_name="gpt2", batch_size=BATCH, num_nodes=NODES,
        optimizer="adamw", learning_rate=1e-4, remat=True, seed=0,
        detector_warmup=2), model_overrides=dict(
            seq_len=SEQ, attn_impl="auto"), device="cuda")
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=ATTACK_STEP))
    attacker.activate_attacks()

    def loader(arm):
        depth, prefetch = arm
        tr.config = dataclasses.replace(tr.config, async_host_depth=depth,
                                        prefetch_depth=prefetch)
        tr.reset_for_run(0)
        tr.set_attack_plan(attacker.plan(NODES))
        return get_dataloader("openwebtext", batch_size=BATCH, seq_len=SEQ,
                              vocab_size=tr.model.config.vocab_size,
                              num_examples=BATCH * BUSY_STEPS, seed=0)

    # Warm-up: one epoch of each arm, untimed (kernel builds, allocator).
    for arm in ARMS:
        tr.train_epoch(loader(arm), 0)
    step_ms = {arm: [] for arm in ARMS}
    epoch_ms = {arm: [] for arm in ARMS}
    for r in range(args.rounds):
        for arm in (ARMS if r % 2 == 0 else ARMS[::-1]):
            dl = loader(arm)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_epoch(dl, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            hist = tr.batch_history
            if len(hist) != BUSY_STEPS:
                raise AssertionError(f"async_ab: arm {arm} kept "
                                     f"{len(hist)} of {BUSY_STEPS} steps")
            step_ms[arm].append(1e3 * statistics.median(
                h["step_s"] for h in hist[BUSY_FIRST - 1:BUSY_LAST]))
            epoch_ms[arm].append(1e3 * wall / BUSY_STEPS)
    busy = {arm: busy_window(tr, loader(arm))
            for arm in (ARMS if args.rounds % 2 == 0 else ARMS[::-1])}

    def key(arm):
        return f"depth{arm[0]}_prefetch{arm[1]}"

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card,
        "shape": {"nodes": NODES, "batch": BATCH, "seq_len": SEQ},
        "rounds": args.rounds, "steps": BUSY_STEPS,
        "steady_steps": [BUSY_FIRST, BUSY_LAST],
        "arms": {key(arm): {
            "step_ms": step_ms[arm], **quartiles(step_ms[arm]),
            "epoch_ms_per_step": quartiles(epoch_ms[arm]),
            "busy": busy[arm]} for arm in ARMS},
        "comparisons": {f"{key(c)}_vs_{key(b)}": verdict(step_ms[c],
                                                          step_ms[b])
                        for c, b in COMPARISONS}}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
