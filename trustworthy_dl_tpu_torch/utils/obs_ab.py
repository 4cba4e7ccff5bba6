"""What an ``ObsSession`` costs serving and training on the card, in turns
within one process.

    python -m trustworthy_dl_tpu_torch.utils.obs_ab [--rounds 10]
        [--serve-only] [--parent DIR]

Serving: the smoke traffic (:func:`serve_profile.smoke_traffic`, 16
requests of 32 new tokens) on GPT-2 small at full width (bf16, random
weights from seed 0), driven closed-loop (:func:`serve_profile.
drive_closed_loop`: at most one request a free row, so no watcher can shed
one) by a fresh engine an arm.  The arms are :data:`SERVE_ARMS`: ``off``
bare, then sessions writing to a temporary directory with one attachment
more each, up to ``on`` with spans, the attribution ledger, the default
SLO rules, the anomaly watcher and the HBM monitor, and ``on_memory``,
``on`` writing no file; their order rotates by one each round.
Training: ``chip_smoke.py``'s train geometry (4 nodes x 8 sequences x
1024 tokens, AdamW, block remat, detection ON, node 2 poisoned from step
4) at the trainer's defaults (``async_host_depth`` 2, ``prefetch_depth``
2), one epoch of ``BUSY_STEPS`` steps an arm from the same state
(``reset_for_run(0)``), ``on`` with a session attached (spans and the
watchers), off-on on even rounds and on-off on odd ones.  Every workload
runs one untimed round first.

A serve arm's number is its drive's wall, beside the part of it inside
the scheduler's ticks; a train arm's the median ``step_s`` over the
steady steps ``BUSY_FIRST`` to ``BUSY_LAST`` (``utils/train_profile``).
Each arm also counts the trace events it emitted and the garbage
collector's collections and their pauses during it.  After the timed
serve rounds ``off`` and ``on`` each drive once more under ``cProfile``:
host seconds by module of this package (the rest as ``builtin``,
``torch`` and ``other``) and the top functions.

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked with
``git archive`` into a directory git ignores) the bare serve arm also runs
on both trees, each in processes of its own: parent, this tree, this tree,
parent, ``TREE_DRIVES`` timed closed-loop drives a process after one
untimed one.  That prices what the bare engine does now that it did not
(registry updates every iteration, the block journal).

Prints one JSON line: per workload and arm the numbers of each round with
their median and quartiles, the ``on`` arm's last step report (phase
fractions, ``host`` among them at depth 2), each arm's verdict against
``off`` (``utils/async_ab.verdict``: ``faster``, ``regressed`` or
``unresolved``), the profiles and the trees' verdict; then the card's
name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import json
import os
import pstats
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

from trustworthy_dl_tpu_torch.utils.async_ab import quartiles, verdict

NODES, BATCH, SEQ, ATTACK_STEP = 4, 32, 1024, 4
ARMS = ("off", "on")
#: The serve arms, each a session with one attachment more than the arm
#: before it: none (bare), the trace bus and registry alone, then spans,
#: the attribution ledger, the SLO and anomaly watchers, and the HBM
#: monitor with the compile watcher and forensics (``on``: what ``cli
#: serve --obs-dir`` opens).
SERVE_LADDER = ("off", "trace", "spans", "ledger", "watchers", "on")
#: ... and ``on`` kept in memory (``ObsSession(None)``: no file written),
#: which tells the session's file I/O from its other work.
SERVE_ARMS = SERVE_LADDER + ("on_memory",)
TREE_DRIVES = 5
PACKAGE = Path(__file__).resolve().parents[1]

#: One process's bare serve drives on the tree it runs in, through what
#: this tree and its parent share; prints the walls in ms as JSON.
_TREE_DRIVES = """
import json, sys, time, torch
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.serve import ServeRequest
from trustworthy_dl_tpu_torch.utils.serve_profile import smoke_engine, \\
    smoke_traffic
cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
params = gpt2.init_params(
    cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
requests = smoke_traffic(cfg.vocab_size)
walls = []
for drive in range(int(sys.argv[1]) + 1):
    engine = smoke_engine(cfg, params, "kernel")
    pending = list(requests)
    t0 = time.perf_counter()
    while pending or engine.busy:
        while pending and engine.open_requests < 8:
            prompt, temp = pending.pop(0)
            engine.submit(ServeRequest(prompt=prompt, max_new_tokens=32,
                                       temperature=temp))
        engine.step()
    torch.cuda.synchronize()
    walls.append(1e3 * (time.perf_counter() - t0))
print(json.dumps(walls[1:]))
"""


def _collections() -> int:
    return sum(s["collections"] for s in gc.get_stats())


class _GcClock:
    """Sums the garbage collector's pauses while entered."""

    def __enter__(self) -> "_GcClock":
        self.seconds, self._t0 = 0.0, None
        gc.callbacks.append(self._observe)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._observe)

    def _observe(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.seconds += time.perf_counter() - self._t0
            self._t0 = None


def _where(path: str) -> str:
    """A profiled function's module relative to this package, else
    ``builtin`` (C functions, the card's waits among them), ``torch`` or
    ``other``."""
    if path == "~":
        return "builtin"
    if path.startswith(str(PACKAGE)):
        return os.path.relpath(path, PACKAGE)
    return "torch" if f"{os.sep}torch{os.sep}" in path else "other"


def profile_summary(profiler: cProfile.Profile, top: int = 15) -> dict:
    """Host seconds by module (own time) and the ``top`` functions by own
    time of one profiled drive."""
    stats = pstats.Stats(profiler).stats
    by_module: dict = {}
    rows = []
    for (path, line, func), (_, calls, own, cum, _) in stats.items():
        where = _where(path)
        by_module[where] = by_module.get(where, 0.0) + own
        rows.append((own, f"{where}:{line}:{func}", calls, cum))
    rows.sort(reverse=True)
    return {"seconds": sum(by_module.values()),
            "by_module_s": dict(sorted(by_module.items(),
                                       key=lambda kv: -kv[1])),
            "top": [{"function": name, "calls": calls, "own_ms": 1e3 * own,
                     "cum_ms": 1e3 * cum}
                    for own, name, calls, cum in rows[:top]]}


def tree_rounds(parent: str) -> dict:
    """The bare serve drive on ``parent`` and on this tree: parent, this
    tree, this tree, parent, a process each."""
    here = str(PACKAGE.parent)
    walls = {"parent": [], "change": []}
    for arm, tree in (("parent", parent), ("change", here),
                      ("change", here), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, "-c", _TREE_DRIVES, str(TREE_DRIVES)],
            cwd=tree, env={**os.environ, "PYTHONPATH": tree},
            capture_output=True, text=True, check=True).stdout
        walls[arm] += json.loads(out.strip().splitlines()[-1])
    return {"drives_per_process": TREE_DRIVES,
            "arms": {arm: {"wall_ms": w, **quartiles(w)}
                     for arm, w in walls.items()},
            "change_vs_parent": verdict(walls["change"], walls["parent"])}


def serve_session(root: Optional[str], upto: str = "on", *,
                  perf_ledger: Optional[str] = None,
                  verdict_path: Optional[str] = None):
    """A session writing to ``root`` with the attachments of
    :data:`SERVE_LADDER` up to ``upto``; by default as ``cli serve
    --obs-dir`` opens it: spans, the attribution ledger, the default SLO
    rules and anomaly watcher, the HBM monitor, the compile watcher and
    forensics.  ``perf_ledger`` and ``verdict_path`` name the session's
    cross-run files; left None they resolve as ``cli serve``'s do (the
    environment, then ``root``)."""
    from trustworthy_dl_tpu_torch.obs import ObsSession

    session = ObsSession(root, perf_ledger=perf_ledger)
    steps = SERVE_LADDER[:SERVE_LADDER.index(upto) + 1]
    if "spans" in steps:
        session.enable_spans()
    if "ledger" in steps:
        session.open_ledger()
    if "watchers" in steps:
        session.install_watchers()
    if "on" in steps:
        session.enable_forensics(verdict_path=verdict_path)
        session.enable_compile_watch()
        session.enable_hbm()
    return session


def serve_rounds(rounds: int, root: str) -> dict:
    """The serving arms of :data:`SERVE_ARMS`, in an order rotated
    each round; returns per arm the walls (ms), the share of them inside
    the scheduler's ticks (enqueue and the wait for the sampled tokens),
    the garbage collector's work, the events emitted, and for ``off``
    and ``on`` the profiled drive."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.utils.serve_profile import \
        drive_closed_loop, smoke_engine, smoke_traffic

    cfg = gpt2.GPT2Config.from_name("gpt2", dtype=torch.bfloat16)
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    requests = smoke_traffic(cfg.vocab_size)
    out = {arm: {"wall_ms": [], "tick_ms": [], "gc_collections": [],
                 "gc_ms": [], "events": []} for arm in SERVE_ARMS}

    def run(arm: str, record: bool, profiler=None) -> None:
        session = None
        if arm == "on_memory":
            session = serve_session(None)
        elif arm != "off":
            arm_dir = tempfile.mkdtemp(dir=root)
            session = serve_session(
                arm_dir, arm,
                perf_ledger=os.path.join(arm_dir, "PERF_LEDGER.jsonl"),
                verdict_path=os.path.join(arm_dir, "VERDICTS.jsonl"))
        engine = smoke_engine(cfg, params, "kernel", obs=session)
        collections = _collections()
        with _GcClock() as clock:
            if profiler is not None:
                profiler.enable()
            _, wall = drive_closed_loop(engine, requests)
            if profiler is not None:
                profiler.disable()
        collections = _collections() - collections
        events = session.recorder.total_recorded if session else 0
        if session is not None:
            session.finalize()
        if record:
            out[arm]["wall_ms"].append(1e3 * wall)
            out[arm]["tick_ms"].append(1e3 * engine.decode_tick_s)
            out[arm]["gc_collections"].append(collections)
            out[arm]["gc_ms"].append(1e3 * clock.seconds)
            out[arm]["events"].append(events)

    for arm in SERVE_ARMS:
        run(arm, record=False)
    n = len(SERVE_ARMS)
    for r in range(rounds):
        for arm in SERVE_ARMS[r % n:] + SERVE_ARMS[:r % n]:
            run(arm, record=True)
    for arm in ARMS:
        profiler = cProfile.Profile()
        run(arm, record=False, profiler=profiler)
        out[arm]["profile"] = profile_summary(profiler)
    return out


def train_rounds(rounds: int) -> dict:
    """The training arms; returns per arm the steady step ms and the on
    arm's last step report."""
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
    from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
        TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.obs import ObsSession
    from trustworthy_dl_tpu_torch.utils.train_profile import BUSY_FIRST, \
        BUSY_LAST, BUSY_STEPS

    tr = DistributedTrainer(TrainingConfig(
        model_name="gpt2", batch_size=BATCH, num_nodes=NODES,
        optimizer="adamw", learning_rate=1e-4, remat=True, seed=0,
        detector_warmup=2), model_overrides=dict(
            seq_len=SEQ, attn_impl="auto"), device="cuda")
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=ATTACK_STEP))
    attacker.activate_attacks()
    out = {arm: {"step_ms": [], "gc_collections": [], "gc_ms": [],
                 "events": []} for arm in ARMS}
    report = None

    def run(arm: str, record: bool) -> None:
        nonlocal report
        tr.obs = None
        tr.checkpointer.trace = None
        tr.reset_for_run(0)
        tr.set_attack_plan(attacker.plan(NODES))
        session = None
        if arm == "on":
            session = ObsSession(None)
            session.enable_spans()
            session.install_watchers(slo_rules=())
            tr.attach_obs(session)
        loader = get_dataloader("openwebtext", batch_size=BATCH, seq_len=SEQ,
                                vocab_size=tr.model.config.vocab_size,
                                num_examples=BATCH * BUSY_STEPS, seed=0)
        collections = _collections()
        with _GcClock() as clock:
            tr.train_epoch(loader, 0)
            torch.cuda.synchronize()
        collections = _collections() - collections
        hist = tr.batch_history
        if len(hist) != BUSY_STEPS:
            raise AssertionError(f"obs_ab: arm {arm} kept {len(hist)} of "
                                 f"{BUSY_STEPS} steps")
        if not record:
            return
        out[arm]["step_ms"].append(1e3 * statistics.median(
            h["step_s"] for h in hist[BUSY_FIRST - 1:BUSY_LAST]))
        out[arm]["gc_collections"].append(collections)
        out[arm]["gc_ms"].append(1e3 * clock.seconds)
        out[arm]["events"].append(session.recorder.total_recorded
                                  if session else 0)
        if session is not None:
            rep = session.step_timer.report()
            report = {"step_time_s": rep["step_time_s"],
                      "phase_fractions": {k: v["fraction"] for k, v in
                                          rep["phases"].items()},
                      "mfu": rep["mfu"]["mfu"]}

    for arm in ARMS:
        run(arm, record=False)
    for r in range(rounds):
        for arm in (ARMS if r % 2 == 0 else ARMS[::-1]):
            run(arm, record=True)
    out["on"]["report"] = report
    return out


def _summary(arms: dict, key: str) -> dict:
    return {"arms": {arm: {**data, **quartiles(data[key])}
                     for arm, data in arms.items()},
            "vs_off": {arm: verdict(arms[arm][key], arms["off"][key])
                       for arm in arms if arm != "off"}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=10)
    parser.add_argument("--serve-only", action="store_true",
                        help="skip the training arms")
    parser.add_argument("--parent", default=None,
                        help="a checkout of the parent commit: also time "
                             "the bare serve drive on it and on this tree")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("obs_ab: needs a CUDA card", file=sys.stderr)
        return 1
    root = tempfile.mkdtemp(prefix="tddl_obs_ab_")
    try:
        t0 = time.perf_counter()
        trees = (tree_rounds(os.path.abspath(args.parent))
                 if args.parent else None)
        serve = serve_rounds(args.rounds, root)
        gc.collect()
        torch.cuda.empty_cache()
        train = None if args.serve_only else train_rounds(args.rounds)
        seconds = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": card,
        "rounds": args.rounds, "seconds": seconds,
        "serve": _summary(serve, "wall_ms"), "trees": trees,
        "train": train and {
            "shape": {"nodes": NODES, "batch": BATCH, "seq_len": SEQ},
            **_summary(train, "step_ms")}}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
