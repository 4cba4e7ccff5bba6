#!/usr/bin/env python
"""End-to-end survival drill on the PyTorch/CUDA port: train through a
seeded fault plan and come out with the predicted recovery counts and a
healthy loss.

The scripted ``FaultPlan`` injects, in one run:

* a lost batch (simulated data-iterator failure)        -> skipped
* a host stall (straggler)                              -> absorbed
* post-commit corruption of the step-10 checkpoint      -> walked past
* NaN-corrupted parameters after step 12                -> retries fail,
  rollback to the last VERIFIED checkpoint (step 5: step 10 is corrupt)
* a simulated preemption at step 18                     -> save-on-signal
  + auto-resume

The supervisor's report must match ``FaultPlan.predict`` exactly, and so
must the flight recorder's final dump: every fault, retry, rollback and
preemption is a trace event, and the supervisor dumps the ring buffer
next to the checkpoints on each incident.  The port's spelling of
``examples/chaos_drill.py``.

Run on the card, or on the CPU:
  python examples/torch_chaos_drill.py [--device cpu] [--epochs 4]
"""

import argparse
import glob
import json
import os
import shutil
import tempfile

from trustworthy_dl_tpu_torch import (
    DistributedTrainer,
    TrainingConfig,
    TrainingSupervisor,
    get_dataloader,
)
from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
    FaultKind, FaultPlan
from trustworthy_dl_tpu_torch.obs import ObsSession

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32,
            seq_len=16)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--epochs", type=int, default=4)
    args = parser.parse_args()
    epochs = args.epochs
    ckpt_dir = tempfile.mkdtemp(prefix="tddl_chaos_drill_ckpt_")
    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext",
        batch_size=8, num_nodes=4, learning_rate=3e-3,
        detector_warmup=4, checkpoint_interval=5,
        checkpoint_dir=ckpt_dir,
        # FaultPlan.predict's retry/rollback arithmetic assumes the
        # synchronous step guard; the async pipeline's lagged guard
        # skips in-place retries (engine/async_host.py).
        async_host_depth=0, num_epochs=epochs,
    )
    trainer = DistributedTrainer(config, model_overrides=dict(TINY),
                                 device=args.device)
    dl = get_dataloader("openwebtext", batch_size=8, seq_len=16,
                        vocab_size=128, num_examples=64)

    print("== fault-free baseline ==")
    trainer.initialize()
    baseline = trainer.train(dl, num_epochs=epochs)
    base_loss = baseline["epochs"][-1]["train_loss"]
    print(f"baseline final loss: {base_loss:.4f}")

    print("== survival drill ==")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer.reset_for_run()  # same built steps, fresh state
    plan = FaultPlan.scripted([
        FaultEvent(step=3, kind=FaultKind.DATA_LOSS),
        FaultEvent(step=7, kind=FaultKind.STALL, severity=0.01),
        FaultEvent(step=10, kind=FaultKind.CKPT_CORRUPT),
        FaultEvent(step=12, kind=FaultKind.GRAD_NAN),
        FaultEvent(step=18, kind=FaultKind.PREEMPT),
    ])
    obs = ObsSession(os.path.join(ckpt_dir, "obs"))
    supervisor = TrainingSupervisor(
        trainer, max_retries=2, rollback_after=2, max_restarts=2,
        chaos=FaultInjector(plan), obs=obs,
    )
    result = supervisor.run(dl, num_epochs=epochs)
    report = result["supervisor"]
    predicted = plan.predict(max_retries=2, rollback_after=2)

    final_loss = result["epochs"][-1]["train_loss"]
    print(f"drill final loss:    {final_loss:.4f} "
          f"(baseline {base_loss:.4f})")
    print(f"report:    { {k: report[k] for k in predicted} }")
    print(f"predicted: {predicted}")
    print(f"rollback restored from step(s): {report['rollback_steps']} "
          "(step 10 was corrupt, so the walk landed on 5)")
    for key, want in predicted.items():
        got = report[key]
        assert got == want, f"{key}: predicted {want}, got {got}"
    assert report["rollback_steps"] == [5], report["rollback_steps"]
    assert final_loss < base_loss + 0.75, (final_loss, base_loss)

    # Flight-recorder post-mortems: the rollback and the preemption each
    # dumped the ring buffer next to the checkpoints mid-run...
    reasons = set()
    for path in sorted(glob.glob(os.path.join(ckpt_dir, "flight_*.json"))):
        with open(path) as f:
            reasons.add(json.load(f)["reason"])
    assert {"guard_trip", "rollback", "preemption"} <= reasons, reasons
    # ...and the final dump's events carry the recovery counts the plan
    # predicted: the post-mortem agrees with the supervisor's report.
    final_dump = obs.dump_flight("drill", directory=ckpt_dir)
    with open(final_dump) as f:
        events = json.load(f)["events"]

    def count(etype, **match):
        return sum(e["type"] == etype
                   and all(e.get(k) == v for k, v in match.items())
                   for e in events)

    observed = {
        "retries": count("supervisor_retry"),
        "rollbacks": count("supervisor_rollback"),
        "restarts": count("supervisor_restart"),
        "preemptions": count("preemption"),
        "dropped_batches": count("chaos_fault", kind="data_loss"),
        "stalls": count("chaos_fault", kind="stall"),
    }
    print(f"flight dump {os.path.basename(final_dump)}: {observed}")
    assert observed == predicted, (observed, predicted)
    obs.finalize()
    print("drill survived with the plan-predicted recovery counts "
          "(supervisor report AND flight-recorder events)")


if __name__ == "__main__":
    main()
