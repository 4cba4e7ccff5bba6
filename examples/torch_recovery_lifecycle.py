#!/usr/bin/env python
"""The full elastic lifecycle in one run, on the PyTorch/CUDA port:
transient attack -> detection -> eviction -> attack ends -> probation ->
readmission.

A node mounts a gradient-poisoning attack for a bounded window.  The
in-step detector confirms it, its node is evicted (the per-node state
compacted, the steps rebuilt for the survivors), and once the attack
window closes and the cool-off elapses the node is readmitted on
probation: fresh detector baselines, RECOVERING trust, boosted recovery
rate.  A false positive costs bounded steps, not 1/n of the fleet
forever.  The port's spelling of ``examples/recovery_lifecycle.py``.

Run on the card, or on the CPU:
  python examples/torch_recovery_lifecycle.py [--device cpu]
"""

import argparse
import tempfile

from trustworthy_dl_tpu_torch import (
    AdversarialAttacker,
    AttackConfig,
    DistributedTrainer,
    TrainingConfig,
    get_dataloader,
)
from trustworthy_dl_tpu_torch.attacks import null_plan

TINY = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=512,
            n_positions=128, seq_len=64)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext",
        batch_size=16, num_nodes=8, learning_rate=3e-3,
        detector_warmup=4, checkpoint_interval=10_000,
        elastic_resharding=True,      # evict confirmed-compromised nodes
        readmit_after_steps=10,       # ...and readmit them after a cool-off
        recovery_probation_steps=5,   # in-step probation for gated nodes
        # A re-sized epoch's step count stays fixed without the prefetch
        # thread.
        prefetch_depth=0,
        checkpoint_dir=tempfile.mkdtemp(prefix="tddl_recovery_ckpt_"),
    )
    trainer = DistributedTrainer(config, model_overrides=dict(TINY),
                                 device=args.device)
    dl = get_dataloader("openwebtext", batch_size=16,
                        seq_len=TINY["seq_len"],
                        vocab_size=TINY["vocab_size"], num_examples=96)
    trainer.initialize()

    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[5],
        intensity=0.5, start_step=8,
    ))
    attacker.activate_attacks()
    trainer.set_attack_plan(attacker.plan(8))

    print("== attack window ==")
    epoch = 0
    while trainer.config.num_nodes == 8 and epoch < 4:
        loss = trainer.train_epoch(dl, epoch)
        print(f"epoch {epoch}: loss {loss:.3f}  live nodes "
              f"{trainer.config.num_nodes}  map {trainer.node_map}")
        epoch += 1
    assert trainer.config.num_nodes == 7, "expected an eviction"
    print(f"node 5 evicted at step {trainer._evicted_at[5]}; "
          f"mesh now {trainer.mesh.devices.size} positions")

    print("== attack over: cool-off, then readmission ==")
    trainer.set_attack_plan(null_plan(trainer.config.num_nodes))
    while trainer.config.num_nodes == 7 and epoch < 9:
        loss = trainer.train_epoch(dl, epoch)
        print(f"epoch {epoch}: loss {loss:.3f}  live nodes "
              f"{trainer.config.num_nodes}  map {trainer.node_map}")
        epoch += 1
    assert trainer.config.num_nodes == 8, "expected readmission"

    coord = trainer.node_map.index(5)
    trust = trainer.state.trust
    print(f"node 5 readmitted at coordinate {coord}: trust "
          f"{float(trust.scores[coord]):.2f}, recovery rate "
          f"{float(trust.recovery_rate[coord]):.3f}")
    for rec in trainer.reassignment_history:
        kind = ("eviction" if "evicted_nodes" in rec
                else "readmission" if "readmitted_nodes" in rec
                else "relabel")
        print(f"  [{kind}] {rec}")

    loss = trainer.train_epoch(dl, epoch)
    print(f"full fleet training again: epoch {epoch} loss {loss:.3f}")
    trainer.cleanup()


if __name__ == "__main__":
    main()
