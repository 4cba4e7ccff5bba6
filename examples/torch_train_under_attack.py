#!/usr/bin/env python
"""Train GPT-2 data-parallel while two nodes mount a gradient-poisoning
attack, on the PyTorch/CUDA port: the in-step detector flags them, their
trust collapses and the trust gate takes them out of the aggregation.

The port's spelling of ``examples/train_under_attack.py``; the console
scripts ``trustworthy-dl-torch-train`` and
``trustworthy-dl-torch-experiment`` wrap the same machinery.

Run on the card, or on the CPU (the kernels' plain versions):
  python examples/torch_train_under_attack.py [--device cpu]
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

# Small model so the example runs anywhere; drop model_overrides for the
# real GPT-2 small (124M).
TINY = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=512, n_positions=64,
            seq_len=32)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    config = TrainingConfig(
        model_name="gpt2",
        dataset_name="openwebtext",
        batch_size=16,
        num_nodes=8,
        parallelism="data",
        optimizer="adamw",
        learning_rate=1e-3,
        lr_schedule="cosine", warmup_steps=10, lr_decay_steps=200,
        detector_warmup=4,
        elastic_resharding=False,   # True: evict compromised nodes
        checkpoint_dir=tempfile.mkdtemp(prefix="tddl_example_ckpt_"),
    )
    trainer = DistributedTrainer(config, model_overrides=TINY,
                                 device=args.device)
    trainer.initialize()

    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"],
        target_nodes=[1, 3],        # the reference's canonical targets
        intensity=0.5,
        start_step=20,
    ))
    attacker.activate_attacks()
    trainer.set_attack_plan(attacker.plan(config.num_nodes))

    train_dl = get_dataloader("openwebtext", batch_size=16, seq_len=32,
                              vocab_size=512, num_examples=256)
    val_dl = get_dataloader("openwebtext", split="validation", batch_size=16,
                            seq_len=32, vocab_size=512, num_examples=64)

    result = trainer.train(train_dl, val_dl, num_epochs=3)

    print("\n--- epochs ---")
    for rec in result["epochs"]:
        print(rec)
    print("\n--- incidents ---")
    for rec in trainer.attack_history:
        print(f"step {rec['step']}: node {rec['node_id']} "
              f"({rec['attack_type']})")
    print("\n--- trust ---")
    stats = trainer.get_training_stats()
    print({k: round(v, 3) for k, v in stats["trust_scores"].items()})
    print("\n--- recommendations ---")
    for line in trainer.trust_manager.get_recommendations():
        print("*", line)
    print("\nvalidation:", trainer.validate_metrics(val_dl))
    trainer.cleanup()


if __name__ == "__main__":
    main()
