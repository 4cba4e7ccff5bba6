#!/usr/bin/env python
"""Sample from a (toy-trained) GPT-2 with the KV-cache decoder, on the
PyTorch/CUDA port.

Trains a tiny model on the synthetic affine token stream for a few epochs,
then decodes greedily and with nucleus sampling.  With real OpenWebText
under $TDDL_DATA_DIR and the full model size this is the port's batch
inference path; ``trustworthy-dl-torch-serve`` serves the same model.
The port's spelling of ``examples/generate_text.py``.

Run on the card, or on the CPU:
  python examples/torch_generate_text.py [--device cpu]
"""

import argparse
import tempfile

import torch

from trustworthy_dl_tpu_torch import DistributedTrainer, TrainingConfig, \
    generate, get_dataloader

TINY = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=512, n_positions=128,
            seq_len=32)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext", batch_size=16,
        num_nodes=4, learning_rate=3e-3,
        checkpoint_dir=tempfile.mkdtemp(prefix="tddl_gen_ckpt_"),
    )
    trainer = DistributedTrainer(config, model_overrides=TINY,
                                 device=args.device)
    trainer.initialize()
    dl = get_dataloader("openwebtext", batch_size=16, seq_len=32,
                        vocab_size=512, num_examples=256)
    for epoch in range(3):
        loss = trainer.train_epoch(dl, epoch)
        print(f"epoch {epoch}: loss {loss:.3f}")

    params, cfg = trainer.state.params, trainer.model.config
    prompt = torch.tensor([[1, 2, 3, 4]], device=trainer.device)

    greedy = generate(params, cfg, prompt, max_new_tokens=24)
    print("greedy:   ", greedy[0].tolist())

    sampled = generate(params, cfg, prompt, max_new_tokens=24,
                       temperature=0.8, top_k=40, top_p=0.95,
                       generator=torch.Generator(trainer.device).manual_seed(
                           0))
    print("top-k/p:  ", sampled[0].tolist())
    trainer.cleanup()


if __name__ == "__main__":
    main()
