"""PyTorch/CUDA port of ``trustworthy_dl_tpu`` for NVIDIA Hopper.

The port mirrors the JAX package's module paths.  It imports ``torch`` and
numpy only, never ``jax`` nor ``trustworthy_dl_tpu``.  Its entry points
(``serve.ServingEngine``, ``engine.trainer.DistributedTrainer``,
``experiments.ExperimentRunner``, ``cli.serve_main``, ``cli.train_main``,
``experiments.main``) run on the card by default and
take ``device="cpu"`` only when the caller asks for it; on the CPU each
kernel wrapper runs its plain PyTorch version.

Slice 1 covers paged continuous-batching serving of GPT-2: the decode,
chunked-prefill and trust-epilogue kernels (``ops/paged_attention.py``).
Slice 2 covers the trusted data-parallel training step: the detector's
moment battery (``ops/fused_stats.py``) and causal flash attention
forward and backward (``ops/flash_attention.py``).  The rest of the
single-GPU training path adds the vocab-chunked fused head
(``ops/fused_ce.py``: library products, no kernel of its own), gradient
accumulation, the attention remat policy, evaluation, the trainer's
bookkeeping and Adafactor.  Durable training adds verified checkpoints
(``engine/checkpoint.py``, a format of the port's own), seeded fault
injection (``chaos/``) and the self-healing supervisor
(``engine/supervisor.py``); the experiment runner
(``experiments/runner.py``) drives the trainer end to end and writes its
artifacts.  The vision family (ResNet-32/50/101, VGG-11/13/16 on the
CIFAR-10 loader) trains through the same step, and the host
``detect.detector.AttackDetector`` carries the epoch-cadence ML tier
(behind scikit-learn).
"""

__version__ = "0.2.0"
