"""PyTorch/CUDA port of ``trustworthy_dl_tpu`` for NVIDIA Hopper.

The port mirrors the JAX package's module paths.  It imports ``torch`` and
numpy only, never ``jax`` nor ``trustworthy_dl_tpu``.  Its entry points
(``serve.ServingEngine``, ``cli.serve_main``) run on the card by default
and take ``device="cpu"`` only when the caller asks for it; on the CPU each
kernel wrapper runs its plain PyTorch version.

This slice covers paged continuous-batching serving of GPT-2: the decode,
chunked-prefill and trust-epilogue kernels (``ops/paged_attention.py``).
"""

__version__ = "0.1.0"
