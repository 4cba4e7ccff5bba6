"""Serving and training configuration.

Counterpart of ``ServeConfig``, ``TrainingConfig`` and ``AttackConfig`` in
``trustworthy_dl_tpu/core/config.py``, with the fields the port reads.
``ServeConfig`` covers the paged pool's geometry, the prefix cache, chunked
prefill, the attention path, the int8 KV and weight tiers, speculative
decoding and the per-tenant adapter tier (the stripe pool and tensor
parallelism are not ported yet).  ``TrainingConfig`` covers the trusted
data-parallel step on one device, gradient accumulation, both remat
policies, the vocab-chunked fused head, the optimizers (AdamW, Adam, SGD,
Adafactor, a reduced-precision first moment) and the migration-time
model: its defaults are the JAX package's (``weight_decay`` 0.0,
``detector_warmup`` 10, ``recovery_probation_steps`` 25, ...).  The
pipeline, tensor, sequence and expert modes, the async host pipeline,
checkpointing and the ML tier are not ported yet, so their knobs are
absent; so are ``exact_order_stats`` and ``dtype``, whose only reader in
the JAX package is the ML tier's host detector.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from trustworthy_dl_tpu_torch.models.generate import ATTN_IMPLS
from trustworthy_dl_tpu_torch.quant.int8 import validate_dtypes
from trustworthy_dl_tpu_torch.serve.kv_slots import validate_paged_geometry

#: Largest accepted ``ServeConfig.spec_k``: the draft depth; acceptance
#: past a handful of tokens decays geometrically.
SPEC_K_MAX = 8


def validate_spec(spec_k: int, paged: bool, weight_dtype: str) -> None:
    """Construction-time validation of the speculative-decoding knob,
    shared by ``ServeConfig`` and the engine (the JAX package's checks and
    wording; the port's pool is always paged)."""
    if not 0 <= int(spec_k) <= SPEC_K_MAX:
        raise ValueError(
            f"spec_k must be in [0, {SPEC_K_MAX}], got {spec_k}"
        )
    if spec_k > 0 and not paged:
        raise ValueError(
            "spec_k > 0 requires the paged KV pool (paged=True): "
            "rejected draft tokens roll back by releasing COW block "
            "claims, which the legacy stripe pool cannot express"
        )
    if spec_k > 0 and weight_dtype != "model":
        raise ValueError(
            f"spec_k > 0 requires weight_dtype='model' (got "
            f"{weight_dtype!r}): the int8 weight tier is the DRAFT — "
            "it is built automatically — and the verify pass must be "
            "the model-dtype tier, or draft and verify would share one "
            "set of weights"
        )


def validate_adapters(adapter_rank: int,
                      adapter_pool_pages: Optional[int],
                      adapter_dtype: str, paged: bool,
                      spec_k: int) -> None:
    """Construction-time validation of the adapter-tier knobs, shared by
    ``ServeConfig`` and the engine (the JAX package's checks and wording;
    the port's pool is always paged).  ``adapter_rank`` 0 disables the
    tier; > 0 needs the paged pool and ``spec_k == 0`` (the int8 draft
    carries no adapter deltas); ``adapter_dtype`` is "model" or "int8";
    ``adapter_pool_pages``, when given, is at least 1."""
    if adapter_rank < 0:
        raise ValueError(
            f"adapter_rank must be >= 0 (0 disables), got {adapter_rank}"
        )
    if adapter_rank == 0:
        return
    if not paged:
        raise ValueError(
            "adapter_rank > 0 requires the paged KV pool (paged=True): "
            "adapter pages are claimed per slot through the same traced "
            "page-table discipline as KV blocks, which the legacy "
            "stripe pool cannot express"
        )
    if spec_k > 0:
        raise ValueError(
            "adapter_rank > 0 is incompatible with spec_k > 0: the int8 "
            "draft model carries no adapter deltas, so draft and verify "
            "would diverge on every adapter-carrying request"
        )
    if adapter_dtype not in ("model", "int8"):
        raise ValueError(
            f"adapter_dtype must be 'model' or 'int8', got "
            f"{adapter_dtype!r}"
        )
    if adapter_pool_pages is not None and adapter_pool_pages < 1:
        raise ValueError(
            f"adapter_pool_pages must be >= 1 (or None = max_slots), "
            f"got {adapter_pool_pages}"
        )


@dataclass
class ServeConfig:
    """``attn_impl``: "kernel" (the hand-written CUDA kernels; their plain
    twins on CPU tensors) or "plain" (the gathered-view reference path).
    ``kv_dtype`` ("model", "bfloat16", "float32", "int8") is the pool's
    storage; an int8 pool is parity-probed at construction unless
    ``kv_parity_check`` is False.  ``weight_dtype`` "int8" serves the four
    block matrices as weight-only int8.  ``spec_k`` > 0 drafts that many
    tokens a tick with the int8 weight tier and verifies them in one
    model-dtype pass (needs ``weight_dtype="model"``).  ``adapter_rank``
    > 0 turns on the per-tenant adapter tier: rank-r deltas on the
    attention output and the MLP in a second paged pool of
    ``adapter_pool_pages`` pages (default ``max_slots``) stored in
    ``adapter_dtype`` ("model" or "int8").  Bad values fail here, at
    construction."""

    max_slots: int = 8
    max_seq: int = 256
    queue_limit: int = 64
    block_size: int = 16
    num_blocks: Optional[int] = None
    prefix_cache: bool = True
    prefill_chunk: Optional[int] = None
    attn_impl: str = "kernel"
    kv_dtype: str = "model"
    weight_dtype: str = "model"
    kv_parity_check: bool = True
    spec_k: int = 0
    adapter_rank: int = 0
    adapter_pool_pages: Optional[int] = None
    adapter_dtype: str = "model"

    def __post_init__(self) -> None:
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")
        validate_paged_geometry(self.max_seq, self.block_size,
                                self.num_blocks, self.prefill_chunk)
        validate_dtypes(self.kv_dtype, self.weight_dtype)
        validate_spec(self.spec_k, True, self.weight_dtype)
        validate_adapters(self.adapter_rank, self.adapter_pool_pages,
                          self.adapter_dtype, True, self.spec_k)


@dataclass
class TrainingConfig:
    """The trusted data-parallel training step's configuration."""

    model_name: str = "gpt2"
    dataset_name: str = "openwebtext"
    batch_size: int = 32
    learning_rate: float = 5e-5
    num_epochs: int = 10
    num_nodes: int = 4
    trust_threshold: float = 0.7
    attack_detection_enabled: bool = True
    gradient_verification_enabled: bool = True
    # Sequential microbatches per node inside the step; gradients, loss
    # and mean logits average over them.  Batches trim to a multiple of
    # num_nodes x grad_accum_steps.
    grad_accum_steps: int = 1
    seed: int = 0
    # torch.utils.checkpoint: "block" (every block) or "attention" (only
    # the full-attention core; block remat on the flash path).
    remat: bool = False
    remat_policy: str = "block"
    # Trust decay clock: step count x time_per_step.
    time_per_step: float = 1.0
    detector_history: int = 1000       # rolling window
    detector_warmup: int = 10          # min history before verdicts
    # Epoch-cadence adaptive trust threshold, pushed back into the step.
    adaptive_thresholds: bool = True
    # -1 leaves the model's "auto" in charge; 0 forces materialised logits;
    # > 0 forces the vocab-chunked fused head at that width.
    lm_head_chunk: int = -1
    recovery_probation_steps: int = 25
    optimizer: str = "adamw"            # adamw | adam | sgd | adafactor
    # Storage dtype of the first moment (adamw/adam) or momentum trace
    # (sgd), e.g. "bfloat16"; None keeps f32.
    moment_dtype: Optional[str] = None
    # Transfer rate of the migration-time model, GiB/s.
    migration_gbps: float = 1.0
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0        # 0 disables
    lr_schedule: str = "constant"      # constant | cosine | linear
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    min_lr_ratio: float = 0.0
    initial_trust: float = 1.0
    trust_decay_rate: float = 0.01
    trust_recovery_rate: float = 0.005
    trust_alpha: float = 0.1

    def __post_init__(self) -> None:
        if self.remat_policy not in ("block", "attention"):
            raise ValueError(
                "remat_policy must be 'block' or 'attention', "
                f"got {self.remat_policy!r}")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")


@dataclass
class NodeConfig:
    """One logical node of the trainer (the JAX package's
    ``NodeConfig``); ``model_partition`` names the data shards it owns
    after task reassignment."""

    node_id: int
    rank: int
    world_size: int
    device_id: int = 0
    model_partition: str = ""
    trust_score: float = 1.0


@dataclass
class AttackConfig:
    """Attack injection schedule (the JAX package's ``AttackConfig``)."""

    attack_types: List[str] = field(
        default_factory=lambda: ["gradient_poisoning", "data_poisoning"])
    target_nodes: List[int] = field(default_factory=lambda: [1, 3])
    intensity: float = 0.5
    start_step: int = 200
    seed: int = 0
    intensity_ramp: float = 0.0
    collude: bool = False
