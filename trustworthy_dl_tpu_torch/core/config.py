"""Serving and training configuration.

Counterpart of ``ServeConfig``, ``TrainingConfig`` and ``AttackConfig`` in
``trustworthy_dl_tpu/core/config.py``, with the fields the port reads.
``ServeConfig`` covers the pool layout (``paged``, default True; False is
the legacy stripe pool), the paged pool's geometry, the prefix cache,
chunked prefill, the attention path, the int8 KV and weight tiers,
speculative decoding and the per-tenant adapter tier (tensor parallelism
is not ported yet).  ``TrainingConfig`` covers the trusted
data-parallel step on one device, gradient accumulation, both remat
policies, the vocab-chunked fused head, the optimizers (AdamW, Adam, SGD,
Adafactor, a reduced-precision first moment) and the migration-time
model, checkpointing (``checkpoint_interval``, ``checkpoint_dir``,
``async_checkpoint``) and TensorBoard export: its defaults are the JAX
package's (``weight_decay`` 0.0, ``detector_warmup`` 10,
``recovery_probation_steps`` 25, ``checkpoint_interval`` 100, ...).
The input prefetch (``prefetch_depth``) and the async host pipeline
(``async_host_depth``) default to 2 as in JAX; elastic eviction and
readmission (``elastic_resharding``, ``readmit_after_steps``) run in data
mode and the group modes (tensor, sequence, expert, hybrid), and restaff
a pipeline stage in model mode.  ``parallelism`` takes
JAX's modes, and ``DistributedTrainer`` trains them all: "data",
"model" (pipeline stages, ``num_microbatches`` deep, 0 the auto depth,
the canary probe ``canary_tokens`` wide), "sequence" (ring attention over
the seq positions), "tensor", "expert" and "hybrid" (``mesh_shape``,
with ``dcn_mesh_shape``); ``shard_opt_state`` and ``shard_params`` are
ZeRO-1 and FSDP in data mode.  ``ml_detectors`` turns on the
epoch-cadence ML tier (behind scikit-learn, as in JAX) and
``exact_order_stats`` picks the host detector's order statistics.
``dtype`` is the model's compute dtype (``COMPUTE_DTYPES``; the
parameters stay f32): the trainer hands it to the model config unless the
caller's ``model_overrides`` names a dtype.  ``profile_dir`` and
``debug_nans`` are the profiling and NaN-trapping switches of
``utils/profiling.py``; ``compilation_cache_dir`` points the kernel-build
cache (``utils/compile_cache.py``).  :func:`load_config` reads a
:class:`TrainingConfig` and :func:`load_experiment_config` an
:class:`ExperimentConfig` from a YAML or JSON file (JSON where pyyaml is
not installed).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from trustworthy_dl_tpu_torch.models.generate import ATTN_IMPLS
from trustworthy_dl_tpu_torch.quant.int8 import validate_dtypes
from trustworthy_dl_tpu_torch.serve.kv_slots import validate_paged_geometry

#: ``TrainingConfig.dtype``'s names and the torch dtypes they stand for.
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

#: The JAX package's parallelism modes, all of which the port trains.
PARALLELISM_MODES = ("data", "model", "tensor", "sequence", "expert",
                     "hybrid")

#: ``ServeConfig``'s knobs of the paged pool: set away from their defaults
#: on ``paged=False`` they warn (the stripe pool has no use for them).
PAGED_KNOBS = ("block_size", "num_blocks", "prefix_cache", "prefill_chunk",
               "attn_impl")

#: Largest accepted ``ServeConfig.spec_k``: the draft depth; acceptance
#: past a handful of tokens decays geometrically.
SPEC_K_MAX = 8


def validate_spec(spec_k: int, paged: bool, weight_dtype: str) -> None:
    """Construction-time validation of the speculative-decoding knob,
    shared by ``ServeConfig`` and the engine (the JAX package's checks and
    wording): 0 <= ``spec_k`` <= SPEC_K_MAX; > 0 needs the paged pool and
    ``weight_dtype="model"``."""
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
    ``ServeConfig`` and the engine (the JAX package's checks and
    wording).  ``adapter_rank`` 0 disables the
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
    ``adapter_dtype`` ("model" or "int8").  ``paged=False`` selects the
    legacy stripe pool, which has no block pool, prefix cache or chunked
    prefill: a paged knob set away from its default then warns (and
    ``spec_k`` or ``adapter_rank`` > 0 is refused).  ``tp_size`` is the
    replica's tensor-parallel width (JAX's): the engine's params carry the
    model's TP layout over a ``model`` mesh of that many positions, which
    share the engine's card.  Bad values fail here, at construction."""

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
    paged: bool = True
    spec_k: int = 0
    adapter_rank: int = 0
    adapter_pool_pages: Optional[int] = None
    adapter_dtype: str = "model"
    tp_size: int = 1

    def __post_init__(self) -> None:
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")
        validate_dtypes(self.kv_dtype, self.weight_dtype)
        validate_spec(self.spec_k, self.paged, self.weight_dtype)
        validate_adapters(self.adapter_rank, self.adapter_pool_pages,
                          self.adapter_dtype, self.paged, self.spec_k)
        if self.paged:
            validate_paged_geometry(self.max_seq, self.block_size,
                                    self.num_blocks, self.prefill_chunk)
            return
        # The knobs' own dataclass defaults, not a second table of them.
        ignored = [f.name for f in dataclasses.fields(self)
                   if f.name in PAGED_KNOBS
                   and getattr(self, f.name) != f.default]
        if ignored:
            warnings.warn(
                f"ServeConfig(paged=False) ignores paged-pool knob(s) "
                f"{', '.join(ignored)}: the legacy stripe pool has no "
                f"block pool, no prefix cache and no chunked prefill. "
                f"Drop paged=False or drop the knob(s).",
                UserWarning, stacklevel=2)


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
    checkpoint_interval: int = 100
    max_reassignment_attempts: int = 3
    # One of PARALLELISM_MODES.
    parallelism: str = "data"
    # "hybrid": the within-slice {axis: extent} layout, and the
    # across-slice extents (an extent above 1 needs several hosts).
    mesh_shape: Optional[Dict[str, int]] = None
    dcn_mesh_shape: Optional[Dict[str, int]] = None
    # Pipeline schedule depth (the "model" mode); 0 = auto
    # (parallel/pipeline.choose_num_microbatches).
    num_microbatches: int = 0
    # Tokens of the pipeline's per-stage canary probe.
    canary_tokens: int = 8
    # ZeRO-1 (the optimizer state) and FSDP (the params, and the state
    # with them) over the data axis, in data mode on a data axis of more
    # than one position: layout specs only (core/sharding.layout_specs),
    # the same numerics.
    shard_opt_state: bool = False
    shard_params: bool = False
    # Sequential microbatches per node inside the step; gradients, loss
    # and mean logits average over them.  Batches trim to a multiple of
    # num_nodes x grad_accum_steps.
    grad_accum_steps: int = 1
    # Compute dtype (params stay f32), a key of COMPUTE_DTYPES; a dtype
    # in the trainer's model_overrides wins.
    dtype: str = "bfloat16"
    seed: int = 0
    # torch.utils.checkpoint: "block" (every block) or "attention" (only
    # the full-attention core; block remat on the flash path).
    remat: bool = False
    remat_policy: str = "block"
    # Trust decay clock: step count x time_per_step.
    time_per_step: float = 1.0
    # The host detector's order statistics (median/percentiles): exact
    # (a sort) or the Gaussian approximation.
    exact_order_stats: bool = True
    detector_history: int = 1000       # rolling window
    detector_warmup: int = 10          # min history before verdicts
    # Epoch-cadence adaptive trust threshold, pushed back into the step.
    adaptive_thresholds: bool = True
    # Epoch-cadence ML tier: per-node IsolationForests refit on the host
    # detector's battery histories (needs scikit-learn; off without it).
    ml_detectors: bool = True
    # -1 leaves the model's "auto" in charge; 0 forces materialised logits;
    # > 0 forces the vocab-chunked fused head at that width.
    lm_head_chunk: int = -1
    recovery_probation_steps: int = 25
    optimizer: str = "adamw"            # adamw | adam | sgd | adafactor
    # Storage dtype of the first moment (adamw/adam) or momentum trace
    # (sgd), e.g. "bfloat16"; None keeps f32.
    moment_dtype: Optional[str] = None
    checkpoint_dir: str = "checkpoints"
    # save() returns after the host snapshot; the write runs on a
    # background thread and commits at the next join point.
    async_checkpoint: bool = False
    # TensorBoard event files of the batch and epoch metrics.
    tensorboard_dir: Optional[str] = None
    # A torch.profiler trace (CPU and CUDA activity, Chrome format) of
    # train() under this directory, each step annotated ``train_step#N``.
    profile_dir: Optional[str] = None
    # Trap the first op that makes a NaN, forward or backward, with a
    # FloatingPointError naming it (a developer mode: it checks every op,
    # and it also trips on an attack's injected NaN).
    debug_nans: bool = False
    # Transfer rate of the migration-time model, GiB/s.
    migration_gbps: float = 1.0
    # Elastic eviction (confirmed nodes leave the node axis) and
    # readmission after this many steps (0: never): data and group modes.
    elastic_resharding: bool = False
    readmit_after_steps: int = 0
    # Input prefetch: batches assembled on a host thread ahead of the
    # step (data/loader.PrefetchLoader).  0 disables.
    prefetch_depth: int = 2
    # Async host pipeline (engine/async_host.py): up to this many steps in
    # flight, each step's host-facing metrics one packed device-to-host
    # copy read lagged by up to this many steps.  0 is the synchronous
    # loop.  Drills that assert FaultPlan.predict's exact retry counts
    # need 0: the lagged guard runs no in-place retry.
    async_host_depth: int = 2
    # The persistent kernel-build cache (utils/compile_cache.py): the
    # directory the kernel and native libraries build into and load from,
    # enabled by DistributedTrainer at construction.  None keeps the
    # default, build/torch_kernels/ under the checkout; cli train|serve
    # --compile-cache point it under the run directory.
    compilation_cache_dir: Optional[str] = None
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
        if self.parallelism not in PARALLELISM_MODES:
            raise ValueError(
                f"parallelism must be one of {PARALLELISM_MODES}, "
                f"got {self.parallelism!r}")
        if self.remat_policy not in ("block", "attention"):
            raise ValueError(
                "remat_policy must be 'block' or 'attention', "
                f"got {self.remat_policy!r}")
        if self.dtype not in COMPUTE_DTYPES:
            raise ValueError(f"dtype must be one of {sorted(COMPUTE_DTYPES)}"
                             f", got {self.dtype!r}")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")
        if self.async_host_depth < 0:
            raise ValueError("async_host_depth must be >= 0 (0 = "
                             f"synchronous), got {self.async_host_depth}")


@dataclass
class ExperimentConfig:
    """One experiment of the runner (the JAX package's
    ``ExperimentConfig``, field for field)."""

    experiment_name: str
    model_name: str = "gpt2"
    dataset_name: str = "openwebtext"
    num_nodes: int = 4
    num_epochs: int = 10
    batch_size: int = 32
    learning_rate: float = 5e-5
    attack_enabled: bool = True
    attack_start_epoch: int = 2
    # Transient attacks: injection stops from this epoch on (None =
    # sustained for the rest of the run).
    attack_end_epoch: Optional[int] = None
    attack_intensity: float = 0.5
    trust_threshold: float = 0.7
    save_interval: int = 100
    output_dir: str = "results"
    parallelism: str = "data"
    steps_per_epoch: int = 50
    seed: int = 0
    attack_types: List[str] = field(
        default_factory=lambda: ["gradient_poisoning", "data_poisoning"])
    target_nodes: List[int] = field(default_factory=lambda: [1, 3])
    num_microbatches: int = 0
    elastic_resharding: bool = False
    readmit_after_steps: int = 0
    recovery_probation_steps: int = 25

    def to_training_config(self) -> TrainingConfig:
        """The trainer's configuration, built as the JAX runner builds
        it."""
        return TrainingConfig(
            model_name=self.model_name,
            dataset_name=self.dataset_name,
            batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            num_epochs=self.num_epochs,
            num_nodes=self.num_nodes,
            trust_threshold=self.trust_threshold,
            parallelism=self.parallelism,
            num_microbatches=self.num_microbatches,
            seed=self.seed,
            elastic_resharding=self.elastic_resharding,
            readmit_after_steps=self.readmit_after_steps,
            recovery_probation_steps=self.recovery_probation_steps,
        )


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
    status: str = "trusted"

    @property
    def gpu_id(self) -> int:
        """The reference's name for ``device_id``."""
        return self.device_id


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


_MODEL_SIZE_SUFFIX = {"small": "", "medium": "-medium", "large": "-large",
                      "xl": "-xl"}

def _config_from_mapping(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Flatten the README schema's nested mapping (model / training /
    distributed / security sections) into TrainingConfig keyword
    arguments; flat field names of either package's TrainingConfig pass
    straight through (the JAX package's mapping, key for key)."""
    out: Dict[str, Any] = {}
    model = raw.get("model", {})
    if isinstance(model, dict):
        name = model.get("name")
        if name:
            size = str(model.get("size", "")).lower()
            suffix = _MODEL_SIZE_SUFFIX.get(size, "")
            out["model_name"] = (f"{name}{suffix}" if name.startswith("gpt")
                                 else name)
    training = raw.get("training", {})
    if isinstance(training, dict):
        for key in ("batch_size", "learning_rate", "num_epochs",
                    "lr_schedule", "warmup_steps", "lr_decay_steps",
                    "min_lr_ratio", "optimizer", "weight_decay",
                    "grad_clip_norm"):
            if key in training:
                out[key] = training[key]
    distributed = raw.get("distributed", {})
    if isinstance(distributed, dict):
        for key in ("num_nodes", "parallelism", "num_microbatches"):
            if key in distributed:
                out[key] = distributed[key]
        for key in ("mesh_shape", "dcn_mesh_shape"):
            if key in distributed:
                out[key] = dict(distributed[key])
    security = raw.get("security", {})
    if isinstance(security, dict):
        if "trust_threshold" in security:
            out["trust_threshold"] = security["trust_threshold"]
        if "attack_detection" in security:
            out["attack_detection_enabled"] = bool(
                security["attack_detection"])
        if "gradient_verification" in security:
            out["gradient_verification_enabled"] = bool(
                security["gradient_verification"])
    if "dataset" in raw:
        out["dataset_name"] = raw["dataset"]
    valid = {f.name for f in dataclasses.fields(TrainingConfig)}
    for key, value in raw.items():
        if key in valid:
            out[key] = value
    return out


def load_config(path: str, **overrides: Any) -> TrainingConfig:
    """A TrainingConfig from a YAML/JSON file (the nested README schema or
    flat field names; unknown keys are ignored, as in JAX), then every
    override that is not None on top (the command line's flags).  The
    port's ``TrainingConfig`` has every field of JAX's, so no key JAX
    applies is dropped."""
    kwargs = _config_from_mapping(_load_mapping(path))
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    return TrainingConfig(**kwargs)


def _load_mapping(path: str) -> Dict[str, Any]:
    """Parse a YAML (or, without pyyaml, JSON) config file to a mapping."""
    import json

    with open(path) as f:
        text = f.read()
    try:
        import yaml  # type: ignore

        raw = yaml.safe_load(text)
    except ImportError:
        try:
            raw = json.loads(text)
        except json.JSONDecodeError as e:
            raise RuntimeError(
                f"pyyaml unavailable and {path} is not JSON: {e}") from e
    if not isinstance(raw, dict):
        raise ValueError(f"config file {path} did not parse to a mapping")
    return raw


def load_experiment_config(path: str, **overrides: Any) -> ExperimentConfig:
    """An ExperimentConfig from a YAML/JSON file: the nested README schema
    or flat ExperimentConfig field names; unknown keys are ignored, and
    ``overrides`` that are not None win over the file."""
    raw = _load_mapping(path)
    flat = _config_from_mapping(raw)
    valid = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kwargs = {k: v for k, v in flat.items() if k in valid}
    for key, value in raw.items():
        if key in valid:
            kwargs[key] = value
    kwargs.update({k: v for k, v in overrides.items() if v is not None})
    kwargs.setdefault("experiment_name", "experiment")
    return ExperimentConfig(**kwargs)
