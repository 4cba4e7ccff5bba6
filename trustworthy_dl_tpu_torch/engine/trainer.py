"""DistributedTrainer: the host loop around the trusted training step.

Counterpart of ``trustworthy_dl_tpu/engine/trainer.py`` on its
data-parallel path: every batch is split over the logical nodes and runs
one :func:`engine.step.build_train_step` call; the host reads the step's
metrics in one packed device-to-host copy per step, records them in its
:class:`MetricsCollector`, records confirmed incidents
(``attack_history``), mirrors compromises into the host
:class:`TrustManager`, hands the flagged node's work to the most trusted
node (``reassignment_history``, with the migration-time model's estimate)
and counts each detection as a true or false positive against the attack
plan (the host detector's ``detection_stats``).  With the ML tier on
(``ml_detectors`` and scikit-learn importable, as in JAX) every step's
output and gradient batteries feed the host
:class:`detect.detector.AttackDetector`'s histories.  At epoch cadence it
absorbs the device trust and monitor state (``trust_manager``,
``node_monitor``), pushes the adaptive threshold back, refits the ML
tier's per-node IsolationForests and scores each node's newest features
(``ml_flags``), and, given a validation loader, evaluates
(``validate_metrics``).  The GPT-2 family (dense and MoE, whose records
carry ``moe_drop_fraction``) trains on token windows, the ResNet and VGG
families on f32 NHWC images with class labels.  The model
computes in ``config.dtype`` unless ``model_overrides`` names a dtype.

The loop, as in JAX: batches are assembled on a host thread
(``prefetch_depth``, :class:`data.loader.PrefetchLoader`), and at
``async_host_depth`` = K > 0 up to K steps are in flight while the host
reads each step's packed metrics K steps late
(:mod:`engine.async_host`); depth 0 reads every step before the next.
With ``elastic_resharding`` a confirmed node leaves the node axis
(:mod:`elastic.reassignment`: its per-node rows compacted, the steps
rebuilt, the loader re-sized) and, with ``readmit_after_steps`` > 0,
returns on probation after that many steps; a checkpoint's sidecar
carries the topology and the pending cool-offs, and a resume adopts
them.

Telemetry, as in JAX (``obs/``): :meth:`DistributedTrainer.attach_obs`
installs an ``ObsSession``.  The loop then times each accounted step's
phases on the session's step timer (``data``, ``compute``, ``detection``,
``checkpoint``; at ``async_host_depth`` > 0 ``compute`` is the dispatch
and ``host`` the time blocked on lagged metrics plus the host
bookkeeping), feeds its anomaly watcher each accepted step's loss and
gradient norm, and emits ``train_step``, ``trust_transition``,
``fleet_alert``, ``detection_verdict``, ``elastic_evict``,
``elastic_readmit``, ``ckpt_save`` and ``ckpt_restore`` on its trace;
the checkpointer, the metrics collector and a chaos injector are wired to
the same session.  Telemetry reads host copies the loop makes anyway: the
trajectory is bit-identical with or without it.  With the session's
compile watcher each step's dispatch runs under its ``train_step`` guard
(the first step's library loads are warmup; a topology change that
rebuilds the step resets the scope), and with its cost ledger the first
step the session sees runs under ``obs.hbm.count_flops`` (the ledger's
``train_step`` entry, the report's ``mfu_analyzed``): the counter reads
each op's shapes and changes nothing the step computes or launches.

Profiling and debugging, as in JAX (``utils/profiling.py``):
``config.profile_dir`` traces ``train()`` with ``torch.profiler``, each
step's dispatch annotated ``train_step#N``; ``config.debug_nans`` installs
the NaN trap at construction.

Durability, as in the JAX package: ``save_checkpoint`` /
``load_checkpoint`` through :class:`engine.checkpoint.CheckpointManager`
(every ``checkpoint_interval`` steps, never from non-finite params), and
two per-run hooks that a reset detaches: ``chaos`` (a
``chaos.FaultInjector`` consulted before and after every step) and
``step_guard`` (``engine.supervisor.TrainingSupervisor``, whose
``after_step`` may reject a step or roll back).

Pipeline ("model") parallelism, as in JAX (``parallel/pipeline.py``):
``parallelism="model"`` stacks the GPT-2 blocks over ``num_nodes``
stages (a stage is a trust node), runs the GPipe step on the
single-controller mesh (``core/mesh.py``; every stage on the trainer's
device), feeds it the global [B, T] batch trimmed to a multiple of
``num_microbatches`` (0 resolves to ``choose_num_microbatches``' depth
at construction, on the trainer's copy of the config), and keeps the
per-stage canary state.  With ``elastic_resharding`` a confirmed stage
is restaffed (``elastic/restaff.py``): the model repartitions over the
best-trusted survivors and the idle pool, and after
``readmit_after_steps`` the evicted identity re-enters the pool on
probation and the stage count regrows where the layer count allows.
Checkpoints hold the stage-stacked blocks; the sidecar carries the
stage count and the idle pool, and a resume adopts them.

Sequence parallelism, as in JAX (``parallel/sequence.py``):
``parallelism="sequence"`` builds the ``(nodes, group)`` data x seq mesh
(``mesh=`` gives one; by default one position, a ring of 1), binds it as
the sequence mesh (``core.mesh.bind_mode_mesh``, again when a checkpoint
adopts a new topology) and defaults the GPT family's ``attn_impl`` to
``"ring"``.  The step is the data-mode step: only the attention differs.
On the card, where the ring's chunks tile for the flash kernels, the
compute dtype must be the kernels' bf16 (refused at construction
otherwise).

Tensor, expert and hybrid parallelism, ZeRO-1 and FSDP, as in JAX: the
trainer builds the mode's mesh (``mesh=`` gives one; ``hybrid`` takes
``mesh_shape`` and ``dcn_mesh_shape``), binds the expert mesh in expert
mode (and warns, as JAX does, for a dense model there), and keeps the
layout of the params and the optimizer state as data beside the state:
``self.specs``, computed by ``core.sharding.layout_specs`` at
initialisation, restore, topology adoption and every elastic transition
(the TP layout in tensor and hybrid mode, ZeRO-1 with
``shard_opt_state`` and FSDP with ``shard_params`` on a data axis of more
than one position).  JAX's GSPMD computes the replicated program's
values; every position of the port's mesh is the trainer's device, so
the step is the data-mode step and a mode's trajectory equals data
mode's bit for bit.  With ``elastic_resharding`` a confirmed node leaves
with its whole group of positions in the group modes (tensor, sequence,
expert, hybrid where ``mesh_shape``'s data extent is the node count
within one slice: ``elastic.reassignment.elastic_supported``; another
hybrid layout keeps the in-step gating and the greedy hand-off, as in
JAX), and returns with it.

The trainer runs on the card (``device="cuda"``, the default) and raises
without CUDA unless the caller passes ``device="cpu"``, where every kernel
runs its plain PyTorch version.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from trustworthy_dl_tpu_torch.attacks.adversarial import AttackPlan, \
    null_plan
from trustworthy_dl_tpu_torch.core.config import COMPUTE_DTYPES, \
    NodeConfig, TrainingConfig
from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, SEQ_AXIS, Mesh, \
    bind_mode_mesh, build_mesh, node_axis_for
from trustworthy_dl_tpu_torch.core.sharding import layout_specs
from trustworthy_dl_tpu_torch.data.loader import PrefetchLoader
from trustworthy_dl_tpu_torch.detect.detector import AttackDetector, \
    AttackType
from trustworthy_dl_tpu_torch.detect.stats import GRADIENT_STAT_NAMES, \
    NUM_TENSOR_STATS, TENSOR_STAT_NAMES
from trustworthy_dl_tpu_torch.detect.verifier import FleetEpisodeTracker
from trustworthy_dl_tpu_torch.elastic.reassignment import \
    _check_hybrid_elastic, elastic_mesh_shape, elastic_supported, \
    evict_and_reshard, readmit_and_reshard
from trustworthy_dl_tpu_torch.engine.async_host import AsyncHostPipeline
from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager
from trustworthy_dl_tpu_torch.engine.optimizer import build_optimizer
from trustworthy_dl_tpu_torch.engine.state import TrainState, \
    init_train_state
from trustworthy_dl_tpu_torch.engine.step import HostMetricsPacker, \
    StepMetrics, build_node_eval_step, build_train_step
from trustworthy_dl_tpu_torch.models.factory import create_model
from trustworthy_dl_tpu_torch.obs.compilewatch import guarded
from trustworthy_dl_tpu_torch.obs.events import EventType
from trustworthy_dl_tpu_torch.ops.flash_attention import supports_flash
from trustworthy_dl_tpu_torch.serve.engine import resolve_device
from trustworthy_dl_tpu_torch.trust.manager import TrustManager
from trustworthy_dl_tpu_torch.trust.state import NodeStatus
from trustworthy_dl_tpu_torch.utils.compile_cache import \
    enable_persistent_cache
from trustworthy_dl_tpu_torch.utils.metrics import MetricsCollector
from trustworthy_dl_tpu_torch.utils.monitor import NodeMonitor
from trustworthy_dl_tpu_torch.utils.profiling import enable_nan_debugging, \
    step_annotation, trace
from trustworthy_dl_tpu_torch.utils.tree import map_tree, tree_leaves

logger = logging.getLogger(__name__)

#: The step metrics the host records every step (``_host_record``).
_HOST_FIELDS = ("per_node_loss", "weights", "trust_scores", "out_score",
                "grad_score", "attacked", "finite", "status", "attack_type",
                "out_stats", "grad_stats")


def _sklearn_available() -> bool:
    """The ML tier's gate, JAX's: scikit-learn importable."""
    try:
        import sklearn  # noqa: F401
        return True
    except ImportError:
        return False


class TrainingState(enum.Enum):
    """Trainer lifecycle."""

    INITIALIZING = "initializing"
    TRAINING = "training"
    UNDER_ATTACK = "under_attack"
    RECOVERING = "recovering"
    COMPLETED = "completed"


class DistributedTrainer:
    """Trusted training of ``config.num_nodes`` logical nodes on one
    device, in every parallelism mode of the JAX package: data, pipeline
    stages (``"model"``), sequence, tensor, expert and hybrid."""

    def __init__(self, config: TrainingConfig, mesh: Optional[Mesh] = None,
                 model_overrides: Optional[Dict[str, Any]] = None,
                 device: Any = "cuda"):
        self.device = resolve_device(device)
        if mesh is not None:
            _refuse_foreign_mesh(mesh, config.parallelism, self.device)
        if config.debug_nans:
            enable_nan_debugging()
        if config.compilation_cache_dir:
            enable_persistent_cache(config.compilation_cache_dir)
        # The epoch-cadence ML tier, gated once: without scikit-learn the
        # refit is a no-op, so the per-step battery feed would be waste.
        self._ml_enabled = config.ml_detectors and _sklearn_available()
        overrides = dict(model_overrides or {})
        if config.parallelism == "sequence" and \
                config.model_name.startswith("gpt"):
            overrides.setdefault("attn_impl", "ring")
        overrides.setdefault("dtype", COMPUTE_DTYPES[config.dtype])
        if config.lm_head_chunk >= 0:
            overrides.setdefault("lm_head_chunk", config.lm_head_chunk)
        if config.remat:
            overrides.setdefault("remat", True)
            overrides.setdefault("remat_policy", config.remat_policy)
        self.model = create_model(config.model_name, **overrides)
        self.optimizer = build_optimizer(config)
        self.mesh = mesh if mesh is not None else build_mesh(
            config.num_nodes, config.parallelism, config.mesh_shape,
            dcn_mesh_shape=config.dcn_mesh_shape, device=self.device)
        bind_mode_mesh(self.mesh, config.parallelism)
        if config.parallelism == "expert" and \
                "-moe" not in config.model_name:
            logger.warning(
                "parallelism='expert' with non-MoE model %r: the 'expert' "
                "mesh axis will carry no sharded computation",
                config.model_name)
        _refuse_untaken_ring(self.model, self.mesh, self.device)
        if config.parallelism == "model" and config.num_microbatches == 0:
            from trustworthy_dl_tpu_torch.parallel.pipeline import \
                choose_num_microbatches

            # Resolved into a copy: the caller's config keeps the 0
            # sentinel, to seed another trainer that resolves again.
            config = dataclasses.replace(
                config, num_microbatches=choose_num_microbatches(
                    config.batch_size, config.num_nodes))
        self._rebuild_steps(config)
        self.checkpointer = CheckpointManager(config.checkpoint_dir)
        # The built steps are shaped for this node count (reset_for_run).
        self._constructed_num_nodes = config.num_nodes
        self.state: Optional[TrainState] = None
        # The layout of the state's params and optimizer state on the mesh
        # (``core.sharding.layout_specs``); set with the state.
        self.specs: Optional[Dict[str, Any]] = None
        # Telemetry: an obs.ObsSession installed by ``attach_obs``.
        self.obs: Any = None
        self.training_state = TrainingState.INITIALIZING
        self._init_host_state()

    def _rebuild_steps(self, config: TrainingConfig) -> None:
        """Adopt ``config`` and build its train and eval steps: a step
        reads the node count when built, so a topology change rebuilds
        them."""
        self.config = config
        if config.parallelism == "model":
            from trustworthy_dl_tpu_torch.parallel.pipeline import \
                build_pipeline_eval_step, build_pipeline_train_step

            self._train_step = build_pipeline_train_step(
                self.model, config, self.optimizer, self.mesh)
            self._eval_step = build_pipeline_eval_step(self.model, config,
                                                       self.mesh)
        else:
            self._train_step = build_train_step(self.model, config,
                                                self.optimizer)
            self._eval_step = build_node_eval_step(self.model)
        watcher = getattr(getattr(self, "obs", None), "compilewatch", None)
        if watcher is not None:
            # The step was legitimately rebuilt for a new topology: its
            # next library load is warmup, not a storm.
            watcher.reset("train_step")

    def _init_host_state(self) -> None:
        """Per-run host world-view, shared by the constructor and
        :meth:`reset_for_run`: any host attribute a run mutates is
        (re)initialised here."""
        config = self.config
        self.current_epoch = 0
        self.global_step = 0
        self.trust_manager = TrustManager(
            num_nodes=config.num_nodes,
            trust_threshold=config.trust_threshold,
            initial_trust=config.initial_trust,
            decay_rate=config.trust_decay_rate,
            recovery_rate=config.trust_recovery_rate,
            alpha=config.trust_alpha)
        self.node_monitor = NodeMonitor()
        # The host detector: the ML tier's battery histories and models,
        # and the detections counted against the attack plan's ground
        # truth (``detection_stats``).
        self.attack_detector = AttackDetector(
            exact_order_stats=config.exact_order_stats, device=self.device)
        # Epoch-cadence ML-tier verdicts (original node id -> bool).
        self.ml_flags: Dict[int, bool] = {}
        self.node_configs: Dict[int, NodeConfig] = {
            i: NodeConfig(node_id=i, rank=i, world_size=config.num_nodes,
                          device_id=i, model_partition=f"shard_{i}")
            for i in range(config.num_nodes)}
        self.attack_history: List[Dict] = []
        self.reassignment_history: List[Dict] = []
        self._fleet_tracker = FleetEpisodeTracker()
        self.fleet_alerts: List[Dict] = self._fleet_tracker.episodes
        # Step coordinate -> original node id: identity until an elastic
        # eviction removes coordinates; host bookkeeping keys on ids.
        self.node_map: List[int] = list(range(config.num_nodes))
        # Nodes in a recorded-compromised episode: an incident is recorded
        # on the clean -> compromised transition only.
        self._open_incidents: set = set()
        self.metrics_collector = MetricsCollector(
            tensorboard_dir=config.tensorboard_dir,
            registry=self.obs.registry if self.obs is not None else None)
        # The previous accounted step's statuses: trust transitions are
        # emitted on change.
        self._last_status: Optional[np.ndarray] = None
        self.attack_plan: AttackPlan = null_plan(config.num_nodes,
                                                 self.device)
        # Per original id, the attack plan's injection bit (a readmitted
        # node's schedule survives the mask's compaction and expansion).
        self._plan_bits: Dict[int, bool] = {}
        # Elastic bookkeeping: original id -> eviction step, and the mesh
        # positions it left with (its group in the group modes; [] where
        # the nodes share the mesh's positions).
        self._evicted_at: Dict[int, int] = {}
        self._evicted_devices: Dict[int, List[Any]] = {}
        # Pipeline restaff: healthy ids a repartition could not seat,
        # re-staffed by the next restaff (elastic/restaff.py); their
        # devices, always [] on one card.
        self._idle_pool: Dict[int, List[Any]] = {}
        # The live loader, re-sized after a topology change; the per-node
        # batch is taken from each epoch's first batch.  ``_trim_grace``
        # counts the old-size batches still queued after a re-size.
        self._active_loader: Any = None
        self._per_node_batch: Optional[int] = None
        self._trim_grace = 0
        # While a lagged step drains (engine/async_host.py): its
        # DrainContext, which defers elastic evictions to the frontier.
        self._drain_ctx: Any = None
        # Durability hooks, per run so that a reset detaches them:
        # ``chaos`` is a chaos.FaultInjector consulted in the step loop;
        # ``step_guard`` implements ``after_step(trainer, node_batch,
        # metrics, lagged=False) -> Optional[StepMetrics]``, None
        # rejecting the step (the trainer must not account it); the
        # async drain calls it with ``lagged=True`` and no batch.  A
        # supervisor also wires its injector into the checkpointer's
        # commit hooks: detach that too, or a previous run's unfired
        # checkpoint faults would fire in the next run.
        self.chaos: Any = None
        self.step_guard: Any = None
        # When the last accepted step's host copy landed (step_s).
        self._t_prev: Optional[float] = None
        if hasattr(self, "checkpointer"):
            self.checkpointer.chaos = None

    @property
    def batch_history(self) -> List[Dict[str, Any]]:
        """The per-step records: a view of the collector's
        ``batch_metrics``."""
        return self.metrics_collector.batch_metrics

    # ------------------------------------------------------------------
    # Setup
    # ------------------------------------------------------------------

    def initialize(self, seed: Optional[int] = None,
                   params: Optional[Any] = None) -> TrainState:
        """Fresh params (drawn from ``seed``, or the ``params`` given in the
        model's own layout, e.g. converted from the JAX package),
        optimizer state and world-view.  In model mode the blocks stack
        over the stages first (raising where the layer count does not
        divide, as in JAX) and the canary state starts."""
        seed = self.config.seed if seed is None else seed
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        else:
            params = map_tree(lambda a: a.detach().to(
                device=self.device, dtype=torch.float32), params)
        c = self.config
        monitor_leaves = canary = None
        if c.parallelism == "model":
            from trustworthy_dl_tpu_torch.parallel.pipeline import \
                init_canary_state, make_canary, stack_stages

            params = dict(params)
            params["blocks"] = stack_stages(params["blocks"], c.num_nodes)
            monitor_leaves = len(tree_leaves(params["blocks"]))
            canary = init_canary_state(c.num_nodes, make_canary(
                self.model.config, c.canary_tokens, device=self.device))
        opt_state = self.optimizer.init(tree_leaves(params))
        rng = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.state = init_train_state(
            rng, params, opt_state, num_nodes=c.num_nodes,
            trust_threshold=c.trust_threshold,
            initial_trust=c.initial_trust, decay_rate=c.trust_decay_rate,
            recovery_rate=c.trust_recovery_rate,
            detector_window=c.detector_history, device=self.device,
            num_monitor_leaves=monitor_leaves, canary=canary)
        self._lay_out()
        self.training_state = TrainingState.TRAINING
        return self.state

    def _lay_out(self) -> None:
        """The state's layout on the current mesh, through the one spec
        function (``core.sharding.layout_specs``): every placement site
        (initialisation, restore, topology adoption, eviction,
        readmission, restaff) calls this, so a cycle reproduces a fresh
        trainer's specs."""
        c = self.config
        self.specs = layout_specs(
            c.parallelism, self.mesh, self.state.params,
            self.state.opt_state, shard_params=c.shard_params,
            shard_opt_state=c.shard_opt_state)

    def reset_for_run(self, seed: Optional[int] = None) -> TrainState:
        """A fresh run on the same built steps: device state (params,
        optimizer, trust, detector baselines) and the host world-view
        (trust manager, monitor, incident records, detection counts, step
        counter, attack plan) start over.  Raises after a topology change:
        the steps were rebuilt for another node count."""
        if self.config.num_nodes != self._constructed_num_nodes or \
                self.node_map != list(range(self._constructed_num_nodes)):
            raise RuntimeError("reset_for_run after a topology change; "
                               "rebuild the trainer instead")
        self._init_host_state()
        return self.initialize(seed=seed)

    def set_attack_plan(self, plan: AttackPlan,
                        target_ids: Optional[Sequence[int]] = None) -> None:
        """Install the experiment's fault-injection schedule.
        ``target_ids`` names the targeted original ids outright; otherwise
        they are read from the plan's mask through ``node_map``."""
        self.attack_plan = plan._replace(
            target_mask=plan.target_mask.to(self.device))
        if target_ids is not None:
            targets = {int(i) for i in target_ids}
            self._plan_bits = {nid: nid in targets
                               for nid in set(self.node_map) | targets}
        else:
            mask = plan.target_mask.tolist()
            self._plan_bits = {
                self.node_map[i]: bool(mask[i])
                for i in range(min(len(mask), len(self.node_map)))}

    def attach_obs(self, session: Any) -> None:
        """Install an ``obs.ObsSession``: step, trust, detection and
        checkpoint events flow to its trace bus (and flight recorder),
        the loop feeds its step timer, and the checkpointer, an installed
        chaos injector and the metrics collector (re-bound to the
        session's per-run registry) report to it too."""
        self.obs = session
        self.checkpointer.trace = session.trace
        self.metrics_collector.bind_registry(session.registry)
        if self.chaos is not None:
            self.chaos.trace = session.trace

    def _dispatch(self, node_batch: Dict[str, Any]) -> Any:
        """One step's dispatch, under the session's ``train_step`` compile
        guard and, for the first step the session sees, its cost
        ledger's count (``obs.hbm.CostLedger.count``), which the step
        timer marks so that the analyzed MFU leaves that step out."""
        obs = self.obs
        watcher = getattr(obs, "compilewatch", None)
        ledger = getattr(obs, "cost_ledger", None)
        counting = ledger is not None and "train_step" not in ledger.programs
        with step_annotation(self.global_step), \
                guarded(watcher, "train_step", step=self.global_step), \
                (ledger.count("train_step") if counting
                 else contextlib.nullcontext()):
            out = self._train_step(self.state, node_batch, self.attack_plan)
        if counting:
            obs.step_timer.note_counted()
        return out

    def _obs_note_model_info(self, node_batch: Dict[str, Any]) -> None:
        """Give the step timer what the nominal MFU needs, once: the
        parameter count and the work units a step (tokens for an LM,
        samples for a vision model)."""
        timer = self.obs.step_timer
        if not timer.has_model_info:
            timer.set_model_info(self.model.num_params(self.state.params),
                                 self.work_units(node_batch),
                                 model_kind=self.model.kind)

    def _node_batch(self, batch: Dict[str, np.ndarray],
                    for_eval: bool = False
                    ) -> Optional[Dict[str, torch.Tensor]]:
        """[B, ...] -> [n, B // n, ...] on the device.  Training trims B
        to a multiple of num_nodes x grad_accum_steps and raises below it,
        except for an old-size batch still queued after a topology grew
        (``_trim_grace``), which gives None: the caller skips it.
        Validation (``for_eval``) drops nothing: a batch that does not
        split evenly over the nodes is one row of B; an empty batch gives
        None.  Model mode keeps the global [B, ...] batch (the schedule
        splits it) trimmed to a multiple of ``num_microbatches``; there a
        validation tail below it gives None and a larger one is
        trimmed."""
        n = self.config.num_nodes
        lead = min(arr.shape[0] for arr in batch.values())
        if self.config.parallelism == "model":
            quantum = self.config.num_microbatches
            b = (lead // quantum) * quantum
            if b == 0:
                if for_eval:
                    return None
                raise ValueError(f"batch size {lead} < num_microbatches x "
                                 f"dp rows = {quantum}")
            return self._rows(batch, b, None)
        if for_eval:
            if lead == 0:
                return None
            rows = n if lead % n == 0 else 1
            return self._rows(batch, lead, rows)
        quantum = n * self.config.grad_accum_steps
        b = (lead // quantum) * quantum
        if b < lead and self._trim_grace > 0:
            self._trim_grace -= 1
            if b == 0:
                return None
        if b == 0:
            raise ValueError(f"batch size {lead} < num_nodes x "
                             f"grad_accum_steps = {quantum}")
        return self._rows(batch, b, n)

    def _rows(self, batch: Dict[str, np.ndarray], b: int,
              rows: Optional[int]) -> Dict[str, torch.Tensor]:
        """Host rows to the device, [rows, b // rows, ...] (``rows`` None:
        [b, ...]).  On a card the rows go through pinned memory with a
        copy that does not block the host (a pageable ``.to`` waits for
        every queued step); the step that reads them runs after the copy
        on the same stream."""
        out = {}
        for k, arr in batch.items():
            arr = np.asarray(arr)
            # Images stay f32; token and label ids become int64.
            dtype = torch.float32 if np.issubdtype(arr.dtype, np.floating) \
                else torch.long
            lead = (b,) if rows is None else (rows, b // rows)
            t = torch.as_tensor(arr[:b].reshape(lead + arr.shape[1:]),
                                dtype=dtype)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t.to(self.device)
        return out

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train_epoch(self, dataloader: Iterable[Dict[str, np.ndarray]],
                    epoch: int) -> float:
        if self.state is None:
            self.initialize()
        self.current_epoch = epoch
        epoch_loss, num_batches = 0.0, 0
        # The per-node batch is taken again from this loader's first
        # batch, so a later epoch's loader is never re-sized against a
        # stale capture.
        self._per_node_batch = None
        if self.config.prefetch_depth > 0 and not isinstance(
                dataloader, PrefetchLoader):
            dataloader = PrefetchLoader(dataloader,
                                        depth=self.config.prefetch_depth)
        self._active_loader = dataloader
        depth = self.config.async_host_depth
        pipe = AsyncHostPipeline(self, depth) if depth > 0 else None
        timer = self.obs.step_timer if self.obs is not None else None
        if timer is not None:
            timer.discard_step()    # anchor the first step's "data" lap
        self._t_prev = time.perf_counter()
        try:
            for batch_idx, batch in enumerate(dataloader):
                self.global_step += 1
                if self._per_node_batch is None and \
                        self.config.parallelism != "model":
                    lead = min(arr.shape[0] for arr in batch.values())
                    per = lead // (self.config.num_nodes
                                   * self.config.grad_accum_steps)
                    if per > 0:
                        self._per_node_batch = per
                if self.chaos is not None:
                    # A lost batch is not a step; a stall sleeps; a
                    # simulated preemption raises for the supervisor.
                    batch = self.chaos.on_batch(self.global_step, batch)
                    if batch is None:
                        self.global_step -= 1
                        continue
                    self.chaos.on_step_start(self.global_step)
                node_batch = self._node_batch(batch)
                if node_batch is None:      # a stale undersized batch
                    self.global_step -= 1
                    if timer is not None:
                        timer.discard_step()
                    continue
                if timer is not None:
                    self._obs_note_model_info(node_batch)
                    timer.lap("data")  # loader, host assembly, the copy
                self.state, metrics = self._dispatch(node_batch)
                if self.chaos is not None:
                    self.state, metrics = self.chaos.on_step_end(
                        self.global_step, self.state, metrics)
                if pipe is not None:
                    # Pack and start the host copy, then drain what fell
                    # out of the window.  A record's step_s is the wall
                    # between two dispatches.
                    now = time.perf_counter()
                    pipe.push(epoch, batch_idx, metrics, self.state,
                              now - self._t_prev)
                    self._t_prev = now
                    dispatched = self.global_step
                    if timer is not None:
                        timer.lap("compute")    # the dispatch, no sync
                    pipe.drain()
                    ckpt_step = \
                        dispatched % self.config.checkpoint_interval == 0
                    if ckpt_step:
                        pipe.drain(0)   # a full drain before a save
                    if timer is not None:
                        # Both drains: blocked on lagged metrics plus the
                        # host bookkeeping.
                        timer.lap("host")
                    # Save only a frontier that survived its drain: a
                    # rollback moved the counter, and a rejected step
                    # must not become "verified".
                    if ckpt_step and self.global_step == dispatched and \
                            pipe.last_rejected_step != dispatched:
                        self.save_checkpoint()
                    if timer is not None:
                        timer.lap("checkpoint")
                        if pipe.consume_rejection():
                            # A rejected step's retry or rollback time
                            # would poison the phase distribution.
                            timer.discard_step()
                        else:
                            timer.finish_step(step=self.global_step)
                        self.obs.on_step(self.global_step)
                    continue
                if self.step_guard is not None:
                    metrics = self.step_guard.after_step(self, node_batch,
                                                         metrics)
                    if metrics is None:
                        # Rejected (and perhaps rolled back, global_step
                        # then restored): nothing to account, and its
                        # wall time would poison the phase distribution.
                        if timer is not None:
                            timer.discard_step()
                        continue
                record = self._account(metrics, epoch, timer)
                self._maybe_readmit()
                if timer is not None:
                    timer.lap("detection")  # host verdicts and records
                epoch_loss += record["loss"]
                num_batches += 1
                if self.global_step % self.config.checkpoint_interval == 0:
                    self.save_checkpoint()
                if timer is not None:
                    timer.lap("checkpoint")
                    timer.finish_step(step=self.global_step)
                    self.obs.on_step(self.global_step)
                if batch_idx % 10 == 0:
                    logger.info("Epoch %d, Batch %d, Loss: %.4f", epoch,
                                batch_idx, record["loss"])
        finally:
            if pipe is not None:
                # The full drain that epoch aggregation, the host sync
                # below and a preemption's save all need.
                pipe.drain(0)
                epoch_loss += pipe.epoch_loss
                num_batches += pipe.num_batches
        self.sync_host_state()
        self._epoch_intelligence()
        avg = epoch_loss / max(num_batches, 1)
        self.metrics_collector.collect_epoch_metrics({
            "epoch": epoch, "avg_loss": avg, "num_batches": num_batches,
            "system_trust": self.trust_manager.calculate_system_trust()})
        logger.info("Epoch %d completed. Average loss: %.4f", epoch, avg)
        return avg

    def train_step(self, batch: Dict[str, np.ndarray], epoch: int
                   ) -> Dict[str, Any]:
        """One trusted step on a host batch, synchronously and without the
        durability hooks; returns its ``batch_history`` record."""
        self.global_step += 1
        node_batch = self._node_batch(batch)
        self.state, metrics = self._dispatch(node_batch)
        return self._account(metrics, epoch)

    def _account(self, metrics: StepMetrics, epoch: int,
                 timer: Any = None) -> Dict[str, Any]:
        """Host view, step time and records of an accepted step on the
        synchronous loop.  A record's ``step_s`` is the wall since the
        previous accepted step's host copy landed (the previous step's
        record-keeping, this step's batch in, its step and its host
        copy), so the steps tile the epoch.  ``timer`` (a step timer)
        closes its ``compute`` lap when the host copy has landed."""
        self.metrics_collector.tick()
        host = self._host_view(metrics)
        if timer is not None:
            timer.lap("compute")    # dispatch, the step, its host copy
        now = time.perf_counter()
        t_prev, self._t_prev = self._t_prev, now
        return self._record_batch(host, epoch,
                                  None if t_prev is None else now - t_prev)

    def _epoch_intelligence(self) -> None:
        """Adaptive trust threshold, pushed back into the step's state;
        the ML tier's refit and each live node's verdict on its newest
        features."""
        if self.config.adaptive_thresholds:
            self.trust_manager.adaptive_threshold_adjustment()
            threshold = torch.full((), self.trust_manager.trust_threshold,
                                   dtype=torch.float32, device=self.device)
            self.state = self.state._replace(
                trust=self.state.trust._replace(threshold=threshold))
        if self._ml_enabled:
            detector = self.attack_detector
            detector.update_detection_models()
            self.ml_flags = {}
            for orig in self.node_map:
                features = detector.latest_features(orig)
                if features:
                    self.ml_flags[orig] = detector.detect_with_ml_models(
                        features, orig)
            if any(self.ml_flags.values()):
                logger.warning("ML detectors flagged nodes: %s",
                               [n for n, v in self.ml_flags.items() if v])

    def work_units(self, node_batch: Dict[str, Any]) -> int:
        """Work per step of a node-split batch: tokens for an LM, samples
        for a vision model."""
        first = node_batch.get("input")
        if first is None:
            first = next(iter(node_batch.values()))
        if self.model.kind == "lm":
            return int(np.prod(first.shape))
        return int(first.shape[0] * first.shape[1])

    def _host_view(self, metrics: StepMetrics) -> Dict[str, Any]:
        """The synchronous read of a step: pack (with the post-step fleet
        streak), wait for the one host copy, unpack."""
        streak = self.state.fleet_raw_streak
        packer = HostMetricsPacker(metrics, streak)
        return self._host_record(*packer.unpack(packer.pack(metrics,
                                                            streak)))

    @staticmethod
    def _host_record(metrics: StepMetrics, streak: Any) -> Dict[str, Any]:
        """The fields ``_record_batch`` reads, from unpacked (numpy)
        metrics."""
        out: Dict[str, Any] = {"loss": float(metrics.loss),
                               "grad_norm": float(metrics.grad_norm),
                               "system_trust": float(metrics.system_trust)}
        for key in _HOST_FIELDS:
            out[key] = np.asarray(getattr(metrics, key))
        # Model diagnostics (the MoE drop fraction), absent elsewhere.
        out["model_aux"] = {k: float(v) for k, v in
                            (metrics.model_aux or {}).items()}
        fleet = metrics.fleet_alert is not None
        out["fleet_alert"] = bool(metrics.fleet_alert) if fleet else None
        out["fleet_streak"] = int(np.asarray(streak).reshape(-1)[0]) \
            if fleet and streak is not None else None
        return out

    def _record_batch(self, host: Dict[str, Any], epoch: int,
                      step_s: Optional[float] = None) -> Dict[str, Any]:
        attacked, finite = host["attacked"], host["finite"]
        status, trust = host["status"], host["trust_scores"]
        id_of = self.node_map
        if self.obs is not None:
            self._obs_record(host, epoch)
        record = {
            "step": self.global_step, "epoch": epoch, "loss": host["loss"],
            "step_s": step_s,
            "per_node_loss": host["per_node_loss"].tolist(),
            "weights": host["weights"].tolist(),
            "attacked": attacked.tolist(),
            "trust_scores": {id_of[i]: float(trust[i])
                             for i in range(len(trust))},
            **host["model_aux"]}
        self.metrics_collector.collect_batch_metrics(record)
        record = self.metrics_collector.batch_metrics[-1]
        if self._ml_enabled:
            # The ML tier's corpus.  An output battery is 12 real stats and
            # 5 zero pads; only the real columns are named.
            detector = self.attack_detector
            for coord, orig in enumerate(id_of):
                detector.output_history[orig].append({"stats": dict(zip(
                    TENSOR_STAT_NAMES,
                    host["out_stats"][coord][:NUM_TENSOR_STATS]))})
                detector.gradient_history[orig].append({"stats": dict(zip(
                    GRADIENT_STAT_NAMES, host["grad_stats"][coord]))})

        if host["fleet_alert"] is not None:
            opened = self._fleet_tracker.update(
                host["fleet_alert"], host["fleet_streak"], self.global_step,
                extra={"epoch": epoch,
                       "median_grad_norm": host["grad_norm"]})
            if opened is not None:
                logger.error("fleet-level norm surge at step %d",
                             self.global_step)
                self.training_state = TrainingState.UNDER_ATTACK
                if self.obs is not None:
                    self.obs.trace.emit(
                        EventType.FLEET_ALERT, step=self.global_step,
                        median_grad_norm=opened.get("median_grad_norm"))

        flagged = attacked | ~finite
        # Evicted nodes have no coordinate: their incidents stay open.
        coord_of = {orig: i for i, orig in enumerate(id_of)}
        for orig in list(self._open_incidents):
            coord = coord_of.get(orig)
            if coord is not None and not flagged[coord] and status[coord] \
                    != int(NodeStatus.COMPROMISED):
                self._open_incidents.discard(orig)
        evict_coords: List[int] = []
        if flagged.any():
            flagged_ids = {id_of[int(c)] for c in np.nonzero(flagged)[0]}
            for coord in np.nonzero(flagged)[0]:
                orig = id_of[int(coord)]
                if orig in self._open_incidents:
                    continue
                self._open_incidents.add(orig)
                self._handle_detected_attack(
                    orig, AttackType(int(host["attack_type"][coord])).label
                    if attacked[coord] else "gradient_verification_failure",
                    host, int(coord), flagged_ids)
                evict_coords.append(int(coord))
        if self._drain_ctx is not None:
            # A lagged drain: the entries still in flight were packed for
            # this node count, so the eviction waits for the frontier.
            self._drain_ctx.evict_coords.update(evict_coords)
        else:
            self._apply_evictions(evict_coords)
        return record

    def _obs_record(self, host: Dict[str, Any], epoch: int) -> None:
        """An accounted step's telemetry: the ``train_step`` event, the
        anomaly watcher's loss and gradient-norm feed (accepted steps
        only, so its baseline is the healthy run; a rejected step's
        values reach it through the supervisor), and a
        ``trust_transition`` per node whose status changed."""
        trace = self.obs.trace
        trace.emit(EventType.TRAIN_STEP, step=self.global_step, epoch=epoch,
                   loss=host["loss"], grad_norm=host["grad_norm"],
                   system_trust=host["system_trust"])
        if self.obs.anomaly is not None:
            self.obs.anomaly.observe("loss", host["loss"],
                                     step=self.global_step)
            self.obs.anomaly.observe("grad_norm", host["grad_norm"],
                                     step=self.global_step)
        status, trust = host["status"], host["trust_scores"]
        prev = self._last_status
        if prev is not None and len(prev) == len(status):
            for coord in np.nonzero(status != prev)[0]:
                trace.emit(
                    EventType.TRUST_TRANSITION, step=self.global_step,
                    node=int(self.node_map[int(coord)]),
                    from_status=NodeStatus(int(prev[coord])).name,
                    to_status=NodeStatus(int(status[coord])).name,
                    trust=float(trust[int(coord)]))
        self._last_status = status.copy()

    # ------------------------------------------------------------------
    # Elasticity on one card: data and the group modes
    # (elastic/reassignment.py) and the pipeline restaff
    # (elastic/restaff.py)
    # ------------------------------------------------------------------

    def _apply_evictions(self, evict_coords: Sequence[int]) -> None:
        """Evict confirmed coordinates and re-size the loader, or restaff
        the pipeline in model mode; a lagged drain defers this to a
        full-drain point, the synchronous loop calls it at once."""
        evict_coords = list(evict_coords)
        if not (evict_coords and self.config.elastic_resharding
                and len(evict_coords) < self.config.num_nodes):
            return
        if self.config.parallelism == "model":
            from trustworthy_dl_tpu_torch.elastic.restaff import \
                restaff_pipeline

            # The compromised stage's layers migrate and the model
            # repartitions: every layer keeps training.
            record = restaff_pipeline(self, evict_coords)
        elif elastic_supported(self.config):
            record = evict_and_reshard(self, evict_coords)
        else:
            # A hybrid layout eviction cannot reshape (JAX's fallback):
            # the in-step gating and the greedy hand-off stand.
            return
        record["step"] = self.global_step
        self.reassignment_history.append(record)
        for orig in record["evicted_nodes"]:
            # The cool-off clock of a readmission starts.
            self._evicted_at[int(orig)] = self.global_step
        self._resize_loader()
        if self.obs is not None:
            self.obs.trace.emit(
                EventType.ELASTIC_EVICT, step=self.global_step,
                nodes=[int(n) for n in record["evicted_nodes"]],
                live_nodes=self.config.num_nodes)

    def _readmit_due(self) -> bool:
        """Would :meth:`_maybe_readmit` act now?  The pipeline polls this
        to know when a readmission needs a full drain."""
        cfg = self.config
        if not (cfg.elastic_resharding and cfg.readmit_after_steps > 0
                and self._evicted_at):
            return False
        return any(self.global_step - when >= cfg.readmit_after_steps
                   for when in self._evicted_at.values())

    def _maybe_readmit(self) -> None:
        """Readmit the evicted nodes whose cool-off
        (``readmit_after_steps``) has passed, on probation: without it a
        false-positive eviction costs 1/n of the fleet for the rest of the
        run.  Model mode returns the identity to the restaff pool and
        regrows the stage count where the layer count allows."""
        if not self._readmit_due():
            return
        cfg = self.config
        due = sorted(nid for nid, when in self._evicted_at.items()
                     if self.global_step - when >= cfg.readmit_after_steps)
        if cfg.parallelism == "model":
            self._readmit_stages(due)
        elif elastic_supported(cfg):
            record = readmit_and_reshard(self, due)
            record["step"] = self.global_step
            self.reassignment_history.append(record)
            self._resize_loader()
        if self.obs is not None:
            self.obs.trace.emit(
                EventType.ELASTIC_READMIT, step=self.global_step,
                nodes=[int(n) for n in due],
                live_nodes=self.config.num_nodes)

    def _readmit_stages(self, due: Sequence[int]) -> None:
        """Model mode's return path: the cooled-off evicted identities
        enter the restaff pool on probation (RECOVERING at the 0.5 trust
        floor), and a restaff at once regrows the stage count where the
        layer count allows; otherwise they wait in the pool for the next
        restaff."""
        from trustworthy_dl_tpu_torch.elastic.restaff import \
            choose_stage_count, restaff_pipeline

        for nid in due:
            self._idle_pool[nid] = self._evicted_devices.pop(nid, []) or []
            self._evicted_at.pop(nid, None)
            self._open_incidents.discard(nid)
            self.trust_manager.begin_probation(nid)
        lead = tree_leaves(self.state.params["blocks"])[0]
        grown = choose_stage_count(lead.shape[0] * lead.shape[1],
                                   self.config.num_nodes
                                   + len(self._idle_pool))
        if grown > self.config.num_nodes:
            record = restaff_pipeline(self, [])
            record["step"] = self.global_step
            self.reassignment_history.append(record)

    def _resize_loader(self) -> None:
        """Re-size the live loader after a topology change so its batch
        divides nodes x accumulation again (otherwise every later batch is
        trimmed).  Works on a loader with a ``batch_size`` attribute (both
        of the package's); another keeps the trimming.  Model mode keeps
        its global batch (the stage count does not split it)."""
        loader = self._active_loader
        if loader is None or self._per_node_batch is None or \
                self.config.parallelism == "model":
            return
        new_bs = (self._per_node_batch * self.config.num_nodes
                  * self.config.grad_accum_steps)
        target = loader.loader if isinstance(loader, PrefetchLoader) \
            else loader
        if hasattr(target, "batch_size") and target.batch_size != new_bs:
            logger.info("Loader re-sized for the new topology: batch %d -> "
                        "%d (%d nodes x %d a node x %d accumulation)",
                        target.batch_size, new_bs, self.config.num_nodes,
                        self._per_node_batch, self.config.grad_accum_steps)
            target.batch_size = new_bs
            self.config = dataclasses.replace(self.config,
                                              batch_size=new_bs)
            # Old-size batches may already wait in the prefetch queue.
            self._trim_grace = max(self.config.prefetch_depth, 1) + 1

    def _handle_detected_attack(self, node_id: int, attack_type: str,
                                host: Dict[str, Any], coord: int,
                                exclude: set) -> None:
        """Record the incident, count it against the attack plan's ground
        truth, mirror the compromise into the host trust manager and hand
        the node's work to the most trusted node.  The in-step gating
        already happened."""
        logger.error("Attack detected on node %d (%s)", node_id, attack_type)
        plan = self.attack_plan
        live = bool(plan.active) and self.global_step - 1 >= plan.start_step
        is_tp = live and coord < len(plan.target_mask) and bool(
            plan.target_mask[coord])
        ds = self.attack_detector.detection_stats
        ds["total_detections"] += 1
        ds["attack_types"][attack_type] += 1
        ds["true_positives" if is_tp else "false_positives"] += 1
        if self.obs is not None:
            self.obs.trace.emit(
                EventType.DETECTION_VERDICT, step=self.global_step,
                node=int(node_id), attack_type=attack_type,
                ground_truth_positive=is_tp,
                out_score=float(host["out_score"][coord]),
                grad_score=float(host["grad_score"][coord]))
        self.attack_history.append({
            "node_id": node_id, "timestamp": time.time(),
            "step": self.global_step, "attack_type": attack_type,
            "output_stats": {
                "anomaly_score": float(host["out_score"][coord]),
                "gradient_score": float(host["grad_score"][coord])}})
        self.trust_manager.mark_compromised(node_id, attack_type)
        if not (self.config.elastic_resharding
                and (elastic_supported(self.config)
                     or self.config.parallelism == "model")):
            # The greedy hand-off; elastic mode evicts the node (restaffs
            # a stage) instead.
            self.reassign_node_tasks(node_id, exclude)
        self.training_state = TrainingState.UNDER_ATTACK

    def reassign_node_tasks(self, compromised_node_id: int,
                            exclude: Optional[set] = None) -> None:
        unfit = set(exclude or ()) | {compromised_node_id}
        trusted = [n for n in self.trust_manager.get_trusted_nodes()
                   if n not in unfit]
        if not trusted:
            logger.error("No trusted nodes available for reassignment")
            return
        best = max(trusted, key=self.trust_manager.get_trust_score)
        migration_time = self.estimate_migration_time(compromised_node_id,
                                                      best)
        self.perform_task_reassignment(compromised_node_id, best)
        self.reassignment_history.append({
            "from_node": compromised_node_id, "to_node": best,
            "timestamp": time.time(), "migration_time": migration_time,
            "step": self.global_step})

    def estimate_migration_time(self, source_node: int, target_node: int
                                ) -> float:
        """Seconds to move a node's share of the f32 parameters at
        ``migration_gbps`` GiB/s, plus a 2 s setup (the JAX package's
        model)."""
        if self.state is None:
            return 2.0
        n_params = self.model.num_params(self.state.params)
        shard = n_params / max(self.config.num_nodes, 1)
        return shard * 4 / (self.config.migration_gbps * 1024 ** 3) + 2.0

    def perform_task_reassignment(self, source_node: int, target_node: int
                                  ) -> None:
        """The flagged node's contribution is already zero-weighted in the
        step; reassignment relabels its data shard onto the target."""
        target = self.node_configs[target_node]
        target.model_partition = (f"shard_{source_node}+"
                                  f"{target.model_partition}")
        logger.info("Task reassignment completed: %d -> %d", source_node,
                    target_node)

    def train(self, train_dataloader: Iterable[Dict[str, np.ndarray]],
              val_dataloader: Optional[Iterable[Dict[str, np.ndarray]]]
              = None, num_epochs: Optional[int] = None) -> Dict[str, Any]:
        if num_epochs is None:
            num_epochs = self.config.num_epochs
        if self.state is None:
            self.initialize()
        self.training_state = TrainingState.TRAINING
        history = []
        with trace(self.config.profile_dir):
            for epoch in range(num_epochs):
                record = {"epoch": epoch,
                          "train_loss": self.train_epoch(train_dataloader,
                                                         epoch)}
                if val_dataloader is not None:
                    record["val_loss"] = self.validate(val_dataloader)
                    logger.info("Validation loss: %.4f", record["val_loss"])
                if self.training_state == TrainingState.UNDER_ATTACK:
                    self.training_state = TrainingState.RECOVERING
                history.append(record)
        self.training_state = TrainingState.COMPLETED
        return {"epochs": history, "stats": self.get_training_stats()}

    def validate(self, val_dataloader: Iterable[Dict[str, np.ndarray]]
                 ) -> float:
        """Mean validation loss."""
        return self.validate_metrics(val_dataloader)["loss"]

    def validate_metrics(self, val_dataloader: Iterable[Dict[str, np.ndarray]]
                         ) -> Dict[str, float]:
        """Loss, accuracy and (for LMs) perplexity, each an
        example-weighted mean over the loader's batches (a ragged tail
        counts by its size)."""
        total = acc = 0.0
        examples = 0
        for batch in val_dataloader:
            batch = self._node_batch(batch, for_eval=True)
            if batch is None:
                continue
            out = self._eval_step(self.state.params, batch)
            first = next(iter(batch.values()))
            # Model mode feeds the global [B, ...] batch, the other the
            # node split [rows, per_row, ...].
            weight = int(first.shape[0]) if \
                self.config.parallelism == "model" else \
                int(first.shape[0] * first.shape[1])
            pulled = torch.stack([out["loss"], out["accuracy"]]).tolist()
            total += pulled[0] * weight
            acc += pulled[1] * weight
            examples += weight
        n = max(examples, 1)
        metrics = {"loss": total / n, "accuracy": acc / n}
        if self.model.kind == "lm":
            metrics["perplexity"] = float(np.exp(min(metrics["loss"], 30.0)))
        return metrics

    def sync_host_state(self) -> None:
        """Epoch-cadence absorption of the device trust and monitor
        state."""
        if self.state is not None:
            self.trust_manager.sync_from_device(self.state.trust,
                                                node_ids=self.node_map)
            self.node_monitor.sync_from_device(self.state.monitor,
                                               node_ids=self.node_map)

    def get_training_stats(self) -> Dict[str, Any]:
        return {
            "current_epoch": self.current_epoch,
            "global_step": self.global_step,
            "training_state": self.training_state.value,
            "trust_scores": {i: self.trust_manager.get_trust_score(i)
                             for i in range(self.config.num_nodes)},
            "attack_count": len(self.attack_history),
            "reassignment_count": len(self.reassignment_history),
            "fleet_alert_count": len(self.fleet_alerts),
            "metrics": self.metrics_collector.get_summary(),
            "trust_threshold": self.trust_manager.trust_threshold,
            "ml_flags": dict(self.ml_flags),
            "predicted_reliability": {
                i: self.trust_manager.predict_node_reliability(i)
                for i in range(self.config.num_nodes)},
        }

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    def save_checkpoint(self) -> Optional[str]:
        """Save the whole state as ``global_step``, with its topology
        sidecar.  Non-finite params are never saved: "verified" means
        integrity-verified and taken from sane state, so corruption on a
        save step cannot poison the rollback target."""
        if self.state is None:
            return None
        leaves = [leaf for leaf in tree_leaves(self.state.params)
                  if leaf.is_floating_point()]
        if not bool(torch.stack([torch.isfinite(leaf).all()
                                 for leaf in leaves]).all()):
            logger.error("Refusing to checkpoint non-finite params at step "
                         "%d; keeping the last good checkpoint",
                         self.global_step)
            return None
        # A committed payload at this step is skipped by save(), so its
        # sidecar stays; uncommitted junk is rewritten with its sidecar.
        already = self.checkpointer.check_integrity(self.global_step,
                                                    verify=False)[0]
        path = self.checkpointer.save(
            self.state, self.global_step,
            block=not self.config.async_checkpoint)
        if self.obs is not None:
            self.obs.trace.emit(EventType.CKPT_SAVE, step=self.global_step,
                                path=path,
                                blocking=not self.config.async_checkpoint)
        if already:
            logger.warning("Checkpoint step %d already existed; keeping its "
                           "sidecar (payload was not rewritten)",
                           self.global_step)
            return path
        self.checkpointer.save_metadata(self.global_step, {
            "num_nodes": self.config.num_nodes,
            "node_map": list(self.node_map),
            "parallelism": self.config.parallelism,
            # The live mesh's positions: after a group eviction the mesh
            # has fewer than the constructor built, and a resume rebuilds
            # this set (a readmission then returns the evicted group).
            "mesh_devices": [str(d) for d in self.mesh.devices.flat],
            # Evicted ids have no device row: their standing survives the
            # resume on the host.
            "compromised_nodes": sorted(
                int(i) for i in self.trust_manager.get_compromised_nodes()),
            # Pending cool-offs, the positions each evicted id left with
            # and the restaff's parked ids survive a resume, or an
            # eviction would silently become permanent.
            "evicted_at": {str(nid): int(step)
                           for nid, step in self._evicted_at.items()},
            "evicted_devices": {str(nid): [str(d) for d in devs or []]
                                for nid, devs in
                                self._evicted_devices.items()},
            "idle_pool": {str(nid): [] for nid in self._idle_pool},
        })
        return path

    def _positions(self, saved: Sequence[str]) -> List[torch.device]:
        """Saved mesh positions re-resolved on this trainer: every
        position of the port's mesh is its device."""
        return [self.device] * len(saved)

    def _adopt_topology(self, meta: Dict[str, Any]) -> None:
        """Rebuild the mesh, the steps and the state's template for a
        checkpoint saved on another node count (after an eviction): over
        the saved positions where the sidecar has them (a checkpoint of
        an older layout: the current positions), a hybrid mesh_shape's
        data extent the saved count."""
        n = int(meta["num_nodes"])
        logger.info("Checkpoint topology has %d node(s) (config says %d): "
                    "adopting the saved topology", n, self.config.num_nodes)
        config = dataclasses.replace(
            self.config, num_nodes=n,
            mesh_shape=elastic_mesh_shape(self.config, n))
        if config.parallelism == "hybrid":
            # Only an elastic hybrid layout makes such a checkpoint: any
            # other fails here rather than rebuild without its extents.
            _check_hybrid_elastic(config)
        positions = self._positions(meta["mesh_devices"]) \
            if "mesh_devices" in meta else list(self.mesh.devices.flat)
        self.mesh = build_mesh(n, config.parallelism, config.mesh_shape,
                               devices=positions,
                               dcn_mesh_shape=config.dcn_mesh_shape,
                               device=self.device)
        bind_mode_mesh(self.mesh, config.parallelism)
        self._rebuild_steps(config)
        self.node_map = [int(i) for i in meta["node_map"]]
        # The attack plan was shaped for the old node count: reset it
        # (the caller plans again).
        self.attack_plan = null_plan(n, self.device)
        self.state = None   # the template takes the new shapes

    def load_checkpoint(self, step: Optional[int] = None) -> TrainState:
        """Restore the whole world-view (weights, optimizer, trust,
        detector baselines, step, epoch and the generator), then mirror it
        into the host objects.  ``step=None`` takes the newest verified
        step.  A checkpoint saved after an eviction restores onto its
        saved topology, with its pending cool-offs."""
        if step is None:
            step = self.checkpointer.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.config.checkpoint_dir}")
        meta = self.checkpointer.load_metadata(step)
        if meta and int(meta["num_nodes"]) != self.config.num_nodes:
            self._adopt_topology(meta)
        if self.state is None:
            self.initialize()
        self.state = self.checkpointer.restore(self.state, step)
        self._lay_out()
        if meta:
            self.node_map = [int(i) for i in meta["node_map"]]
            # Ids may exceed the constructor's node count (a trainer built
            # with the post-eviction count): grow the host bookkeeping.
            max_id = max(self.node_map + [int(i) for i in
                                          meta.get("compromised_nodes", [])],
                         default=-1)
            self.trust_manager.grow_to(max_id + 1)
            live = set(self.node_map)
            for node_id in meta.get("compromised_nodes", []):
                node_id = int(node_id)
                if node_id not in live and (
                        self.trust_manager.get_node_status(node_id)
                        != NodeStatus.COMPROMISED):
                    # No device row to sync from: restore the host-side
                    # standing directly, once.
                    self.trust_manager.mark_compromised(
                        node_id, attack_type="restored_from_checkpoint")
            self._evicted_at = {int(k): int(v) for k, v in
                                meta.get("evicted_at", {}).items()}
            self._evicted_devices = {
                int(k): self._positions(v)
                for k, v in meta.get("evicted_devices", {}).items()}
            self._idle_pool = {int(k): [] for k in
                               meta.get("idle_pool", {})}
        self.global_step = int(self.state.step)
        # A restore redraws the status rows: transitions re-anchor.
        self._last_status = None
        if self.obs is not None:
            self.obs.trace.emit(EventType.CKPT_RESTORE, step=step,
                                restored_step=self.global_step)
        self.sync_host_state()
        return self.state

    def cleanup(self) -> None:
        """Join any in-flight save, close the collector, drop the
        state."""
        self.checkpointer.wait()
        self.metrics_collector.close()
        self.state = None
        logger.info("Distributed training cleanup completed")


def _refuse_foreign_mesh(mesh: Mesh, parallelism: str,
                         device: torch.device) -> None:
    """A given mesh must be the mode's (its node axis present: a sequence
    mesh without ``seq`` would quietly run full attention; a hybrid mesh
    carries its nodes on ``data``) and lie on the trainer's device at
    every position (one card; a CPU position would take a card's
    attention or stage to the CPU unseen)."""
    axis = DATA_AXIS if parallelism == "hybrid" else \
        node_axis_for(parallelism)
    if axis not in mesh.axis_names:
        raise ValueError(f"parallelism={parallelism!r} needs a mesh with a "
                         f"{axis!r} axis, got {mesh.axis_names}")
    want = (device.type, device.index or 0)
    for dev in mesh.devices.flat:
        dev = torch.device(dev)
        if (dev.type, dev.index or 0) != want:
            raise ValueError(f"mesh position on {dev} for a trainer on "
                             f"{device}: the port trains on one device, so "
                             f"every position must be it")


def _refuse_untaken_ring(model: Any, mesh: Mesh, device: torch.device
                         ) -> None:
    """On the card a ring whose chunk shape the flash kernels tile runs
    through them (``ops.flash_attention.supports_flash``), and they take
    bf16 only: another compute dtype is refused here, before anything is
    allocated, rather than at the first launch (the kernels' limits,
    stated once)."""
    cfg = model.config
    if device.type != "cuda" or getattr(cfg, "attn_impl", None) != "ring" \
            or SEQ_AXIS not in mesh.axis_names:
        return
    ring = mesh.shape[SEQ_AXIS]
    t = model.input_spec["seq_len"]
    d = cfg.n_embd // cfg.n_head
    if t % ring == 0 and supports_flash(t // ring, d) and \
            cfg.dtype != torch.bfloat16:
        raise ValueError(
            f"parallelism='sequence': the ring's [{t // ring}, {d}] chunks "
            f"go through the flash kernels, which take bfloat16, not "
            f"{cfg.dtype}")


__all__ = ["DistributedTrainer", "TrainingState"]
