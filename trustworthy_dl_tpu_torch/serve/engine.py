"""Request lifecycle for the serving engine: queue -> prefill -> decode ->
stream, with deadlines, backpressure, serving metrics and trust-aware
output monitoring.

Counterpart of ``trustworthy_dl_tpu/serve/engine.py``, over the paged pool
(default) or, with ``paged=False``, the legacy stripe pool.  ``step()``
expires queued requests past their deadline, admits queued requests into
free rows (a stripe admission prefills and emits the first token at
once), runs one scheduler tick (prefill chunks + the fused decode step),
streams the new tokens and retires finished requests.

The int8 tiers and speculative decoding (``kv_dtype``, ``weight_dtype``,
``spec_k``) follow the JAX engine: the decode view is built once and
shared by the parity probe, the scheduler and the int8 self-draft; an int8
pool is parity-probed at construction and, when the probe fails, the
engine serves on the model-dtype pool shrunk to the int8 byte budget and
records ``kv_fallback_reason``.

The adapter tier (``adapter_rank`` > 0) serves per-tenant low-rank deltas
from a paged pool on the engine's device (``serve/adapters.py``): a
request names its adapter, or its tenant resolves through ``adapter_map``;
the scheduler claims the adapter's page at admission.

At retirement the request's mean (entropy, margin) vector is z-scored
against a rolling baseline of past clean requests (``detect.baseline``,
score first, absorb only if clean).  A flagged request is marked and the
row it ran on is QUARANTINED, with its private blocks, until an operator
releases it.

Telemetry, as in JAX (``obs/``), all host-side and none of it touching
the device programs, so streams are bit-identical with or without it.
It comes from ``obs``, an ``ObsSession``: ``tddl_serve_*`` counters,
gauges and histograms on its registry (the process-wide one without a
session); through its trace the request lifecycle events
(``serve_submit``, ``serve_admit``, ``serve_retire``,
``serve_quarantine``, ``attribution``); with its spans a
``serve.request`` span per request with its queued, prefill, decode and
monitor children; with its ledger one attribution record per terminal
request, checkable against the block allocator's journal
(:meth:`ServingEngine.verify_attribution`); with its watchers the
TTFT/ITL/occupancy SLO rules and the ITL anomaly detector, whose breach
sheds the lowest-priority queued request (status ``shed_slo``) while the
queue is longer than the free rows; with its HBM monitor the headroom
gate, which shrinks the paged KV pool and then the adapter pool to what
the device's free memory allows before either is allocated; with its
compile watcher the decode, draft and verify dispatches run under their
guards.  On the card the engine loads every kernel library its
configuration can launch when it is built (:func:`engine_libraries`), so
no load in the hot loop is a first one and a clean run shows no storm.
:meth:`ServingEngine.analyze_programs` notes the decode step's and a
prefill chunk's product counts in a cost ledger.

Chaos (``chaos``, a ``chaos.FaultInjector``): at every retirement the
injector may overwrite the request's trust signals before the monitor
scores them (SERVE_POISON, gated on ``replica_id``), the drill for the
monitor -> quarantine path.  ``cancel`` ends a queued or in-flight request
at once (its slot and blocks freed, or impounded under ``quarantine``);
``export_request`` and ``adopt_request`` are the two halves of a live
migration between engines (``serve/migrate.py``); ``queued_ids``,
``inflight_ids``, ``decode_ready_ids``, ``load`` and
``in_service_capacity`` are what a router reads.

Fleet integration (``serve/fleet.py``): ``retire_hook(result,
placement)`` fires synchronously at every terminal state, ``placement``
being the scheduler's attribution snapshot of an admitted request (None
for one that never held a row), so the fleet sees a failure the moment
it happens.  With a ``replica_id`` every ``tddl_serve_*`` series carries
a ``replica=`` label, as in JAX, so N replicas on one registry are read
apart.  A request's ``first_submit_id`` anchors the shed tie-break at its
first submission (a fail-over keeps its age), ``span_parent`` re-parents
its ``serve.request`` span under the fleet's attempt span, and
``publish_prefix=False`` keeps its prompt blocks out of the prefix cache
(a fleet's vote replay).

The engine runs on the card: ``device`` defaults to ``"cuda"`` and a
machine without CUDA raises unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.

Tensor parallelism (``tp_size`` > 1, JAX's): the engine holds a TP mesh
over the ``model`` axis (``tp_mesh``) and its params carry the model's
registry TP layout (``tp_specs``, ``core.sharding.place_serve_tp``, the
spec tree training TP resolves).  JAX's GSPMD computes the replicated
program's values; the port serves the replicated program, so a TP engine's
streams and kernel launches are a one-position engine's.  By default the
group's positions are the engine's device (``tp_devices`` names them
otherwise, all on that device).  The HBM headroom gate budgets KV bytes
per device: it divides the per-token bytes by the number of distinct
devices among the positions (:func:`per_device_kv_bytes`), JAX's
``bytes // tp`` where positions are cards, the whole pool where they
share one.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from trustworthy_dl_tpu_torch import ops
from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.models import generate as gen
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.obs import attribution
from trustworthy_dl_tpu_torch.obs.events import EventType
from trustworthy_dl_tpu_torch.obs.registry import get_registry
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.quant import int8 as q8
from trustworthy_dl_tpu_torch.serve.adapters import (AdapterPool,
                                                     adapter_bytes_per_page,
                                                     adapter_pool_bytes)
from trustworthy_dl_tpu_torch.serve.kv_slots import kv_bytes_per_token
from trustworthy_dl_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler, PagedBatchingScheduler, SlotTask)
from trustworthy_dl_tpu_torch.utils.metrics import MetricsCollector, \
    ServeMetrics

logger = logging.getLogger(__name__)

#: The serving programs of the ``tddl_serve_attn_kernel`` gauge (JAX's
#: ``ops.paged_attention.PAGED_PROGRAMS``); each runs ``attn_impl``.
PAGED_PROGRAMS = ("decode", "prefill", "verify", "adapter")


def engine_libraries(attn_impl: str, weight_dtype: str, spec_k: int,
                     adapter_rank: int) -> List[str]:
    """The kernel libraries an engine of this configuration can launch on
    the card: the paged-attention library (B5-B8) and, with adapters,
    B9's on the kernel path; B4's with int8 weights or a speculative
    draft, whatever ``attn_impl``."""
    names = []
    if attn_impl == "kernel":
        names.append("paged_attention")
        if adapter_rank > 0:
            names.append("adapter_delta")
    if weight_dtype == "int8" or spec_k > 0:
        names.append("fused_dequant_matmul")
    return names


def per_device_kv_bytes(bytes_per_token: int, tp_mesh: Any) -> int:
    """KV bytes a token costs each device of a TP group: the pool's heads
    shard over the group's distinct devices (``tp_mesh`` None: one
    device).  Positions that share a device hold its whole pool, so the
    headroom gate never admits more than that device holds."""
    ways = 1 if tp_mesh is None else shreg.distinct_devices(tp_mesh)
    return max(bytes_per_token // ways, 1)


class _NullMetric:
    """No-op stand-in when a registry rejects a (re-)registration under
    another label shape: the engine's own rollups stay exact, only its
    export series is dropped."""

    def inc(self, *a: Any, **kw: Any) -> None:
        pass

    def set(self, *a: Any, **kw: Any) -> None:
        pass

    def observe(self, *a: Any, **kw: Any) -> None:
        pass

    def value(self, *a: Any, **kw: Any) -> None:
        return None


class _BoundMetric:
    """A registry metric with the engine's fixed labels (``replica=`` in a
    fleet) bound on, so call sites and the adapter pool's handles call it
    unlabelled."""

    def __init__(self, metric: Any, labels: Dict[str, str]):
        self._metric = metric
        self._labels = labels

    def set(self, *a: Any, **kw: Any) -> None:
        self._metric.set(*a, **kw, **self._labels)

    def inc(self, *a: Any, **kw: Any) -> None:
        self._metric.inc(*a, **kw, **self._labels)

    def observe(self, *a: Any, **kw: Any) -> None:
        self._metric.observe(*a, **kw, **self._labels)


def resolve_device(device: Any) -> torch.device:
    """``device`` as a torch.device; a CUDA device on a machine without
    CUDA raises instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine: the port's entry "
            "points run on the card by default; pass device='cpu' to run the "
            "plain PyTorch versions of its kernels on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@dataclasses.dataclass
class ServeRequest:
    """One generation request.  ``temperature <= 0`` decodes greedily;
    ``seed`` is the request's sampling seed (default: derived from the
    engine seed and the request id): emission i is drawn with a generator
    seeded from (seed, i); ``deadline_s`` is a wall-clock budget from
    submission; ``on_token(request_id, token)`` streams.  ``tenant`` is
    the request's tenant; ``adapter`` names its adapter (None: the
    engine's ``adapter_map`` entry for the tenant, else the base
    model).  ``priority`` orders load shedding under an SLO breach: the
    lowest-priority queued request is shed first (ties: newest first, by
    ``first_submit_id`` where set: a fleet's resubmission carries its
    first submission's id, so a retry keeps its age).  ``span_parent``
    re-parents the request's ``serve.request`` span (the fleet's attempt
    span); ``publish_prefix=False`` keeps its prompt blocks out of the
    prefix cache (a fleet's vote replay, an audit)."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    seed: Optional[int] = None
    on_token: Optional[Callable[[int, int], None]] = None
    tenant: Optional[str] = None
    adapter: Optional[str] = None
    priority: int = 0
    first_submit_id: Optional[int] = None
    span_parent: Optional[int] = None
    publish_prefix: bool = True


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: List[int]
    # completed | deadline_exceeded | shed_slo | no_capacity
    status: str
    ttft_s: Optional[float]
    itl_s: List[float]
    flagged: bool = False
    monitor_z: float = 0.0
    entropies: List[float] = dataclasses.field(default_factory=list)
    margins: List[float] = dataclasses.field(default_factory=list)
    adapter: Optional[str] = None    # the resolved adapter id


class OutputMonitor:
    """Rolling per-request output-anomaly baseline over the signal vector
    [mean logit entropy, mean top-1 margin]: a collapsed or looping
    generation lowers entropy and raises the margin, garbage logits do the
    reverse.  Absorbs only requests it did not flag."""

    NUM_SIGNALS = 2

    def __init__(self, window: int = 256, warmup: int = 16,
                 z_threshold: float = 4.0):
        self.warmup = warmup
        self.z_threshold = z_threshold
        # Host tensors: the signals arrive as Python floats per request.
        self._state = bl.init_baseline_state(1, window, self.NUM_SIGNALS,
                                             device="cpu")

    def observe(self, entropies: Sequence[float],
                margins: Sequence[float]) -> tuple:
        """Score one finished request; absorb it iff clean.  Returns
        (flagged, max_z)."""
        vec = torch.tensor([[float(np.mean(entropies)),
                             float(np.mean(margins))]], dtype=torch.float32)
        mean, std, valid = bl.baseline_moments(self._state)
        z = float(bl.zscores(vec, mean, std).max())
        flagged = int(valid[0]) >= self.warmup and z > self.z_threshold
        if not flagged:
            self._state = bl.push_stats(self._state, vec)
        return flagged, z

    @property
    def count(self) -> int:
        return int(self._state.count[0])


def _age_id(task: SlotTask, request: ServeRequest) -> int:
    """A queued request's age for the shed tie-break: its first
    submission's id when it is a resubmission, else its own."""
    if request.first_submit_id is not None:
        return int(request.first_submit_id)
    return int(task.request_id)


class ServingEngine:
    """Continuous-batching serving over the paged block pool, or over the
    stripe pool with ``paged=False`` (``buckets``: its prefill widths;
    ``attn_impl`` "kernel" or "plain" picks where its trust signals come
    from, B7 or its twin).

    ``queue_limit`` bounds the admission queue: ``submit`` returns None
    (shed) when it is full.  Finished results accumulate in ``results``
    until ``drain_results()`` takes them.  ``kv_dtype``, ``weight_dtype``,
    ``kv_parity_check``, ``spec_k``, ``adapter_rank``,
    ``adapter_pool_pages`` and ``adapter_dtype`` are ``ServeConfig``'s
    knobs; ``adapter_map`` routes tenant -> adapter id.  ``obs`` is an
    ``ObsSession``: the engine uses what it has enabled (its trace and
    registry always; spans, ledger, watchers and HBM monitor when on).
    ``chaos`` is a ``chaos.FaultInjector``; ``replica_id`` names the
    engine for replica-addressed chaos, tags its trace events and labels
    its ``tddl_serve_*`` series; ``retire_hook(result, placement)`` fires
    at every terminal state (the fleet's seam)."""

    def __init__(self, params: Any, cfg: gpt2.GPT2Config,
                 max_slots: int = 8, max_seq: int = 256,
                 queue_limit: int = 64, seed: int = 0,
                 monitor: Optional[OutputMonitor] = None,
                 enable_monitor: bool = True, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 attn_impl: str = "kernel", device: Any = "cuda",
                 kv_dtype: str = "model", weight_dtype: str = "model",
                 kv_parity_check: bool = True, spec_k: int = 0,
                 adapter_rank: int = 0,
                 adapter_pool_pages: Optional[int] = None,
                 adapter_dtype: str = "model",
                 adapter_map: Optional[Dict[str, str]] = None,
                 obs: Any = None, paged: bool = True,
                 buckets: Optional[Sequence[int]] = None,
                 chaos: Any = None, replica_id: Optional[int] = None,
                 retire_hook: Optional[Callable[..., None]] = None,
                 tp_size: int = 1,
                 tp_devices: Optional[Sequence[Any]] = None):
        # core.config imports serve (its pool geometry check): late import.
        from trustworthy_dl_tpu_torch.core.config import (validate_adapters,
                                                          validate_spec)

        self.device = resolve_device(device)
        # Tensor-parallel replica, first as in JAX (before the geometry
        # checks, the HBM gate and the views): a TP mesh over the 'model'
        # axis and the params with the registry's TP layout, the rules
        # training TP resolves.
        self.tp_size = int(tp_size)
        self.tp_mesh: Any = None
        self.tp_specs: Any = None
        if self.tp_size > 1:
            self.tp_mesh = shreg.serve_tp_mesh(self.tp_size, tp_devices,
                                               device=self.device)
            foreign = [d for d in self.tp_mesh.devices.flat
                       if shreg.device_key(d) != shreg.device_key(
                           self.device)]
            if foreign:
                raise ValueError(
                    f"tp_devices {foreign} for an engine on {self.device}: "
                    "the engine serves in one process, so every position "
                    "of its TP group must be its device")
            params, self.tp_specs = shreg.place_serve_tp(params,
                                                         self.tp_mesh)
        q8.validate_dtypes(kv_dtype, weight_dtype)
        validate_spec(spec_k, paged, weight_dtype)
        validate_adapters(adapter_rank, adapter_pool_pages, adapter_dtype,
                          paged, spec_k)
        self.paged = bool(paged)
        if paged and buckets is not None:
            raise ValueError("buckets are the stripe pool's prefill widths "
                             "(paged=False); the paged pool prefills in "
                             "chunks")
        if self.device.type == "cuda" and attn_impl == "kernel" \
                and adapter_rank > 0:
            # B9's limits, checked before any pool or view is allocated:
            # the card has no jnp fallback to move the adapter program to.
            limit = pattn.adapter_kernel_limit(adapter_rank, cfg.n_embd,
                                               cfg.dtype)
            if limit is not None:
                raise ValueError(f"adapter_rank={adapter_rank} is past the "
                                 f"adapter kernel's limits: {limit}")
        if self.device.type == "cuda" and attn_impl == "kernel" and paged:
            # B6's limits, the same over both pools: every prompt chunk
            # goes through it (an int8 pool whose parity probe fails falls
            # back to a model-dtype one), so refuse before any pool is
            # allocated.
            limit = pattn.prefill_kernel_limit(cfg.head_dim, block_size,
                                               cfg.dtype)
            if limit is not None:
                raise ValueError(f"the paged prefill kernel's limits refuse "
                                 f"this model: {limit}")
            # B5's limits, for both pools: every decode tick (up to QROWS
            # rows) goes through it.
            limit = pattn.decode_kernel_limit(cfg.head_dim, pattn.QROWS,
                                              cfg.dtype, block_size)
            if limit is not None:
                raise ValueError(f"the paged decode kernel's limits refuse "
                                 f"this model: {limit}")
        if self.device.type == "cuda":
            # B4's limits: every int8 block matrix (the int8 weight tier
            # and the int8 self-draft) goes through it whatever attn_impl.
            limit = q8.dequant_engine_limit(cfg, weight_dtype, spec_k)
            if limit is not None:
                raise ValueError(f"the int8 dequant matmul's limits refuse "
                                 f"this model: {limit}")
        if self.device.type == "cuda":
            # Every library this configuration can launch, loaded now:
            # B9's would first load on the first tick with an adapter row
            # and B4's on the first int8-weight tick, inside a guarded
            # dispatch after warmup, a storm the compile watcher would
            # report.
            for name in engine_libraries(attn_impl, weight_dtype, spec_k,
                                         adapter_rank):
                ops.kernel_library(name)
        trace, registry, spans, ledger, slo, anomaly, hbm = (
            (obs.trace, obs.registry, obs.spans, obs.ledger, obs.slo,
             obs.anomaly, obs.hbm) if obs is not None else (None,) * 7)
        self.cfg = cfg
        self.spec_k = int(spec_k)
        self.kv_fallback_reason: Optional[str] = None
        # HBM headroom gate (obs/hbm.py): consult the monitor BEFORE the
        # KV pool is allocated and shrink it to what the live budget has
        # room for (floor: one full sequence), instead of finding the
        # out-of-memory error at allocation.  The denial is attributable:
        # an ``hbm_pressure`` event and ``tddl_hbm_pressure_total``.
        self.hbm = hbm
        if hbm is not None:
            bpt = per_device_kv_bytes(
                kv_bytes_per_token(cfg, torch.int8) if kv_dtype == "int8"
                else kv_bytes_per_token(cfg), self.tp_mesh)
        if hbm is not None and not paged:
            # The stripe pool shrinks by slots (floor: one).
            requested = max_slots * max_seq * bpt
            if not hbm.admit(requested, what="serve_stripe_pool"):
                headroom = max(hbm.last_headroom or 0, 0)
                allowed = max(int(headroom // (max_seq * bpt)), 1)
                logger.warning(
                    "HBM headroom gate: stripe pool shrunk %d -> %d slots "
                    "(requested %d bytes, headroom %d)", max_slots,
                    allowed, requested, headroom)
                max_slots = allowed
        elif hbm is not None:
            if num_blocks is None:
                num_blocks = max_slots * (max_seq // block_size)
            requested = num_blocks * block_size * bpt
            if not hbm.admit(requested, what="serve_paged_pool"):
                # Size the shrunk pool from the SAME sweep that made the
                # decision (admit() stored it).
                headroom = max(hbm.last_headroom or 0, 0)
                allowed = max(int(headroom // (block_size * bpt)),
                              max_seq // block_size)
                logger.warning(
                    "HBM headroom gate: paged pool shrunk %d -> %d blocks "
                    "(requested %d bytes, headroom %d)", num_blocks,
                    allowed, requested, headroom)
                num_blocks = allowed
        params = gpt2.map_tree(lambda a: a.to(self.device), params)
        # The decode view, built once and shared by the parity probe, the
        # scheduler and the int8 self-draft (one walk of the weights each).
        base_view = gen._decode_view(params, cfg)
        view = (q8.quantize_decode_view(params, cfg, view=base_view)
                if weight_dtype == "int8" else base_view)
        draft_view = (q8.draft_decode_view(params, cfg, dense_view=base_view)
                      if self.spec_k > 0 else None)
        if kv_dtype == "int8" and kv_parity_check:
            if not q8.kv_parity_probe(view, cfg):
                self.kv_fallback_reason = "kv_parity_probe_failed"
                kv_dtype = "model"
                # Keep the HBM budget the int8 pool planned for: the
                # model-dtype pool shrinks to what those bytes buy (slots
                # on the stripe pool, blocks on the paged one).
                int8_bpt = kv_bytes_per_token(cfg, torch.int8)
                model_bpt = kv_bytes_per_token(cfg)
                if not paged:
                    fallback = max(1, max_slots * int8_bpt // model_bpt)
                    logger.warning(
                        "int8 KV parity probe failed: falling back to the "
                        "model-dtype KV pool, shrinking %d -> %d slots to "
                        "stay inside the int8 pool's byte budget",
                        max_slots, fallback)
                    max_slots = fallback
                else:
                    if num_blocks is None:
                        num_blocks = max_slots * (max_seq // block_size)
                    fallback = max(max_seq // block_size,
                                   num_blocks * int8_bpt // model_bpt)
                    logger.warning(
                        "int8 KV parity probe failed: falling back to the "
                        "model-dtype paged pool, shrinking %d -> %d blocks "
                        "to stay inside the int8 pool's byte budget",
                        num_blocks, fallback)
                    num_blocks = fallback
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        self.adapter_rank = int(adapter_rank)
        self.adapter_dtype = adapter_dtype
        self.adapter_map: Dict[str, str] = dict(adapter_map or {})
        self.adapter_pool: Optional[AdapterPool] = None
        if self.adapter_rank > 0:
            pages = (adapter_pool_pages if adapter_pool_pages is not None
                     else max_slots)
            if hbm is not None:
                # The second paged resource, through the same gate and
                # after the KV pool: it shrinks into what remains (floor:
                # one usable page).
                bpp = adapter_bytes_per_page(cfg, self.adapter_rank,
                                             adapter_dtype)
                requested = adapter_pool_bytes(cfg, pages, self.adapter_rank,
                                               adapter_dtype)
                if not hbm.admit(requested, what="serve_adapter_pool"):
                    # Headroom over bytes per page, less the zero page.
                    headroom = max(hbm.last_headroom or 0, 0)
                    allowed = max(int(headroom // bpp) - 1, 1)
                    logger.warning(
                        "HBM headroom gate: adapter pool shrunk %d -> %d "
                        "pages (requested %d bytes, headroom %d)", pages,
                        allowed, requested, headroom)
                    pages = allowed
            self.adapter_pool = AdapterPool(cfg, self.adapter_rank, pages,
                                            adapter_dtype=adapter_dtype,
                                            device=self.device, trace=trace)
        if paged:
            self.scheduler: Any = PagedBatchingScheduler(
                params, cfg, max_slots, max_seq, self.device,
                block_size=block_size, num_blocks=num_blocks,
                prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
                attn_impl=attn_impl, view=view, kv_dtype=kv_dtype,
                weight_dtype=weight_dtype, spec_k=self.spec_k,
                draft_view=draft_view, adapters=self.adapter_pool)
        else:
            self.scheduler = ContinuousBatchingScheduler(
                params, cfg, max_slots, max_seq, self.device,
                buckets=buckets, kv_dtype=kv_dtype,
                weight_dtype=weight_dtype, view=view, attn_impl=attn_impl)
        self.chaos = chaos
        self.replica_id = replica_id
        self.retire_hook = retire_hook
        # Every trace event carries the replica in a fleet: request ids
        # are replica-local.
        self._trace_tags = ({"replica": replica_id}
                            if replica_id is not None else {})
        # ... and every tddl_serve_* series its label: N replicas share a
        # registry.
        self._rlabels = ({"replica": str(replica_id)}
                         if replica_id is not None else {})
        self.queue_limit = queue_limit
        self.seed = int(seed)
        self.monitor = monitor if monitor is not None else (
            OutputMonitor() if enable_monitor else None)
        self.metrics = ServeMetrics()
        self._init_telemetry(registry, trace, params, view)
        self.spans = spans
        self.ledger = ledger
        self.slo = slo
        self.anomaly = anomaly
        self.scheduler.spans = spans
        self.compilewatch = obs.compilewatch if obs is not None else None
        self.scheduler.compilewatch = self.compilewatch
        self._req_spans: Dict[int, Dict[str, int]] = {}  # rid -> open ids
        self.shed_slo = 0
        self._queue: Deque[tuple] = deque()     # (task, request)
        self._inflight: Dict[int, tuple] = {}   # request_id -> (task, req)
        self._timing: Dict[int, List[float]] = {}
        self._submit_t: Dict[int, float] = {}
        self.results: Dict[int, ServeResult] = {}
        self._status_counts: Dict[str, int] = {}
        self._flagged_total = 0
        self.rejected = 0
        self._next_id = 0
        self._iteration = 0
        self._tokens_emitted = 0
        self._t_start: Optional[float] = None
        self.decode_tick_s = 0.0
        self.peak_active = 0
        self.peak_tokens_in_flight = 0

    def _init_telemetry(self, registry: Any, trace: Any, params: Any,
                        view: Any) -> None:
        """The ``tddl_serve_*`` registry surface, as in JAX: counters and
        latency histograms, the pool's capacity gauges, the per-iteration
        gauges of a ``serve`` collector."""
        self.trace = trace
        if registry is None:
            registry = get_registry()
        self.collector = MetricsCollector(namespace="serve",
                                          registry=registry,
                                          labels=self._rlabels or None)
        rlabels = self._rlabels

        def metric(register, name, help, labels=(), **kw):
            labels = tuple(labels) + tuple(rlabels)
            try:
                m = register(name, help, labels=labels, **kw)
            except ValueError:
                logger.debug("serve metrics: registry rejected %s%s",
                             name, labels, exc_info=True)
                return _NullMetric()
            return _BoundMetric(m, rlabels) if rlabels else m

        self._req_counter = metric(
            registry.counter, "tddl_serve_requests_total",
            "Requests retired/shed, by terminal status",
            labels=("status",))
        self._tok_counter = metric(registry.counter,
                                   "tddl_serve_tokens_total",
                                   "Tokens emitted")
        self._ttft_hist = metric(registry.histogram,
                                 "tddl_serve_ttft_seconds",
                                 "Submit -> first token")
        self._itl_hist = metric(registry.histogram,
                                "tddl_serve_itl_seconds",
                                "Inter-token latency")
        kv = self.scheduler.kv
        metric(registry.gauge, "tddl_serve_kv_bytes",
               "KV slot-pool HBM footprint (values + quant scales)"
               ).set(float(kv.pool_bytes))
        metric(registry.gauge, "tddl_serve_slots_total",
               "KV slots in the pool, by storage dtype", labels=("dtype",)
               ).set(float(self.scheduler.allocator.max_slots),
                     dtype=str(kv.k.dtype).replace("torch.", ""))
        quant_err = metric(
            registry.histogram, "tddl_serve_quant_error",
            "Relative quantization error (weight roundtrip, per matrix)",
            buckets=(1e-5, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 1.0))
        if self.weight_dtype == "int8":
            for err in q8.weight_roundtrip_errors(params, self.cfg,
                                                  qview=view):
                quant_err.observe(err)
        self._blocks_gauge = metric(
            registry.gauge, "tddl_serve_blocks_in_use",
            "Paged-KV blocks currently referenced (requests + prefix "
            "cache); 0 on the legacy stripe pool")
        self._tif_gauge = metric(
            registry.gauge, "tddl_serve_tokens_in_flight",
            "Cached tokens currently backing live sequences")
        self._prefix_counter = metric(
            registry.counter, "tddl_serve_prefix_hits_total",
            "Admissions that reused cached prefix blocks")
        self._prefix_hits_seen = 0
        pages_gauge = metric(
            registry.gauge, "tddl_serve_adapter_pages_in_use",
            "Adapter-pool pages resident (live + warm + impounded); 0 "
            "when the adapter tier is off")
        pages_gauge.set(0.0)
        evictions = metric(
            registry.counter, "tddl_serve_adapter_evictions_total",
            "Cold adapters LRU-evicted from the pool, by evicted tenant",
            labels=("tenant",))
        if self.adapter_pool is not None:
            self.adapter_pool.pages_gauge = pages_gauge
            self.adapter_pool.evictions_counter = evictions
        attn_gauge = metric(
            registry.gauge, "tddl_serve_attn_kernel",
            "Active serving-kernel path per paged program (1 = in use): "
            "the hand-written kernel or its plain PyTorch version",
            labels=("path", "program"))
        paths = self.attn_kernel_paths
        for program in PAGED_PROGRAMS:
            for path in gen.ATTN_IMPLS:
                attn_gauge.set(1.0 if path == paths[program] else 0.0,
                               path=path, program=program)
        self._spec_proposed_counter = metric(
            registry.counter, "tddl_serve_spec_proposed_total",
            "Draft tokens proposed by the speculative int8 self-draft")
        self._spec_accepted_counter = metric(
            registry.counter, "tddl_serve_spec_accepted_total",
            "Draft tokens accepted by the batched model-dtype verify")
        self._spec_seen = (0, 0)   # (proposed, accepted) already counted

    @classmethod
    def from_config(cls, params: Any, cfg: gpt2.GPT2Config,
                    serve_config: Any, **kwargs: Any) -> "ServingEngine":
        """Build from a ``core.config.ServeConfig``; ``kwargs`` pass
        through (seed, monitor, device, ...)."""
        return cls(params, cfg, max_slots=serve_config.max_slots,
                   max_seq=serve_config.max_seq,
                   queue_limit=serve_config.queue_limit,
                   paged=serve_config.paged,
                   block_size=serve_config.block_size,
                   num_blocks=serve_config.num_blocks,
                   prefix_cache=serve_config.prefix_cache,
                   prefill_chunk=serve_config.prefill_chunk,
                   attn_impl=serve_config.attn_impl,
                   kv_dtype=serve_config.kv_dtype,
                   weight_dtype=serve_config.weight_dtype,
                   kv_parity_check=serve_config.kv_parity_check,
                   spec_k=serve_config.spec_k,
                   adapter_rank=serve_config.adapter_rank,
                   adapter_pool_pages=serve_config.adapter_pool_pages,
                   adapter_dtype=serve_config.adapter_dtype,
                   tp_size=serve_config.tp_size, **kwargs)

    # -- submission --------------------------------------------------------

    def submit(self, request: ServeRequest) -> Optional[int]:
        """Enqueue a request; returns its id, or None when shed by
        backpressure.  Raises for requests that can never be served."""
        prompt = np.asarray(list(request.prompt), np.int32)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if request.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + request.max_new_tokens
        if total > self.scheduler.max_seq:
            raise ValueError(f"prompt+new = {total} exceeds max_seq="
                             f"{self.scheduler.max_seq}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            raise ValueError("prompt token ids must be in "
                             f"[0, {self.cfg.vocab_size})")
        if not self.paged and prompt.size > max(self.scheduler.buckets):
            # Refused here, not mid-flight at admission.
            raise ValueError(f"prompt of {prompt.size} tokens exceeds the "
                             f"largest prefill bucket "
                             f"{max(self.scheduler.buckets)}")
        # An explicit adapter wins, else the tenant's entry.  Loud when the
        # tier is off: serving the base model under the tenant's name
        # would misattribute the stream.
        adapter = request.adapter
        if adapter is None and request.tenant is not None:
            adapter = self.adapter_map.get(request.tenant)
        if adapter is not None and self.adapter_pool is None:
            raise ValueError(
                f"request names adapter {adapter!r} but the adapter tier "
                "is off (adapter_rank=0); serving it on the base model "
                "would silently misattribute the stream")
        if len(self._queue) >= self.queue_limit:
            self.rejected += 1
            self._req_counter.inc(status="rejected")
            return None
        request_id = self._next_id
        self._next_id += 1
        seed = (request.seed if request.seed is not None
                else self.seed * 1_000_003 + request_id)
        task = SlotTask(request_id=request_id, prompt=prompt,
                        max_new_tokens=int(request.max_new_tokens),
                        temperature=float(request.temperature),
                        seed=int(seed), eos_id=request.eos_id,
                        adapter=adapter,
                        publish_prefix=bool(request.publish_prefix))
        self._queue.append((task, request))
        self._submit_t[request_id] = time.perf_counter()
        if self.trace is not None:
            self.trace.emit(EventType.SERVE_SUBMIT, request_id=request_id,
                            prompt_len=int(prompt.size),
                            max_new_tokens=int(request.max_new_tokens),
                            **self._trace_tags)
        if self.spans is not None:
            root = self.spans.start("serve.request", kind="serve",
                                    parent_id=request.span_parent,
                                    request_id=request_id,
                                    replica=self.replica_id,
                                    tenant=request.tenant,
                                    prompt_len=int(prompt.size),
                                    max_new_tokens=int(
                                        request.max_new_tokens))
            queued = self.spans.start("serve.queued", kind="serve",
                                      parent_id=root,
                                      request_id=request_id)
            self._req_spans[request_id] = {"root": root, "queued": queued}
        return request_id

    # -- terminal bookkeeping ----------------------------------------------

    def _close_request_spans(self, rid: int, status: str,
                             **attrs: Any) -> None:
        handles = self._req_spans.pop(rid, None)
        if handles is None or self.spans is None:
            return
        for name in ("queued", "prefill", "decode", "monitor"):
            sid = handles.get(name)
            if sid is not None:
                self.spans.end(sid)
        self.spans.end(handles["root"], status=status, **attrs)

    def _span_first_token(self, rid: int) -> None:
        """prefill -> decode span transition at the request's first
        token."""
        handles = self._req_spans.get(rid)
        if handles is None or self.spans is None:
            return
        sid = handles.pop("prefill", None)
        if sid is not None:
            self.spans.end(sid)
        handles["decode"] = self.spans.start(
            "serve.decode", kind="serve", parent_id=handles["root"],
            request_id=rid)

    def _retire_unadmitted(self, task: SlotTask, request: ServeRequest,
                           status: str) -> None:
        """A request that ends without ever holding a row: its result,
        ``serve_retire`` event, spans and ledger record."""
        rid = task.request_id
        self._submit_t.pop(rid, None)
        self._record_result(ServeResult(
            request_id=rid, tokens=[], status=status, ttft_s=None,
            itl_s=[]))
        if self.trace is not None:
            self.trace.emit(EventType.SERVE_RETIRE, request_id=rid,
                            status=status, tokens=0, admitted=False,
                            **self._trace_tags)
        self._close_request_spans(rid, status)
        if self.ledger is not None:
            self.ledger.append({
                "request_id": rid, "status": status, "admitted": False,
                "slot": -1, "layout": "paged" if self.paged else "stripe",
                "block_ids": [], "prefix_block_ids": [],
                "prefix_publishers": {},
                "kv_dtype": self.kv_dtype, "weight_dtype": self.weight_dtype,
                "kv_fallback_reason": self.kv_fallback_reason,
                "flagged": False, "monitor_z": 0.0,
                "tokens": 0, "token_hash": attribution.token_hash([]),
                "tenant": request.tenant,
            })

    def _shed_for_slo(self) -> None:
        """The watchers' shed hook: while an SLO rule burns budget (or an
        anomaly is active), drop the LOWEST-priority queued request
        (ties: newest first), but only when the queue exceeds the free
        rows, so shedding relieves real pressure.  At most one a step."""
        breached = ((self.slo is not None and self.slo.breached)
                    or (self.anomaly is not None
                        and self.anomaly.any_active))
        if not breached or not self._queue:
            return
        if len(self._queue) <= self.scheduler.allocator.free_count:
            return
        idx = min(range(len(self._queue)),
                  key=lambda i: (self._queue[i][1].priority,
                                 -_age_id(*self._queue[i])))
        task, request = self._queue[idx]
        del self._queue[idx]
        self.shed_slo += 1
        self._retire_unadmitted(task, request, "shed_slo")

    # -- iteration loop ----------------------------------------------------

    @torch.no_grad()
    def step(self) -> int:
        """One iteration: expire -> admit -> tick -> stream -> retire.
        Returns the number of tokens emitted."""
        now = time.perf_counter()
        if self._t_start is None:
            self._t_start = now
        self._iteration += 1
        self._expire_queued(now)
        self._shed_for_slo()
        emitted = 0
        while self._queue and self.scheduler.has_free_slot:
            task, request = self._queue.popleft()
            if not self.scheduler.admit(task):
                self._queue.appendleft((task, request))
                break
            rid = task.request_id
            self._inflight[rid] = (task, request)
            if self.trace is not None:
                self.trace.emit(EventType.SERVE_ADMIT, request_id=rid,
                                slot=int(task.slot), **self._trace_tags)
            handles = self._req_spans.get(rid)
            if handles is not None:
                sid = handles.pop("queued", None)
                if sid is not None:
                    self.spans.end(sid, slot=int(task.slot))
                handles["prefill"] = self.spans.start(
                    "serve.prefill", kind="serve",
                    parent_id=handles["root"], request_id=rid,
                    slot=int(task.slot))
            if task.emitted:
                # A stripe admission prefilled: its first token is out.
                emitted += self._stream_new(task, request)
                if task.done:
                    self._finish(task, request, "completed")
        t_tick = time.perf_counter()
        ticked = self.scheduler.decode_tick()
        self.decode_tick_s += time.perf_counter() - t_tick
        if self.spans is not None and ticked:
            self.spans.add("serve.decode_tick", t_tick,
                           time.perf_counter(), kind="serve",
                           tokens=len(ticked),
                           active=self.scheduler.active_count)
        for task in ticked:
            rid = task.request_id
            if rid not in self._inflight:
                continue
            _, request = self._inflight[rid]
            emitted += self._stream_new(task, request)
            if task.done:
                self._finish(task, request, "completed")
            elif self._expired(request, rid):
                self._finish(task, request, "deadline_exceeded")
        # A slot still feeding prompt chunks emits nothing, so the loop
        # above never sees it: check its deadline here.
        for rid, (task, request) in list(self._inflight.items()):
            if not task.emitted and self._expired(request, rid):
                self._finish(task, request, "deadline_exceeded")
        self._tokens_emitted += emitted
        if emitted:
            self._tok_counter.inc(emitted)
        sched = self.scheduler
        tif = sched.tokens_in_flight
        self.peak_active = max(self.peak_active, sched.active_count)
        self.peak_tokens_in_flight = max(self.peak_tokens_in_flight, tif)
        self.metrics.observe_step(sched.occupancy)
        self._tif_gauge.set(float(tif))
        if self.slo is not None:
            self.slo.observe("occupancy", sched.occupancy)
        if self.paged:
            self._blocks_gauge.set(float(sched.blocks_in_use))
            if sched.prefix_hits > self._prefix_hits_seen:
                self._prefix_counter.inc(sched.prefix_hits
                                         - self._prefix_hits_seen)
                self._prefix_hits_seen = sched.prefix_hits
        if self.spec_k:
            seen_p, seen_a = self._spec_seen
            if sched.spec_proposed > seen_p:
                self._spec_proposed_counter.inc(sched.spec_proposed - seen_p)
            if sched.spec_accepted > seen_a:
                self._spec_accepted_counter.inc(sched.spec_accepted - seen_a)
            self._spec_seen = (sched.spec_proposed, sched.spec_accepted)
        self.collector.collect_batch_metrics({
            "step": self._iteration,
            "active_slots": sched.active_count,
            "slot_occupancy": sched.occupancy,
            "queue_depth": len(self._queue),
            "tokens_emitted": emitted,
            "tokens_in_flight": tif,
            "slots_in_service": sched.allocator.capacity,
        })
        self.collector.tick()
        return emitted

    def run_until_idle(self, max_iterations: int = 100_000
                       ) -> Dict[int, ServeResult]:
        """Drive ``step()`` until queue and rows drain.  When nothing was
        in flight and a step admitted nothing (every row or block
        quarantined), the queue can never drain: shed it as
        ``no_capacity`` instead of spinning."""
        it = 0
        while self._queue or self._inflight:
            idle_before = not self._inflight
            qlen = len(self._queue)
            self.step()
            it += 1
            if (idle_before and not self._inflight and self._queue
                    and len(self._queue) == qlen):
                while self._queue:
                    task, request = self._queue.popleft()
                    self._retire_unadmitted(task, request, "no_capacity")
                break
            if it >= max_iterations:
                raise RuntimeError(f"serving loop did not drain in "
                                   f"{max_iterations} iterations")
        return self.results

    # -- internals ---------------------------------------------------------

    def _stream_new(self, task: SlotTask, request: ServeRequest) -> int:
        """Time and stream the tokens the task gained since the last call
        (those past the ones already timed; a speculative tick can add
        several at once, whose ITLs are honest near-zeros).  Returns how
        many."""
        rid = task.request_id
        times = self._timing.setdefault(rid, [])
        if not times:
            self._span_first_token(rid)
        new_tokens = task.emitted[len(times):]
        for token in new_tokens:
            times.append(time.perf_counter())
            if request.on_token is not None:
                request.on_token(rid, token)
        return len(new_tokens)

    def _expired(self, request: ServeRequest, rid: int) -> bool:
        return (request.deadline_s is not None
                and time.perf_counter() - self._submit_t[rid]
                > request.deadline_s)

    def _expire_queued(self, now: float) -> None:
        keep: Deque[tuple] = deque()
        while self._queue:
            task, request = self._queue.popleft()
            rid = task.request_id
            if (request.deadline_s is not None
                    and now - self._submit_t[rid] > request.deadline_s):
                self._retire_unadmitted(task, request, "deadline_exceeded")
            else:
                keep.append((task, request))
        self._queue = keep

    def _record_result(self, result: ServeResult,
                       placement: Optional[Dict[str, Any]] = None) -> None:
        """Every terminal state's rollup: status counts, ``results``, the
        registry counter and the fleet's ``retire_hook``."""
        self._status_counts[result.status] = \
            self._status_counts.get(result.status, 0) + 1
        if result.flagged:
            self._flagged_total += 1
        self.results[result.request_id] = result
        self._req_counter.inc(status=result.status)
        if self.retire_hook is not None:
            self.retire_hook(result, placement)

    def cancel(self, request_id: int, status: str = "cancelled",
               quarantine: bool = False) -> bool:
        """End a queued or in-flight request now with ``status``, unscored
        by the monitor: a live migration's source half after the
        destination committed, a drained queue, a lost hedge.  Its slot
        and blocks free at once (``quarantine``: impounded instead, the
        source of a migration off a suspect replica); the tokens so far
        ride the result.  False when the id is unknown or already
        terminal."""
        for i, (task, request) in enumerate(self._queue):
            if task.request_id == request_id:
                del self._queue[i]
                self._retire_unadmitted(task, request, status)
                return True
        pair = self._inflight.pop(request_id, None)
        if pair is None:
            return False
        task, request = pair
        placement = (self.scheduler.attribution_info(task)
                     if self.ledger is not None
                     or self.retire_hook is not None else None)
        self.scheduler.retire(task, quarantine=quarantine)
        times = self._timing.pop(request_id, [])
        t0 = self._submit_t.pop(request_id, None)
        ttft = (times[0] - t0) if times and t0 is not None else None
        self._record_result(ServeResult(
            request_id=request_id, tokens=list(task.emitted), status=status,
            ttft_s=ttft, itl_s=[b - a for a, b in zip(times, times[1:])],
            entropies=list(task.entropies), margins=list(task.margins),
            adapter=task.adapter), placement)
        if self.trace is not None:
            self.trace.emit(EventType.SERVE_RETIRE, request_id=request_id,
                            status=status, tokens=len(task.emitted),
                            **self._trace_tags)
            if quarantine:
                self.trace.emit(EventType.SERVE_QUARANTINE,
                                request_id=request_id, slot=int(task.slot),
                                **self._trace_tags)
        if self.ledger is not None:
            self.ledger.append({
                "request_id": request_id, "status": status,
                "admitted": True, **placement,
                "kv_dtype": self.kv_dtype, "weight_dtype": self.weight_dtype,
                "kv_fallback_reason": self.kv_fallback_reason,
                "flagged": False, "monitor_z": 0.0,
                "tokens": len(task.emitted),
                "token_hash": attribution.token_hash(task.emitted),
                "ttft_s": ttft, "tenant": request.tenant,
            })
        self._close_request_spans(request_id, status,
                                  tokens=len(task.emitted))
        return True

    # -- live migration (serve/migrate.py orchestrates) --------------------

    def export_request(self, request_id: int) -> Optional[Dict[str, Any]]:
        """Source half of a live migration: the scheduler's block-table
        snapshot of a decode-phase request (None, nothing touched, for an
        unknown id, mid-prefill, or on the stripe pool) with the timing
        that must travel for TTFT, ITL and deadlines to stay exact.  The
        request keeps decoding here until ``cancel(..., "migrated")``
        releases it after the destination commits."""
        pair = self._inflight.get(request_id)
        if pair is None or not self.paged:
            return None
        task, request = pair
        snap = self.scheduler.export_migration(task)
        if snap is None:
            return None
        snap["request"] = request
        snap["submit_t"] = self._submit_t.get(request_id)
        snap["times"] = list(self._timing.get(request_id, []))
        snap["replica"] = self.replica_id
        return snap

    def adopt_request(self, snapshot: Dict[str, Any],
                      claim: Dict[str, Any], *,
                      on_token: Optional[Callable[[int, int], None]] = None,
                      migrated_from: Optional[Dict[str, Any]] = None
                      ) -> int:
        """Destination half, COMMIT: register the migrated stream under a
        fresh local id on the claimed row (host bookkeeping: the block copy
        has landed, so it cannot fail).  The task carries the source's
        tokens, trust signals and seed (the next draw index is
        ``len(emitted)``); the submit time and token times carry over, so
        deadlines, TTFT and ITL read as one request.  ``on_token`` replaces
        the request's stream callback."""
        src: SlotTask = snapshot["task"]
        rid = self._next_id
        self._next_id += 1
        task = SlotTask(request_id=rid,
                        prompt=np.asarray(src.prompt, np.int32),
                        max_new_tokens=int(src.max_new_tokens),
                        temperature=float(src.temperature), seed=src.seed,
                        eos_id=src.eos_id, adapter=src.adapter,
                        publish_prefix=False)
        task.emitted = list(src.emitted)
        task.next_token = src.next_token
        task.entropies = list(src.entropies)
        task.margins = list(src.margins)
        request = snapshot["request"]
        if on_token is not None:
            request = dataclasses.replace(request, on_token=on_token)
        self.scheduler.commit_migration(task, claim, snapshot["length"],
                                        migrated_from=migrated_from)
        self._inflight[rid] = (task, request)
        t0 = snapshot.get("submit_t")
        self._submit_t[rid] = t0 if t0 is not None else time.perf_counter()
        self._timing[rid] = list(snapshot.get("times", []))
        if self.trace is not None:
            self.trace.emit(EventType.SERVE_ADMIT, request_id=rid,
                            slot=int(task.slot), migrated=True,
                            **self._trace_tags)
        return rid

    def _finish(self, task: SlotTask, request: ServeRequest,
                status: str) -> None:
        """Score the request with the monitor, retire its row (quarantined
        when flagged) and record the result, its telemetry and its
        attribution record.  The chaos injector goes first: a poisoned
        request's signals are rewritten before the monitor reads them."""
        rid = task.request_id
        if self.chaos is not None:
            self.chaos.on_serve_retire(task, replica=self.replica_id)
        # The placement snapshot BEFORE retire() clears the row's table:
        # the record must name the blocks the stream decoded from.
        placement = (self.scheduler.attribution_info(task)
                     if self.ledger is not None
                     or self.retire_hook is not None else None)
        flagged, z = False, 0.0
        t_mon = time.perf_counter()
        if self.monitor is not None and task.entropies:
            flagged, z = self.monitor.observe(task.entropies, task.margins)
            if self.spans is not None and rid in self._req_spans:
                self.spans.add("serve.monitor", t_mon, time.perf_counter(),
                               kind="serve",
                               parent_id=self._req_spans[rid]["root"],
                               request_id=rid, flagged=flagged,
                               monitor_z=float(z))
        self.scheduler.retire(task, quarantine=flagged)
        times = self._timing.pop(rid, [])
        t0 = self._submit_t.pop(rid, None)
        ttft = (times[0] - t0) if times and t0 is not None else None
        itl = [b - a for a, b in zip(times, times[1:])]
        self._record_result(ServeResult(
            request_id=rid, tokens=list(task.emitted), status=status,
            ttft_s=ttft, itl_s=itl, flagged=flagged, monitor_z=z,
            entropies=list(task.entropies), margins=list(task.margins),
            adapter=task.adapter), placement)
        self.metrics.observe_request(ttft, itl)
        if ttft is not None:
            self._ttft_hist.observe(ttft)
            if self.slo is not None:
                self.slo.observe("ttft_s", ttft)
        for dt in itl:
            self._itl_hist.observe(dt)
            if self.slo is not None:
                self.slo.observe("itl_s", dt)
            if self.anomaly is not None:
                self.anomaly.observe("itl", dt)
        if self.trace is not None:
            self.trace.emit(EventType.SERVE_RETIRE, request_id=rid,
                            status=status, tokens=len(task.emitted),
                            flagged=flagged, monitor_z=z, **self._trace_tags)
            if flagged:
                self.trace.emit(EventType.SERVE_QUARANTINE, request_id=rid,
                                slot=int(task.slot), **self._trace_tags)
        if self.ledger is not None:
            thash = attribution.token_hash(task.emitted)
            self.ledger.append({
                "request_id": rid, "status": status, "admitted": True,
                **placement,
                "kv_dtype": self.kv_dtype,
                "weight_dtype": self.weight_dtype,
                "kv_fallback_reason": self.kv_fallback_reason,
                "flagged": bool(flagged), "monitor_z": float(z),
                "tokens": len(task.emitted), "token_hash": thash,
                "ttft_s": ttft, "tenant": request.tenant,
            })
            if self.trace is not None:
                self.trace.emit(EventType.ATTRIBUTION, request_id=rid,
                                slot=int(task.slot),
                                n_blocks=len(placement["block_ids"]),
                                token_hash=thash, flagged=bool(flagged),
                                adapter=placement.get("adapter"),
                                adapter_page=placement.get(
                                    "adapter_page", 0),
                                **self._trace_tags)
        self._close_request_spans(rid, status, tokens=len(task.emitted),
                                  flagged=bool(flagged))
        self.collector.collect_batch_metrics({
            "step": self._iteration, "request_id": rid,
            "ttft_s": ttft if ttft is not None else -1.0,
            "tokens": len(task.emitted), "flagged": int(flagged)})
        self._inflight.pop(rid, None)

    # -- reporting ---------------------------------------------------------

    @property
    def quarantined_slots(self):
        return self.scheduler.allocator.quarantined

    def release_quarantine(self, slot: int) -> None:
        """Operator action: return a quarantined row (and its impounded
        blocks) to service."""
        self.scheduler.release_quarantine(slot)

    def quarantine_adapter(self, name: str) -> None:
        """Trust verdict against an ADAPTER: future resolves refuse, its
        page is impounded when the last in-flight request drains.  The
        engine stays in service: adapter trust and slot trust are separate
        axes."""
        if self.adapter_pool is not None:
            self.adapter_pool.quarantine(name)

    def unquarantine_adapter(self, name: str) -> None:
        """Operator action: lift an adapter verdict."""
        if self.adapter_pool is not None:
            self.adapter_pool.unquarantine(name)

    @property
    def quarantined_adapters(self):
        return (self.adapter_pool.quarantined
                if self.adapter_pool is not None else set())

    @property
    def busy(self) -> bool:
        """Work still queued or in flight (the workload drivers' test)."""
        return bool(self._queue or self._inflight)

    @property
    def queued_ids(self) -> List[int]:
        """Request ids awaiting admission."""
        return [task.request_id for task, _ in self._queue]

    @property
    def inflight_ids(self) -> List[int]:
        """Request ids holding a row."""
        return list(self._inflight)

    @property
    def decode_ready_ids(self) -> List[int]:
        """In-flight ids past prefill with tokens emitted: exactly those a
        migration snapshot exists for."""
        prefilling = getattr(self.scheduler, "_prefill", {})
        return [rid for rid, (task, _) in self._inflight.items()
                if task.emitted and not task.done
                and task.slot not in prefilling]

    @property
    def load(self) -> int:
        """Queued + in flight: a router's least-loaded key."""
        return len(self._queue) + len(self._inflight)

    @property
    def open_requests(self) -> int:
        """Accepted-but-unfinished requests (the closed-loop driver's
        in-flight count)."""
        return self.load

    @property
    def in_service_capacity(self) -> int:
        """Rows in service (total minus quarantined)."""
        return self.scheduler.allocator.capacity

    @property
    def attn_kernel_path(self) -> str:
        """The decode program's path (``models.generate.ATTN_IMPLS``):
        "kernel" (through the kernel wrappers: the hand-written kernels on
        the card, their plain twins on CPU tensors) or "plain" (the
        reference path, and always on the stripe pool).  JAX's "pallas"
        and "interpret" are the port's "kernel", its "jnp" the port's
        "plain"."""
        return self.attn_kernel_paths["decode"]

    @property
    def attn_kernel_paths(self) -> Dict[str, str]:
        """The serving-kernel path of each paged program
        (``PAGED_PROGRAMS``): the scheduler's ``attn_impl`` on the paged
        pool; "plain" for every program on the stripe pool, which has
        none of them."""
        path = self.scheduler.attn_impl if self.paged else "plain"
        return {program: path for program in PAGED_PROGRAMS}

    def drain_results(self) -> Dict[int, ServeResult]:
        out = self.results
        self.results = {}
        return out

    def metrics_summary(self) -> Dict[str, Any]:
        """Throughput, latency percentiles, occupancy, prefix reuse and
        trust counters over every request retired so far."""
        elapsed = (time.perf_counter() - self._t_start
                   if self._t_start is not None else 0.0)
        sched = self.scheduler
        out: Dict[str, Any] = {
            "device": str(self.device),
            "attn_impl": sched.attn_impl,
            "kv_dtype": self.kv_dtype,
            "weight_dtype": self.weight_dtype,
            "kv_fallback_reason": self.kv_fallback_reason,
            "requests_completed": self._status_counts.get("completed", 0),
            "requests_deadline_exceeded":
                self._status_counts.get("deadline_exceeded", 0),
            "requests_rejected": self.rejected,
            "requests_shed_slo": self.shed_slo,
            "requests_flagged": self._flagged_total,
            "quarantined_slots": sorted(self.quarantined_slots),
            "tokens_emitted": self._tokens_emitted,
            "elapsed_s": elapsed,
            "tokens_per_s": (self._tokens_emitted / elapsed
                             if elapsed > 0 else 0.0),
            "iterations": self._iteration,
            "decode_ticks": sched.decode_ticks,
            "local_prefills": sched.local_prefills,
            "decode_tick_fraction": (self.decode_tick_s / elapsed
                                     if elapsed > 0 else 0.0),
            "peak_active_requests": self.peak_active,
            "peak_tokens_in_flight": self.peak_tokens_in_flight,
            "layout": "paged" if self.paged else "stripe",
            "attn_kernel_path": self.attn_kernel_path,
            "attn_kernel_paths": self.attn_kernel_paths,
        }
        if self.paged:
            out.update({
                "prefill_chunks": sched.prefill_chunks,
                "prompts_prefilled": sched.prompts_prefilled,
                "blocks_in_use": sched.blocks_in_use,
                "prefix_lookups": sched.prefix_lookups,
                "prefix_hits": sched.prefix_hits,
                "prefix_tokens_reused": sched.prefix_tokens_reused,
                "prefix_hit_rate": (sched.prefix_hits / sched.prefix_lookups
                                    if sched.prefix_lookups else 0.0),
            })
        if self.spec_k:
            out.update({
                "spec_k": self.spec_k,
                "spec_proposed": sched.spec_proposed,
                "spec_accepted": sched.spec_accepted,
                "accepted_rate": sched.accepted_rate,
                "spec_near_tie_flips": sched.spec_near_tie_flips,
                "spec_ticks": sched.spec_ticks,
                "spec_fallback_ticks": sched.spec_fallback_ticks,
                "spec_draft_s": sched.spec_draft_s,
                "spec_verify_s": sched.spec_verify_s,
                "spec_verify_fraction": (sched.spec_verify_s / elapsed
                                         if elapsed > 0 else 0.0),
            })
        if self.adapter_pool is not None:
            out["adapters"] = {"rank": self.adapter_rank,
                               "dtype": self.adapter_dtype,
                               **self.adapter_pool.metrics()}
        out.update(self.metrics.summary())
        if self.slo is not None:
            # JAX's summary block: the watcher's streaming P-square
            # estimates, beside the exact percentiles above.
            out["streaming"] = {}
            for name, signal in (("ttft", "ttft_s"), ("itl", "itl_s")):
                p50 = self.slo.quantile(signal, 0.5)
                if p50 is not None:
                    out["streaming"][f"{name}_p50_ms"] = float(p50 * 1e3)
                    out["streaming"][f"{name}_p99_ms"] = float(
                        self.slo.quantile(signal, 0.99) * 1e3)
        return out

    def analyze_programs(self, ledger: Any) -> Any:
        """Note this engine's serve programs in an ``obs.hbm.CostLedger``
        under JAX's names (paged: ``serve.paged_decode``,
        ``serve.paged_chunk``, ``serve.paged_prefill``; stripe:
        ``serve.decode``, ``serve.prefill``): their product counts, worked
        out from the engine's shapes without running anything (the
        scheduler's ``analyze_costs``)."""
        self.scheduler.analyze_costs(ledger)
        return ledger

    def verify_attribution(self) -> "tuple[bool, list]":
        """Reconcile the attached ledger's records against the paged
        pool's block-lifecycle journal (``obs.attribution``); stripe
        records carry no block ids and verify trivially."""
        if self.ledger is None:
            raise ValueError("engine has no attribution ledger attached")
        allocator = (self.scheduler.blocks if self.paged
                     else self.scheduler.allocator)
        return attribution.verify_attribution(self.ledger.records(),
                                              allocator)
