"""Request lifecycle for the serving engine: queue -> prefill -> decode ->
stream, with deadlines, backpressure, serving metrics and trust-aware
output monitoring.

Counterpart of ``trustworthy_dl_tpu/serve/engine.py`` over the paged pool.
``step()`` expires queued requests past their deadline, admits queued
requests into free rows, runs one scheduler tick (prefill chunks + the
fused decode step), streams the new tokens and retires finished requests.

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

The engine runs on the card: ``device`` defaults to ``"cuda"`` and a
machine without CUDA raises unless the caller passes ``device="cpu"``,
where every kernel wrapper runs its plain PyTorch version.  Observability
spans, the attribution ledger, SLO watchers, chaos hooks, fleets, tensor
parallelism and the adapter pool's HBM gate are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.models import generate as gen
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.quant import int8 as q8
from trustworthy_dl_tpu_torch.serve.adapters import AdapterPool
from trustworthy_dl_tpu_torch.serve.kv_slots import kv_bytes_per_token
from trustworthy_dl_tpu_torch.serve.scheduler import (PagedBatchingScheduler,
                                                      SlotTask)
from trustworthy_dl_tpu_torch.utils.metrics import ServeMetrics

logger = logging.getLogger(__name__)


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
    model)."""

    prompt: Sequence[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    seed: Optional[int] = None
    on_token: Optional[Callable[[int, int], None]] = None
    tenant: Optional[str] = None
    adapter: Optional[str] = None


@dataclasses.dataclass
class ServeResult:
    request_id: int
    tokens: List[int]
    # completed | deadline_exceeded | no_capacity
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


class ServingEngine:
    """Continuous-batching serving over the paged block pool.

    ``queue_limit`` bounds the admission queue: ``submit`` returns None
    (shed) when it is full.  Finished results accumulate in ``results``
    until ``drain_results()`` takes them.  ``kv_dtype``, ``weight_dtype``,
    ``kv_parity_check``, ``spec_k``, ``adapter_rank``,
    ``adapter_pool_pages`` and ``adapter_dtype`` are ``ServeConfig``'s
    knobs; ``adapter_map`` routes tenant -> adapter id."""

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
                 adapter_map: Optional[Dict[str, str]] = None):
        # core.config imports serve (its pool geometry check): late import.
        from trustworthy_dl_tpu_torch.core.config import (validate_adapters,
                                                          validate_spec)

        q8.validate_dtypes(kv_dtype, weight_dtype)
        validate_spec(spec_k, True, weight_dtype)
        validate_adapters(adapter_rank, adapter_pool_pages, adapter_dtype,
                          True, spec_k)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and attn_impl == "kernel" \
                and adapter_rank > 0:
            # B9's limits, checked before any pool or view is allocated:
            # the card has no jnp fallback to move the adapter program to.
            limit = pattn.adapter_kernel_limit(adapter_rank, cfg.n_embd,
                                               cfg.dtype)
            if limit is not None:
                raise ValueError(f"adapter_rank={adapter_rank} is past the "
                                 f"adapter kernel's limits: {limit}")
        if self.device.type == "cuda" and attn_impl == "kernel":
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
        self.cfg = cfg
        self.spec_k = int(spec_k)
        self.kv_fallback_reason: Optional[str] = None
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
                # model-dtype pool shrinks to what those bytes buy.
                if num_blocks is None:
                    num_blocks = max_slots * (max_seq // block_size)
                fallback = max(
                    max_seq // block_size,
                    num_blocks * kv_bytes_per_token(cfg, torch.int8)
                    // kv_bytes_per_token(cfg))
                logger.warning(
                    "int8 KV parity probe failed: falling back to the "
                    "model-dtype paged pool, shrinking %d -> %d blocks to "
                    "stay inside the int8 pool's byte budget", num_blocks,
                    fallback)
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
            self.adapter_pool = AdapterPool(cfg, self.adapter_rank, pages,
                                            adapter_dtype=adapter_dtype,
                                            device=self.device)
        self.scheduler = PagedBatchingScheduler(
            params, cfg, max_slots, max_seq, self.device,
            block_size=block_size, num_blocks=num_blocks,
            prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
            attn_impl=attn_impl, view=view, kv_dtype=kv_dtype,
            weight_dtype=weight_dtype, spec_k=self.spec_k,
            draft_view=draft_view, adapters=self.adapter_pool)
        self.queue_limit = queue_limit
        self.seed = int(seed)
        self.monitor = monitor if monitor is not None else (
            OutputMonitor() if enable_monitor else None)
        self.metrics = ServeMetrics()
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

    @classmethod
    def from_config(cls, params: Any, cfg: gpt2.GPT2Config,
                    serve_config: Any, **kwargs: Any) -> "ServingEngine":
        """Build from a ``core.config.ServeConfig``; ``kwargs`` pass
        through (seed, monitor, device, ...)."""
        return cls(params, cfg, max_slots=serve_config.max_slots,
                   max_seq=serve_config.max_seq,
                   queue_limit=serve_config.queue_limit,
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
                   adapter_dtype=serve_config.adapter_dtype, **kwargs)

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
            return None
        request_id = self._next_id
        self._next_id += 1
        seed = (request.seed if request.seed is not None
                else self.seed * 1_000_003 + request_id)
        task = SlotTask(request_id=request_id, prompt=prompt,
                        max_new_tokens=int(request.max_new_tokens),
                        temperature=float(request.temperature),
                        seed=int(seed), eos_id=request.eos_id,
                        adapter=adapter)
        self._queue.append((task, request))
        self._submit_t[request_id] = time.perf_counter()
        return request_id

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
        while self._queue and self.scheduler.has_free_slot:
            task, request = self._queue.popleft()
            if not self.scheduler.admit(task):
                self._queue.appendleft((task, request))
                break
            self._inflight[task.request_id] = (task, request)
        t_tick = time.perf_counter()
        ticked = self.scheduler.decode_tick()
        self.decode_tick_s += time.perf_counter() - t_tick
        emitted = 0
        for task in ticked:
            rid = task.request_id
            if rid not in self._inflight:
                continue
            _, request = self._inflight[rid]
            # The tokens this tick added: those past the ones already
            # timed.  A speculative tick can add several at once (their
            # ITLs are honest near-zeros: they landed together).
            times = self._timing.setdefault(rid, [])
            new_tokens = task.emitted[len(times):]
            for token in new_tokens:
                times.append(time.perf_counter())
                if request.on_token is not None:
                    request.on_token(rid, token)
            emitted += len(new_tokens)
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
        self.peak_active = max(self.peak_active, self.scheduler.active_count)
        self.peak_tokens_in_flight = max(self.peak_tokens_in_flight,
                                         self.scheduler.tokens_in_flight)
        self.metrics.observe_step(self.scheduler.occupancy)
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
                    task, _ = self._queue.popleft()
                    self._submit_t.pop(task.request_id, None)
                    self._record_result(ServeResult(
                        request_id=task.request_id, tokens=[],
                        status="no_capacity", ttft_s=None, itl_s=[]))
                break
            if it >= max_iterations:
                raise RuntimeError(f"serving loop did not drain in "
                                   f"{max_iterations} iterations")
        return self.results

    # -- internals ---------------------------------------------------------

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
                self._submit_t.pop(rid, None)
                self._record_result(ServeResult(
                    request_id=rid, tokens=[], status="deadline_exceeded",
                    ttft_s=None, itl_s=[]))
            else:
                keep.append((task, request))
        self._queue = keep

    def _record_result(self, result: ServeResult) -> None:
        self._status_counts[result.status] = \
            self._status_counts.get(result.status, 0) + 1
        if result.flagged:
            self._flagged_total += 1
        self.results[result.request_id] = result

    def _finish(self, task: SlotTask, request: ServeRequest,
                status: str) -> None:
        """Score the request with the monitor, retire its row (quarantined
        when flagged) and record the result."""
        rid = task.request_id
        flagged, z = False, 0.0
        if self.monitor is not None and task.entropies:
            flagged, z = self.monitor.observe(task.entropies, task.margins)
        self.scheduler.retire(task, quarantine=flagged)
        times = self._timing.pop(rid, [])
        t0 = self._submit_t.pop(rid, None)
        ttft = (times[0] - t0) if times and t0 is not None else None
        itl = [b - a for a, b in zip(times, times[1:])]
        self.metrics.observe_request(ttft, itl)
        self._record_result(ServeResult(
            request_id=rid, tokens=list(task.emitted), status=status,
            ttft_s=ttft, itl_s=itl, flagged=flagged, monitor_z=z,
            entropies=list(task.entropies), margins=list(task.margins),
            adapter=task.adapter))
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
    def open_requests(self) -> int:
        """Accepted-but-unfinished requests (the closed-loop driver's
        in-flight count)."""
        return len(self._queue) + len(self._inflight)

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
            "requests_flagged": self._flagged_total,
            "quarantined_slots": sorted(self.quarantined_slots),
            "tokens_emitted": self._tokens_emitted,
            "elapsed_s": elapsed,
            "tokens_per_s": (self._tokens_emitted / elapsed
                             if elapsed > 0 else 0.0),
            "iterations": self._iteration,
            "decode_ticks": sched.decode_ticks,
            "local_prefills": sched.local_prefills,
            "prefill_chunks": sched.prefill_chunks,
            "decode_tick_fraction": (self.decode_tick_s / elapsed
                                     if elapsed > 0 else 0.0),
            "peak_active_requests": self.peak_active,
            "peak_tokens_in_flight": self.peak_tokens_in_flight,
            "blocks_in_use": sched.blocks_in_use,
            "prefix_lookups": sched.prefix_lookups,
            "prefix_hits": sched.prefix_hits,
            "prefix_tokens_reused": sched.prefix_tokens_reused,
            "prefix_hit_rate": (sched.prefix_hits / sched.prefix_lookups
                                if sched.prefix_lookups else 0.0),
        }
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
        return out
