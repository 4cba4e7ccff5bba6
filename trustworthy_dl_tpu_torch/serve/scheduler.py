"""Continuous (iteration-level) batching over the two KV pools.

Counterpart of ``trustworthy_dl_tpu/serve/scheduler.py``.

The legacy stripe scheduler (:class:`ContinuousBatchingScheduler`, one
pool slot a request) prefills a prompt at admission, padded to a power-of-
two bucket (``default_buckets``), through the same full-precision local
cache as the paged prefill (``_local_prefill``, quantized once at the slot
write on an int8 pool): ``_prefill_impl``.  Its decode step
(``_decode_impl``) runs the dense cache path of ``models/generate`` over
every slot at per-slot lengths, one token each, with one host copy of the
packed outputs a tick.  Its trust signals come from ``_logit_signals``
like the paged engine's (B7 on the kernel path).

The paged scheduler (:class:`PagedBatchingScheduler`, the default):
each engine tick advances every mid-prefill slot by one chunk, then runs
one decode step for every decode-phase slot: the fused single-token step,
or with ``spec_k`` > 0 a speculative tick.  The device programs, as in the
JAX package:

* ``_paged_prefill_impl``: a prompt that fits one chunk with no prefix
  hit runs through a full-precision local dense cache (plain torch ops,
  no attention kernel), and its K/V are written into the pool block-wise
  (quantized once there on an int8 pool);
* ``_paged_chunk_impl``: one chunk of a longer prompt, or the suffix of a
  prefix-cache hit, attends through the pool (B6 on the kernel path);
* ``_paged_decode_impl``: one token for every decode row, live or not
  (inactive rows point at the trash block), through B5;
* ``_spec_draft_impl`` / ``_spec_verify_impl``: ``spec_k`` single-token
  draft steps with the int8 weight view (B4 in every block matrix, B5),
  chained on the device, then one model-dtype forward over every slot's
  window [last emitted, d_1 .. d_k] that overwrites the draft positions
  with target K/V, with the fused verify tail (B8) on the kernel path.

The trust signals of every first token and every decode tick come from
``_logit_signals`` (B7 on the kernel path); a verify pass's come from its
tail.  Host-facing outputs ride one packed f32 tensor, one device-to-host
copy per program (the draft chain adds one for its tokens).

Sampling: greedy rows take the argmax; a sampled row draws from
softmax(logits / temp) with a generator seeded from (request seed,
emission index) alone, so a token is a function of the seed, its index
and the logits - the port's counterpart of the JAX per-request key stream
(``request_key_stream``), whose threefry draws it does not reproduce.  A
verify pass that samples k + 1 positions and keeps some therefore leaves
the stream where spec-off decode would.

The pool is updated IN PLACE.  Draft steps write draft K/V at positions
[len, len + k); the verify pass, at the lengths fixed before the draft
(a host copy), writes the target K/V of [len, len + k + 1) before it
reads them; positions past the accepted length are causally invisible
and are overwritten by the next tick.

Adapters (``adapters``, a ``serve.adapters.AdapterPool``): admission
claims the request's adapter page after its KV blocks (and unwinds both
when the pool is full of live pages); an adapter-carrying prompt always
prefills through the chunk path, and every chunk and decode tick carries
the pool and the per-slot page row (adapterless and inactive slots on
``ZERO_PAGE``, an exactly-zero delta).  Prefix reuse is scoped by adapter
(``kv_slots.PrefixCache``).

Telemetry, as in JAX: ``spans`` (an ``obs.spans.SpanTracker``, set by the
engine) times each prefix lookup (``serve.prefix_lookup``), prefill chunk
(``serve.prefill_chunk``) and speculative verify (``serve.spec_verify``);
admission records each request's placement (block table, prefix blocks and
their publishers, adapter page) for the attribution ledger
(:meth:`PagedBatchingScheduler.attribution_info`); with a compile watcher
(``compilewatch``, an ``obs.compilewatch.CompileWatcher`` set by the
engine) each decode step, draft step and verify pass runs under its
``serve_decode``, ``serve_spec_draft`` and ``serve_spec_verify`` guard, so
a kernel library loaded inside one after its first call is a storm.

Live migration (``serve/migrate.py``) goes through the paged scheduler's
``export_migration`` / ``claim_migration`` / ``abort_migration`` /
``commit_migration``: a decode-phase request's block table, length and
placement leave the source, the destination claims a row, fresh blocks
and the adapter page through its normal allocators, and the commit
registers the task with a ``migrated_from`` record.  The seed travels with
the task and the next draw index is ``len(emitted)``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trustworthy_dl_tpu_torch.models import generate as gen
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.obs.compilewatch import guarded
from trustworthy_dl_tpu_torch.obs.hbm import FLOPS_SOURCE
from trustworthy_dl_tpu_torch.ops.fused_dequant_matmul import \
    dequant_matmul_flops
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.quant import int8 as q8
from trustworthy_dl_tpu_torch.serve.adapters import (ZERO_PAGE, AdapterPool,
                                                     adapter_page_row)
from trustworthy_dl_tpu_torch.serve.kv_slots import (
    TRASH_BLOCK,
    BlockAllocator,
    PagedKV,
    PrefixCache,
    SlotAllocator,
    SlotKV,
    blocks_for_span,
    init_paged_pool,
    init_slots,
    resolve_prefill_chunk,
    validate_paged_geometry,
)

logger = logging.getLogger(__name__)

_MASK64 = (1 << 64) - 1


def default_buckets(max_seq: int, smallest: int = 16) -> Tuple[int, ...]:
    """Power-of-two prefill buckets up to ``max_seq`` (inclusive): the
    stripe prefill pads each prompt to one of O(log max_seq) widths."""
    out: List[int] = []
    b = smallest
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(out)


def choose_bucket(buckets: Sequence[int], prompt_len: int) -> int:
    """Smallest bucket holding ``prompt_len`` tokens."""
    for b in sorted(buckets):
        if b >= prompt_len:
            return b
    raise ValueError(
        f"prompt of {prompt_len} tokens exceeds the largest prefill "
        f"bucket {max(buckets)}")


def draw_seed(seed: int, index: int) -> int:
    """The generator seed of emission ``index`` of a request seeded with
    ``seed``: a SplitMix64 mix of the pair, in [0, 2**63)."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(index) + 1)
         * 0xD1B54A32D192ED03) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _sample_tokens(logits: torch.Tensor, seeds: Sequence[int],
                   indices: Sequence[int], temps: Sequence[float],
                   greedy: Sequence[bool]) -> torch.Tensor:
    """[B, V] -> [B]: argmax for greedy rows; for the others one draw from
    softmax(logits / temp) with the generator of (seed, emission index),
    made fresh for the draw: no generator state is shared between draws,
    engines or threads."""
    tokens = logits.argmax(dim=-1)
    for i, is_greedy in enumerate(greedy):
        if not is_greedy:
            probs = torch.softmax(logits[i] / max(temps[i], 1e-6), dim=-1)
            gen_ = torch.Generator(device=logits.device).manual_seed(
                draw_seed(seeds[i], indices[i]))
            tokens[i] = torch.multinomial(probs, 1, generator=gen_)[0]
    return tokens


def _logit_signals(logits: torch.Tensor, attn_impl: str = "kernel"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row softmax entropy and top-1 margin of f32 logits [B, V]:
    the fused trust epilogue (B7) on the kernel path, log_softmax and
    top-2 on the plain path."""
    if attn_impl == "kernel":
        return pattn.logit_trust_stats(logits)
    return pattn.logit_trust_stats_plain(logits)


def _pack_step_outputs(tokens: torch.Tensor, entropy: torch.Tensor,
                       margin: torch.Tensor) -> torch.Tensor:
    """[3, B] f32: token ids (exact in f32 below 2**24), entropies,
    margins, so the host pays one copy per program."""
    return torch.stack([tokens.float(), entropy, margin])


def _local_prefill(cfg: gpt2.GPT2Config, view: Any, tokens: torch.Tensor,
                   real_len: int, quantized: bool = False
                   ) -> Tuple[torch.Tensor, ...]:
    """Run the blocks over the padded prompt [C] through a full-precision
    local cache; returns (logits at ``real_len - 1`` [1, V], local K,
    local V [L, 1, H, C, Dh], K scales, V scales [L, 1, H, C]).  With
    ``quantized`` the K/V come back int8 with their scales (quantized once,
    here); else the scales are None."""
    local = gen.init_cache(cfg, 1, tokens.shape[0], tokens.device)
    logits, local = gen._apply_with_cache(view, tokens[None], local, cfg,
                                          last_pos=real_len - 1)
    if quantized:
        k_rows, k_s = q8.quantize_kv(local.k)
        v_rows, v_s = q8.quantize_kv(local.v)
        return logits, k_rows, v_rows, k_s, v_s
    return logits, local.k, local.v, None, None


def _sample_pack(logits: torch.Tensor, seed: int, index: int, temp: float,
                 greedy: bool, attn_impl: str) -> torch.Tensor:
    """Single-slot tail: first token + trust signals, packed [3, 1]."""
    token = _sample_tokens(logits, [seed], [index], [temp], [greedy])
    entropy, margin = _logit_signals(logits, attn_impl)
    return _pack_step_outputs(token, entropy, margin)


def _prefill_impl(cfg: gpt2.GPT2Config, kv: SlotKV, view: Any,
                  tokens: torch.Tensor, real_len: int, slot: int, seed: int,
                  temp: float, greedy: bool, attn_impl: str) -> torch.Tensor:
    """Prefill one STRIPE slot: the ``_local_prefill`` prologue over the
    bucketed prompt [P], then its K/V (and scales, on an int8 pool) written
    into the slot's row at positions [0, P)."""
    p = tokens.shape[0]
    logits, k_rows, v_rows, k_s, v_s = _local_prefill(
        cfg, view, tokens, real_len, kv.quantized)
    kv.k[:, slot, :, :p] = k_rows[:, 0].to(kv.k.dtype)
    kv.v[:, slot, :, :p] = v_rows[:, 0].to(kv.v.dtype)
    if kv.quantized:
        kv.k_scale[:, slot, :, :p] = k_s[:, 0]
        kv.v_scale[:, slot, :, :p] = v_s[:, 0]
    return _sample_pack(logits, seed, 0, temp, greedy, attn_impl)


def _decode_impl(cfg: gpt2.GPT2Config, kv: SlotKV, view: Any,
                 tokens: torch.Tensor, lengths: torch.Tensor,
                 seeds: Sequence[int], indices: Sequence[int],
                 temps: Sequence[float], greedy: Sequence[bool],
                 attn_impl: str) -> torch.Tensor:
    """The fused stripe decode step: one token for every slot, live or
    not, written at the per-slot ``lengths`` (i32 [MAX_SLOTS]) through the
    dense cache path batch ``generate`` runs (``models/generate.
    _apply_with_cache`` with a tensor start); returns the packed
    [3, MAX_SLOTS] outputs."""
    cache = gen.KVCache(k=kv.k, v=kv.v, length=lengths,
                        k_scale=kv.k_scale, v_scale=kv.v_scale)
    logits, _ = gen._apply_with_cache(view, tokens[:, None], cache, cfg)
    next_tok = _sample_tokens(logits, seeds, indices, temps, greedy)
    entropy, margin = _logit_signals(logits, attn_impl)
    return _pack_step_outputs(next_tok, entropy, margin)


def _paged_prefill_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                        tokens: torch.Tensor, real_len: int,
                        block_ids: torch.Tensor, seed: int, temp: float,
                        greedy: bool, attn_impl: str) -> torch.Tensor:
    """Whole-prompt prefill into the pool: the local-cache prologue, then
    the local K/V (and scales, on an int8 pool) re-laid out block-wise and
    written at ``block_ids`` (entries past the slot's allocation point at
    the trash block)."""
    c = tokens.shape[0]
    bsz = kv.block_size
    logits, k_rows, v_rows, k_s, v_s = _local_prefill(
        cfg, view, tokens, real_len, kv.quantized)

    def to_blocks(a: torch.Tensor) -> torch.Tensor:
        # [L, 1, H, C(, Dh)] -> [L, C/BLOCK, H, BLOCK(, Dh)]
        l, _, h = a.shape[:3]
        a = a[:, 0].transpose(1, 2).reshape(l, c // bsz, bsz, h,
                                            *a.shape[4:])
        return a.transpose(2, 3)

    kv.k[:, block_ids] = to_blocks(k_rows).to(kv.k.dtype)
    kv.v[:, block_ids] = to_blocks(v_rows).to(kv.v.dtype)
    if kv.quantized:
        kv.k_scale[:, block_ids] = to_blocks(k_s)
        kv.v_scale[:, block_ids] = to_blocks(v_s)
    return _sample_pack(logits, seed, 0, temp, greedy, attn_impl)


def _paged_chunk_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                      tokens: torch.Tensor, table: torch.Tensor,
                      start: torch.Tensor, last_idx: int, final: bool,
                      seed: int, temp: float, greedy: bool, attn_impl: str,
                      adapter: Optional[tuple] = None
                      ) -> Optional[torch.Tensor]:
    """One chunk of a paged prefill: C prompt positions from ``start``
    (i32 [1]) attending to everything already in the slot's blocks and
    writing their own K/V.  Only the prompt's final chunk projects logits
    and samples (the JAX program computes them on every chunk and the
    host drops them; here the host knows which chunk is final).
    ``adapter`` is the adapter pool and the slot's page [1]."""
    out = gen._apply_with_cache_paged(
        view, tokens[None], kv.k, kv.v, table, start, cfg,
        last_pos=last_idx, attn_impl=attn_impl, hidden=not final,
        pool_ks=kv.k_scale, pool_vs=kv.v_scale, adapter=adapter)
    if not final:
        return None
    return _sample_pack(out, seed, 0, temp, greedy, attn_impl)


def _paged_decode_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                       tokens: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor, seeds: Sequence[int],
                       indices: Sequence[int], temps: Sequence[float],
                       greedy: Sequence[bool], attn_impl: str,
                       adapter: Optional[tuple] = None) -> torch.Tensor:
    """The fused paged decode step: one token for every row; returns the
    packed [3, MAX_SLOTS] outputs.  ``adapter`` is the adapter pool and
    the per-slot page row."""
    logits = gen._apply_with_cache_paged(view, tokens[:, None], kv.k, kv.v,
                                         tables, lengths, cfg,
                                         attn_impl=attn_impl,
                                         pool_ks=kv.k_scale,
                                         pool_vs=kv.v_scale,
                                         adapter=adapter)
    next_tok = _sample_tokens(logits, seeds, indices, temps, greedy)
    entropy, margin = _logit_signals(logits, attn_impl)
    return _pack_step_outputs(next_tok, entropy, margin)


def _spec_draft_impl(cfg: gpt2.GPT2Config, kv: PagedKV, draft_view: Any,
                     tokens: torch.Tensor, tables: torch.Tensor,
                     lengths: torch.Tensor, seeds: Sequence[int],
                     indices: Sequence[int], temps: Sequence[float],
                     greedy: Sequence[bool], attn_impl: str
                     ) -> torch.Tensor:
    """One draft step of the speculative tick: the fused decode body with
    the int8 draft view; returns the next tokens [R] on the device (the
    chain feeds on-device) and skips the trust reductions (draft logits
    never reach the monitor)."""
    logits = gen._apply_with_cache_paged(draft_view, tokens[:, None], kv.k,
                                         kv.v, tables, lengths, cfg,
                                         attn_impl=attn_impl,
                                         pool_ks=kv.k_scale,
                                         pool_vs=kv.v_scale)
    return _sample_tokens(logits, seeds, indices, temps, greedy)


def _spec_verify_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                      tokens: torch.Tensor, tables: torch.Tensor,
                      lengths: torch.Tensor, seeds: Sequence[int],
                      indices: Sequence[int], temps: Sequence[float],
                      greedy: Sequence[bool], attn_impl: str
                      ) -> torch.Tensor:
    """The batched verify: one model-dtype forward over every slot's window
    ``tokens`` [R, k+1] at the pre-draft ``lengths``, overwriting the draft
    positions with target K/V (quantized at the write on an int8 pool), and
    per-position sampling at emission indices ``indices`` [R*(k+1)].  The
    tail is the fused verify kernel (B8) on the kernel path, the
    materialised logits plus the plain trust reductions otherwise.  Returns
    the packed [3, R, k+1]."""
    r, t = tokens.shape
    paged = dict(attn_impl=attn_impl, pool_ks=kv.k_scale,
                 pool_vs=kv.v_scale)
    if attn_impl == "kernel":
        x = gen._apply_with_cache_paged(view, tokens, kv.k, kv.v, tables,
                                        lengths, cfg, hidden=True, **paged)
        logits, ent, margin = gen.fused_verify_logits(view, x, cfg)
        flat = logits.reshape(r * t, -1)
    else:
        logits = gen._apply_with_cache_paged(view, tokens, kv.k, kv.v,
                                             tables, lengths, cfg,
                                             all_logits=True, **paged)
        flat = logits.reshape(r * t, -1)
        ent, margin = _logit_signals(flat, attn_impl)
    tok = _sample_tokens(flat, np.repeat(seeds, t), indices,
                         np.repeat(temps, t), np.repeat(greedy, t))
    return _pack_step_outputs(tok, ent, margin).reshape(3, r, t)


def _device_i32(device: torch.device, *arrays: np.ndarray
                ) -> List[torch.Tensor]:
    """Copy several host int arrays to ``device`` in ONE transfer; returns
    contiguous i32 views shaped like the inputs."""
    flat = np.concatenate([np.ravel(a).astype(np.int32) for a in arrays])
    dev = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        out.append(dev[off:off + a.size].view(a.shape))
        off += a.size
    return out


@dataclasses.dataclass
class SlotTask:
    """Host-side record of one in-flight sequence."""

    request_id: int
    prompt: np.ndarray            # i32 [P] token ids
    max_new_tokens: int
    temperature: float
    seed: int = 0                 # sampling seed (unused when greedy)
    eos_id: Optional[int] = None
    adapter: Optional[str] = None  # resolved adapter id (None = base)
    adapter_page: int = ZERO_PAGE  # its pool page while admitted
    # False: the prompt's blocks are never published to the prefix cache
    # (a fleet's vote replay, an audit that must not change cache state).
    publish_prefix: bool = True
    slot: int = -1
    emitted: List[int] = dataclasses.field(default_factory=list)
    next_token: int = -1
    entropies: List[float] = dataclasses.field(default_factory=list)
    margins: List[float] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def _record(self, token: int, ent: float, margin: float) -> None:
        self.emitted.append(token)
        self.next_token = token
        self.entropies.append(ent)
        self.margins.append(margin)
        if (len(self.emitted) >= self.max_new_tokens
                or (self.eos_id is not None and token == self.eos_id)):
            self.done = True


def _cost_block(view: Any, rows: int, t: int, head_rows: int, keys: int,
                extra: Sequence[Tuple[Optional[str], int]]
                ) -> Dict[str, Any]:
    """The cost block of ``obs.hbm.count_flops`` for one forward over
    ``rows`` rows of ``t`` new positions: the view's four block matrices
    (B4's shape count on the int8 weight tier, library products
    otherwise), the ``extra`` (kernel name or None for a library product,
    FLOPs) entries, and the tied head over ``head_rows`` rows."""
    kernels: Dict[str, int] = {}
    library = 0

    def add(name: Optional[str], flops: int) -> None:
        nonlocal library
        if name is None:
            library += flops
        else:
            kernels[name] = kernels.get(name, 0) + flops

    for block in view["layers"]:
        for part, name in (("attn", "qkv"), ("attn", "proj"),
                           ("mlp", "fc"), ("mlp", "proj")):
            d = block[part][name]
            if q8.is_quantized_dense(d):
                k, n = d["w_q"].shape
                add("dequant_matmul", dequant_matmul_flops(rows * t, k, n))
            else:
                k, n = d["w"].shape
                add(None, 2 * rows * t * k * n)
    for name, flops in extra:
        add(name, flops)
    v, d = view["wte_head"].shape
    library += 2 * head_rows * d * v
    total = library + sum(kernels.values())
    return {"flops": float(total), "library_flops": library,
            "kernel_flops": dict(sorted(kernels.items())),
            "flops_source": FLOPS_SOURCE, "bytes_accessed": None,
            "rows": rows, "positions": t, "keys": keys}


def _local_cost(view: Any, cfg: gpt2.GPT2Config, rows: int, t: int,
                keys: int, head_rows: int) -> Dict[str, Any]:
    """:func:`_cost_block` of the dense cache path (the local prefill and
    the stripe programs): QK^T and PV over ``keys`` cached positions are
    library products, counted as the paged kernels' plain twins count
    theirs."""
    return _cost_block(view, rows, t, head_rows, keys, [
        (None, cfg.n_layer * pattn.paged_attention_flops(
            rows, cfg.n_head, t, cfg.head_dim, keys))])


class ContinuousBatchingScheduler:
    """Slot admission and the fused decode step over the stripe pool.

    Host state: per-slot lengths (numpy) and the live ``SlotTask`` table.
    Device state: the ``SlotKV`` pool on ``device``, updated in place.
    ``admit`` prefills the prompt and records the first token; each
    ``decode_tick`` gives every live slot one token.  ``attn_impl``
    "kernel" takes the trust signals through B7 on a CUDA tensor, "plain"
    through its plain twin (the stripe pool has no attention kernel)."""

    def __init__(self, params: Any, cfg: gpt2.GPT2Config, max_slots: int,
                 max_seq: int, device: torch.device,
                 buckets: Optional[Sequence[int]] = None,
                 kv_dtype: str = "model", weight_dtype: str = "model",
                 view: Any = None, attn_impl: str = "kernel"):
        q8.validate_dtypes(kv_dtype, weight_dtype)
        if attn_impl not in gen.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {gen.ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        self.cfg = cfg
        self.device = device
        self.attn_impl = attn_impl
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        if view is None:
            view = (q8.quantize_decode_view(params, cfg)
                    if weight_dtype == "int8"
                    else gen._decode_view(params, cfg))
        self.view = view
        self.kv = init_slots(cfg, max_slots, max_seq, device,
                             kv_dtype=q8.resolve_kv_dtype(kv_dtype, cfg))
        self.allocator = SlotAllocator(max_slots)
        self.buckets = tuple(sorted(buckets or default_buckets(max_seq)))
        if max(self.buckets) > max_seq:
            raise ValueError("prefill bucket exceeds max_seq")
        self.lengths = np.zeros(max_slots, np.int32)
        self.tasks: Dict[int, SlotTask] = {}       # slot -> task
        self.max_seq = max_seq
        self.spans: Any = None
        # An obs.compilewatch.CompileWatcher (the engine's): the decode
        # dispatch runs under its "serve_decode" guard.
        self.compilewatch: Any = None
        # The stripe pool has no adapter tier (validate_adapters pins
        # adapter_rank > 0 to the paged pool).
        self.adapters: Any = None
        self.decode_ticks = 0
        self.local_prefills = 0

    def attribution_info(self, task: SlotTask) -> Dict[str, Any]:
        """The attribution ledger's placement: the slot is the whole story
        (no block table)."""
        return {"layout": "stripe", "slot": int(task.slot),
                "block_ids": [], "prefix_block_ids": [],
                "prefix_publishers": {},
                "adapter": task.adapter,
                "adapter_page": int(task.adapter_page)}

    @property
    def has_free_slot(self) -> bool:
        return self.allocator.free_count > 0

    @property
    def active_count(self) -> int:
        return len(self.tasks)

    @property
    def occupancy(self) -> float:
        return len(self.tasks) / max(self.allocator.max_slots, 1)

    @property
    def tokens_in_flight(self) -> int:
        """Cached tokens backing live sequences."""
        return int(sum(int(self.lengths[s]) for s in self.tasks))

    def admit(self, task: SlotTask) -> bool:
        """Claim a slot, prefill the prompt, record the first token.
        Returns False, task untouched, when no slot is free.  The bucket is
        resolved before the slot is claimed: a prompt past the largest
        bucket raises without leaking a slot."""
        p = len(task.prompt)
        total = p + task.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request {task.request_id}: prompt+new = {total} exceeds "
                f"max_seq={self.max_seq}")
        bucket = choose_bucket(self.buckets, p)
        slot = self.allocator.alloc()
        if slot is None:
            return False
        padded = np.zeros(bucket, np.int32)
        padded[:p] = task.prompt
        tokens, = _device_i32(self.device, padded)
        packed = _prefill_impl(self.cfg, self.kv, self.view, tokens.long(),
                               p, slot, task.seed,
                               max(task.temperature, 1e-6), task.greedy,
                               self.attn_impl)
        self.local_prefills += 1
        task.slot = slot
        token, ent, margin = packed.cpu().numpy()[:, 0]   # one host copy
        task._record(int(token), float(ent), float(margin))
        self.lengths[slot] = p
        self.tasks[slot] = task
        return True

    def decode_tick(self) -> List[SlotTask]:
        """One fused decode step for every live slot; returns the tasks
        that received a token."""
        if not self.tasks:
            return []
        ms = self.allocator.max_slots
        tokens = np.zeros(ms, np.int32)
        seeds = [0] * ms
        indices = [0] * ms
        temps = [1.0] * ms
        greedy = [True] * ms
        for slot, task in self.tasks.items():
            tokens[slot] = task.next_token
            seeds[slot] = task.seed
            indices[slot] = len(task.emitted)
            temps[slot] = max(task.temperature, 1e-6)
            greedy[slot] = task.greedy
        tokens_dev, lengths_dev = _device_i32(self.device, tokens,
                                              self.lengths)
        with guarded(self.compilewatch, "serve_decode"):
            packed = _decode_impl(self.cfg, self.kv, self.view,
                                  tokens_dev.long(), lengths_dev, seeds,
                                  indices, temps, greedy, self.attn_impl)
        self.decode_ticks += 1
        host = packed.cpu().numpy()      # the tick's one device-to-host copy
        next_tok, ent, margin = host[0], host[1], host[2]
        ticked: List[SlotTask] = []
        for slot, task in list(self.tasks.items()):
            self.lengths[slot] += 1
            task._record(int(next_tok[slot]), float(ent[slot]),
                         float(margin[slot]))
            ticked.append(task)
        return ticked

    def retire(self, task: SlotTask, quarantine: bool = False) -> None:
        """Release the task's slot, or quarantine it (a flagged request:
        the slot leaves service until an operator releases it)."""
        slot = task.slot
        if slot < 0 or self.tasks.get(slot) is not task:
            return
        del self.tasks[slot]
        if quarantine:
            self.allocator.quarantine(slot)
            logger.warning(
                "slot %d quarantined after request %d was flagged "
                "anomalous (%d slots remain in service)", slot,
                task.request_id, self.allocator.capacity)
        else:
            self.allocator.free(slot)

    def release_quarantine(self, slot: int) -> None:
        """Operator action: return a quarantined slot to service."""
        self.allocator.release(slot)

    def analyze_costs(self, ledger: Any) -> None:
        """Note ``serve.prefill`` (a prompt at the largest bucket) and
        ``serve.decode`` (every slot, one position each, attending over
        ``max_seq`` positions) in an ``obs.hbm.CostLedger``, from the
        shapes; each equals what ``count_flops`` counts over one run."""
        ms = self.allocator.max_slots
        bucket = max(self.buckets)
        ledger.note("serve.prefill",
                    _local_cost(self.view, self.cfg, 1, bucket, bucket, 1))
        ledger.note("serve.decode",
                    _local_cost(self.view, self.cfg, ms, 1, self.max_seq,
                                ms))


@dataclasses.dataclass
class _PrefillProgress:
    """A slot mid-prefill: ``pos`` is the next prompt position to feed
    (block-aligned; starts past the shared prefix)."""

    task: SlotTask
    pos: int
    plen: int


class PagedBatchingScheduler:
    """Continuous batching over the paged block pool.

    A request claims ``ceil((prompt + max_new) / BLOCK)`` blocks at
    admission, reusing cached prefix blocks where its prompt matches the
    radix cache; prefill then covers only the unshared suffix, one chunk
    per tick, interleaved with the decode step.  Host state: per slot
    lengths and block tables (numpy/lists), the task table and the
    allocators.  Device state: the pool, updated in place.

    ``kv_dtype`` selects the pool's storage (``"int8"``: int8 values with
    f32 scales; the prefill chunk then defaults to ``max_seq``, so a fresh
    prompt prefills through the full-precision local cache in one piece).
    ``view`` is the served weight view (built here when None: weight-only
    int8 under ``weight_dtype="int8"``); ``spec_k`` > 0 with ``draft_view``
    (the int8 self-draft) turns decode ticks speculative; ``adapters``
    (an ``AdapterPool`` on ``device``) turns on the adapter tier."""

    def __init__(self, params: Any, cfg: gpt2.GPT2Config, max_slots: int,
                 max_seq: int, device: torch.device,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 attn_impl: str = "kernel", view: Any = None,
                 kv_dtype: str = "model", weight_dtype: str = "model",
                 spec_k: int = 0, draft_view: Any = None,
                 adapters: Optional[AdapterPool] = None):
        q8.validate_dtypes(kv_dtype, weight_dtype)
        validate_paged_geometry(max_seq, block_size, num_blocks,
                                prefill_chunk)
        if max_seq > cfg.n_positions:
            raise ValueError(
                f"max_seq={max_seq} exceeds the model's position table "
                f"(n_positions={cfg.n_positions})")
        if attn_impl not in gen.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {gen.ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        self.cfg = cfg
        self.device = device
        self.attn_impl = attn_impl
        self.kv_dtype = kv_dtype
        self.weight_dtype = weight_dtype
        if view is None:
            view = (q8.quantize_decode_view(params, cfg)
                    if weight_dtype == "int8"
                    else gen._decode_view(params, cfg))
        self.view = view
        self.block_size = block_size
        self.nbps = max_seq // block_size
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_slots * self.nbps)
        if prefill_chunk is None and kv_dtype == "int8":
            # A chunked continuation would attend to already-quantized
            # blocks; the one-chunk local prefill sees exact K/V (the JAX
            # engine's default for the same reason).
            self.chunk = max_seq
        else:
            self.chunk = resolve_prefill_chunk(max_seq, block_size,
                                               prefill_chunk)
        self.kv = init_paged_pool(cfg, self.num_blocks, block_size, device,
                                  kv_dtype=q8.resolve_kv_dtype(kv_dtype,
                                                               cfg))
        self.allocator = SlotAllocator(max_slots)
        self.blocks = BlockAllocator(self.num_blocks)
        self.prefix = (PrefixCache(block_size, self.blocks)
                       if prefix_cache else None)
        self.adapters = adapters
        self.max_seq = max_seq
        self.lengths = np.zeros(max_slots, np.int32)
        self.tables: List[List[int]] = [[] for _ in range(max_slots)]
        self.tasks: Dict[int, SlotTask] = {}       # slot -> task
        self._prefill: Dict[int, _PrefillProgress] = {}
        self._q_blocks_by_slot: Dict[int, List[int]] = {}
        self._published: Dict[int, List[int]] = {}
        # slot -> the admission-time placement snapshot the attribution
        # ledger reads at retirement, after retire() cleared the table.
        self._attrib: Dict[int, Dict[str, Any]] = {}
        self.spans: Any = None   # an obs.spans.SpanTracker (the engine's)
        # An obs.compilewatch.CompileWatcher (the engine's): the decode,
        # draft and verify dispatches run under its guards.
        self.compilewatch: Any = None
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.decode_ticks = 0
        self.local_prefills = 0
        self.prefill_chunks = 0
        # Prompts whose prefill finished here (a first token recorded):
        # each projected its last row's logits once, through B7 on the
        # kernel path.
        self.prompts_prefilled = 0
        # -- speculative decoding (spec_k > 0) --------------------------------
        self.spec_k = int(spec_k)
        self.draft_view = draft_view
        if self.spec_k > 0 and draft_view is None:
            raise ValueError(
                "spec_k > 0 needs a draft_view (the int8 weight tier; "
                "quant.int8.draft_decode_view - the engine builds it)")
        self._spec_claims: Dict[int, List[int]] = {}
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_near_tie_flips = 0
        self.spec_ticks = 0
        self.spec_fallback_ticks = 0
        # Host wall time in the two phases (the draft chain syncs at its
        # token copy, the verify at its packed copy).
        self.spec_draft_s = 0.0
        self.spec_verify_s = 0.0

    # -- cost ledger ---------------------------------------------------------

    def _program_cost(self, rows: int, t: int, head_rows: int
                      ) -> Dict[str, Any]:
        """Products of one paged program over ``rows`` rows of ``t`` new
        positions at the full table width, projecting ``head_rows`` rows
        to logits: :func:`_cost_block` with the attention kernel's and
        B9's shape counts (library products on the plain path)."""
        cfg = self.cfg
        on_kernels = self.attn_impl == "kernel"
        keys = self.nbps * self.block_size
        attend = "paged_prefill_attention" if t > pattn.QROWS \
            else "paged_attention"
        if self.kv.quantized:
            attend += "_int8"
        extra = [(attend if on_kernels else None, cfg.n_layer *
                  pattn.paged_attention_flops(rows, cfg.n_head, t,
                                              cfg.head_dim, keys))]
        if self.adapters is not None:
            # Two sites a layer (the attention output, the ln_2 output).
            extra.append(("adapter_delta" if on_kernels else None,
                          2 * cfg.n_layer * pattn.adapter_delta_flops(
                              rows, t, cfg.n_embd, self.adapters.rank)))
        return _cost_block(self.view, rows, t, head_rows, keys, extra)

    def analyze_costs(self, ledger: Any) -> None:
        """Note the three paged programs in an ``obs.hbm.CostLedger`` under
        JAX's names, worked out from the engine's shapes without running
        anything: ``serve.paged_decode`` (every one of ``max_slots`` rows,
        one position each), ``serve.paged_chunk`` (a full chunk of one row,
        the prompt's final chunk, which projects its last position) and
        ``serve.paged_prefill`` (the dense local prefill of a chunk-wide
        prompt).  The first two attend over the full table width, as the
        attention kernels' plain twins do, so the counts do not depend on
        the rows' current lengths; each equals what ``count_flops`` counts
        over one run of the program."""
        ms = self.allocator.max_slots
        ledger.note("serve.paged_decode", self._program_cost(ms, 1, ms))
        ledger.note("serve.paged_chunk",
                    self._program_cost(1, self.chunk, 1))
        ledger.note("serve.paged_prefill",
                    _local_cost(self.view, self.cfg, 1, self.chunk,
                                self.chunk, 1))

    # -- admission ---------------------------------------------------------

    @property
    def has_free_slot(self) -> bool:
        return self.allocator.free_count > 0

    @property
    def active_count(self) -> int:
        return len(self.tasks)

    @property
    def occupancy(self) -> float:
        return len(self.tasks) / max(self.allocator.max_slots, 1)

    @property
    def tokens_in_flight(self) -> int:
        total = sum(int(self.lengths[s]) for s in self.tasks
                    if s not in self._prefill)
        total += sum(min(st.pos, st.plen) for st in self._prefill.values())
        return int(total)

    @property
    def blocks_in_use(self) -> int:
        return self.blocks.in_use

    @property
    def accepted_rate(self) -> float:
        """Fraction of proposable draft tokens that became stream tokens
        (a slot with r tokens of budget left can propose at most r - 1)."""
        return (self.spec_accepted / self.spec_proposed
                if self.spec_proposed else 0.0)

    def attribution_info(self, task: SlotTask) -> Dict[str, Any]:
        """The admission-time placement snapshot for the attribution
        ledger: physical block table, which blocks came from the prefix
        cache, and their publisher request ids.  Read it BEFORE
        ``retire`` (which drops the snapshot with the row)."""
        info = self._attrib.get(task.slot)
        if info is None or self.tasks.get(task.slot) is not task:
            return {"layout": "paged", "slot": int(task.slot),
                    "block_ids": [], "prefix_block_ids": [],
                    "prefix_publishers": {},
                    "adapter": task.adapter,
                    "adapter_page": int(task.adapter_page)}
        return {**info, "prefix_publishers": dict(info["prefix_publishers"]),
                "block_ids": list(info["block_ids"]),
                "prefix_block_ids": list(info["prefix_block_ids"])}

    def admit(self, task: SlotTask) -> bool:
        """Claim a decode row and the request's blocks (reusing cached
        prefix blocks) and queue its chunked prefill.  Host work only.
        Returns False, task untouched, when no row is free or the pool
        cannot cover the request even after prefix-cache eviction."""
        p = len(task.prompt)
        total = p + task.max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request {task.request_id}: prompt+new = {total} exceeds "
                f"max_seq={self.max_seq}")
        slot = self.allocator.alloc()
        if slot is None:
            return False
        shared: List[int] = []
        if self.prefix is not None:
            self.prefix_lookups += 1
            t0 = time.perf_counter()
            # At least one prompt token always prefills, so the first
            # sampled token has fresh logits.
            # Reuse only K/V the same model computed: the lookup is
            # scoped by the request's adapter (None = the base model).
            shared = self.prefix.lookup(task.prompt.tolist(),
                                        (p - 1) // self.block_size,
                                        scope=task.adapter)
            if self.spans is not None:
                self.spans.add("serve.prefix_lookup", t0,
                               time.perf_counter(), kind="serve",
                               request_id=task.request_id,
                               hit=bool(shared), shared_blocks=len(shared))
        n_new = -(-total // self.block_size) - len(shared)
        fresh = self.blocks.alloc(n_new)
        if fresh is None and self.prefix is not None:
            self.prefix.evict(n_new - self.blocks.free_count)
            fresh = self.blocks.alloc(n_new)
        if fresh is None:
            for b in shared:
                self.blocks.release(b)
            self.allocator.free(slot)
            return False
        if task.adapter is not None and self.adapters is not None:
            # The second paged resource, with the KV blocks' backpressure
            # semantics: a pool whose resident pages are all live (or a
            # quarantined adapter) refuses and everything unwinds.
            page = self.adapters.acquire(task.adapter)
            if page is None:
                for b in shared + fresh:
                    self.blocks.release(b)
                self.allocator.free(slot)
                return False
            task.adapter_page = page
        if shared:
            self.prefix_hits += 1
            self.prefix_tokens_reused += len(shared) * self.block_size
        self.tables[slot] = shared + fresh
        self.lengths[slot] = 0
        task.slot = slot
        self.tasks[slot] = task
        self._attrib[slot] = {
            "layout": "paged", "slot": slot,
            "block_ids": list(shared + fresh),
            "prefix_block_ids": list(shared),
            "prefix_publishers": (self.prefix.publishers(shared)
                                  if self.prefix is not None else {}),
            "adapter": task.adapter,
            "adapter_page": int(task.adapter_page),
        }
        self._prefill[slot] = _PrefillProgress(
            task=task, pos=len(shared) * self.block_size, plen=p)
        return True

    # -- ticks ---------------------------------------------------------------

    def _table_row(self, slot: int) -> np.ndarray:
        row = np.full(self.nbps, TRASH_BLOCK, np.int32)
        t = self.tables[slot]
        row[:len(t)] = t
        return row

    def _advance_prefill(self, slot: int) -> Optional[SlotTask]:
        """Run ONE chunk for a prefilling slot; returns the task when the
        chunk completed its prompt (first token recorded)."""
        st = self._prefill[slot]
        task = st.task
        c = self.chunk
        t_chunk = time.perf_counter()
        n_real = min(st.plen - st.pos, c)
        chunk = np.zeros(c, np.int32)
        chunk[:n_real] = task.prompt[st.pos:st.pos + n_real]
        final = st.pos + n_real >= st.plen
        temp = max(task.temperature, 1e-6)
        if st.pos == 0 and st.plen <= c and task.adapter_page == ZERO_PAGE:
            # Whole prompt in one chunk, nothing shared, no adapter: the
            # dense local prefill (an adapter's prompt must run through
            # the delta'd layers, so it takes the chunk path).
            ids = np.full(c // self.block_size, TRASH_BLOCK, np.int32)
            n_ids = min(len(self.tables[slot]), len(ids))
            ids[:n_ids] = self.tables[slot][:n_ids]
            tokens, ids_dev = _device_i32(self.device, chunk, ids)
            packed = _paged_prefill_impl(
                self.cfg, self.kv, self.view, tokens.long(), st.plen,
                ids_dev.long(), task.seed, temp, task.greedy,
                self.attn_impl)
            self.local_prefills += 1
        else:
            last_idx = int(np.clip(st.plen - 1 - st.pos, 0, c - 1))
            extra = ([self._adapter_row({0: task.adapter_page}, 1)]
                     if self.adapters is not None else [])
            tokens, table, start, *pages = _device_i32(
                self.device, chunk, self._table_row(slot)[None],
                np.array([st.pos]), *extra)
            packed = _paged_chunk_impl(
                self.cfg, self.kv, self.view, tokens.long(), table, start,
                last_idx, final, task.seed, temp, task.greedy,
                self.attn_impl, self._adapter_args(pages))
            self.prefill_chunks += 1
        if self.spans is not None:
            self.spans.add("serve.prefill_chunk", t_chunk,
                           time.perf_counter(), kind="serve",
                           request_id=task.request_id, pos=int(st.pos),
                           tokens=int(n_real), final=bool(final))
        if not final:
            st.pos += c
            return None
        token, ent, margin = packed.cpu().numpy()[:, 0]
        task._record(int(token), float(ent), float(margin))
        self.prompts_prefilled += 1
        self.lengths[slot] = st.plen
        del self._prefill[slot]
        if self.prefix is not None and task.publish_prefix:
            # The prompt's full blocks are authoritative in the pool now:
            # publish them for later same-prefix requests.
            self._published[slot] = self.prefix.insert(
                task.prompt.tolist(),
                self.tables[slot][:st.plen // self.block_size],
                scope=task.adapter, publisher=task.request_id)
        return task

    def _adapter_row(self, page_by_slot: Dict[int, int],
                     rows: int) -> np.ndarray:
        """The page row of ``rows`` slots, its range checked here, on the
        host copy (B9 reads pages unchecked)."""
        row = adapter_page_row(page_by_slot, rows)
        if row.min() < 0 or row.max() > self.adapters.pages:
            raise ValueError(f"adapter page row {row.tolist()} outside "
                             f"[0, {self.adapters.pages}]")
        return row

    def _adapter_args(self, pages: List[torch.Tensor]) -> Optional[tuple]:
        """The adapter pool plus the device page row, or None when the tier
        is off."""
        if self.adapters is None:
            return None
        return (*self.adapters.device_args(), pages[0])

    def decode_tick(self) -> List[SlotTask]:
        """Advance every mid-prefill slot by one chunk, then run the decode
        step for every decode-phase slot: a speculative tick when
        ``spec_k`` > 0 and some live slot has more than one token left,
        else the fused single-token step.  Returns the tasks that received
        tokens."""
        ticked: List[SlotTask] = []
        finished_prefill = set()
        for slot in sorted(self._prefill):
            done = self._advance_prefill(slot)
            if done is not None:
                finished_prefill.add(slot)
                ticked.append(done)
        active = {s: t for s, t in self.tasks.items()
                  if s not in self._prefill and not t.done
                  and s not in finished_prefill}
        if not active:
            return ticked
        if self.spec_k > 0:
            if any(t.max_new_tokens - len(t.emitted) > 1
                   for t in active.values()):
                ticked.extend(self._spec_tick(active))
                return ticked
            # Every live slot has one token left: drafting would be waste.
            self.spec_fallback_ticks += 1
        ms = self.allocator.max_slots
        tokens = np.zeros(ms, np.int32)
        tables = np.full((ms, self.nbps), TRASH_BLOCK, np.int32)
        seeds = [0] * ms
        indices = [0] * ms
        temps = [1.0] * ms
        greedy = [True] * ms
        for slot, task in active.items():
            tokens[slot] = task.next_token
            tables[slot] = self._table_row(slot)
            seeds[slot] = task.seed
            indices[slot] = len(task.emitted)
            temps[slot] = max(task.temperature, 1e-6)
            greedy[slot] = task.greedy
        # Inactive and adapterless slots stay on the zero page.
        extra = ([self._adapter_row({s: t.adapter_page
                                     for s, t in active.items()}, ms)]
                 if self.adapters is not None else [])
        tokens_dev, tables_dev, lengths_dev, *pages = _device_i32(
            self.device, tokens, tables, self.lengths, *extra)
        with guarded(self.compilewatch, "serve_decode"):
            packed = _paged_decode_impl(
                self.cfg, self.kv, self.view, tokens_dev.long(), tables_dev,
                lengths_dev, seeds, indices, temps, greedy, self.attn_impl,
                self._adapter_args(pages))
        self.decode_ticks += 1
        host = packed.cpu().numpy()      # the tick's one device-to-host copy
        next_tok, ent, margin = host[0], host[1], host[2]
        for slot, task in active.items():
            self.lengths[slot] += 1
            task._record(int(next_tok[slot]), float(ent[slot]),
                         float(margin[slot]))
            ticked.append(task)
        return ticked

    def _spec_tick(self, active: Dict[int, SlotTask]) -> List[SlotTask]:
        """One speculative tick for every decode-phase slot: claim the
        draft window's blocks, draft ``spec_k`` tokens with the int8 view
        (chained on the device), verify every window in one model-dtype
        forward, accept per slot the longest prefix where the draft matched
        the target (a greedy mismatch under a near-tie target margin, below
        ``PARITY_MARGIN_TOL``, emits the draft token and goes on, counted
        in ``spec_near_tie_flips``), then release the claims: rejection is
        a refcount decrement plus not advancing the length past the
        accepted prefix."""
        k = self.spec_k
        ms = self.allocator.max_slots
        tokens0 = np.zeros(ms, np.int32)
        tables = np.full((ms, self.nbps), TRASH_BLOCK, np.int32)
        seeds = [0] * ms
        temps = [1.0] * ms
        greedy = [True] * ms
        # Emission index of window position i per slot: the index spec-off
        # decode would sample at (clamped at the budget; past it the
        # emissions are discarded anyway).
        indices = np.zeros((ms, k + 1), np.int64)
        proposable: Dict[int, int] = {}
        for slot, task in active.items():
            tokens0[slot] = task.next_token
            tables[slot] = self._table_row(slot)
            seeds[slot] = task.seed
            temps[slot] = max(task.temperature, 1e-6)
            greedy[slot] = task.greedy
            base = len(task.emitted)
            proposable[slot] = min(k, task.max_new_tokens - base - 1)
            indices[slot] = np.minimum(base + np.arange(k + 1),
                                       task.max_new_tokens - 1)
            claimed = blocks_for_span(
                self.tables[slot], self.block_size,
                int(self.lengths[slot]), int(self.lengths[slot]) + k + 1)
            self.blocks.claim_speculative(claimed)
            self._spec_claims[slot] = claimed
        # The verify reads the pre-draft lengths: a host copy, so no draft
        # step can move them.
        lengths0 = self.lengths.copy()
        dev = _device_i32(self.device, tokens0, tables, lengths0,
                          *[lengths0 + j for j in range(1, k)])
        cur, tables_dev, lengths_dev = dev[0].long(), dev[1], dev[2]
        draft_lengths = [lengths_dev] + dev[3:]
        t0 = time.perf_counter()
        draft_dev = []
        for j in range(k):
            with guarded(self.compilewatch, "serve_spec_draft"):
                cur = _spec_draft_impl(self.cfg, self.kv, self.draft_view,
                                       cur, tables_dev, draft_lengths[j],
                                       seeds, indices[:, j], temps, greedy,
                                       self.attn_impl)
            draft_dev.append(cur)
        # One host copy for the whole draft chain.
        drafts = torch.stack(draft_dev, dim=1).cpu().numpy()
        t1 = time.perf_counter()
        self.spec_draft_s += t1 - t0
        window = torch.cat([dev[0].long()[:, None],
                            torch.stack(draft_dev, dim=1)], dim=1)
        with guarded(self.compilewatch, "serve_spec_verify"):
            packed = _spec_verify_impl(self.cfg, self.kv, self.view, window,
                                       tables_dev, lengths_dev, seeds,
                                       indices.reshape(-1), temps, greedy,
                                       self.attn_impl)
        host = packed.cpu().numpy()                      # [3, ms, k+1]
        self.spec_verify_s += time.perf_counter() - t1
        self.spec_ticks += 1
        ticked: List[SlotTask] = []
        tick_proposed = tick_accepted = 0
        for slot, task in active.items():
            tgt, ent, margin = host[0, slot], host[1, slot], host[2, slot]
            d = drafts[slot]
            # Position i emits the TARGET token (spec-off's token: same
            # logits, same draw); the walk goes past i only when the draft
            # guessed it, so every later target was conditioned on the
            # true stream.
            accepted: List[Tuple[int, float, float]] = []
            for i in range(k + 1):
                tok = int(tgt[i])
                cont = False
                if i < k:
                    if int(d[i]) == tok:
                        cont = True
                    elif (task.greedy
                          and float(margin[i]) < q8.PARITY_MARGIN_TOL):
                        tok = int(d[i])
                        self.spec_near_tie_flips += 1
                        cont = True
                accepted.append((tok, float(ent[i]), float(margin[i])))
                if not cont:
                    break
            n_fed = 0
            for tok, e_sig, m_sig in accepted:
                task._record(tok, e_sig, m_sig)
                n_fed += 1
                if task.done:
                    break          # eos or budget: later tokens discarded
            # Positions [len, len + n_fed) now hold target K/V of the
            # emitted stream; everything past is rejected draft K/V.
            self.lengths[slot] += n_fed
            tick_proposed += proposable[slot]
            tick_accepted += max(n_fed - 1, 0)
            self.blocks.release_speculative(self._spec_claims.pop(slot, []))
            ticked.append(task)
        self.spec_proposed += tick_proposed
        self.spec_accepted += tick_accepted
        if self.spans is not None:
            self.spans.add("serve.spec_verify", t1, time.perf_counter(),
                           kind="serve", slots=len(active),
                           proposed=tick_proposed,
                           accepted=tick_accepted)
        return ticked

    # -- retirement --------------------------------------------------------

    def retire(self, task: SlotTask, quarantine: bool = False) -> None:
        """Release the task's row and drop its block references.  Under
        ``quarantine`` the blocks the task itself published leave the
        prefix cache first, then its unshared blocks are impounded with
        the row until an operator releases them.  Outstanding speculative
        claims unwind first, so a claim can never keep a suspect block
        "shared" past its owner."""
        slot = task.slot
        if slot < 0 or self.tasks.get(slot) is not task:
            return
        del self.tasks[slot]
        self._prefill.pop(slot, None)
        self._attrib.pop(slot, None)
        if task.adapter is not None and self.adapters is not None \
                and task.adapter_page != ZERO_PAGE:
            # Drop the request's reference on its adapter page; the pool's
            # own keeps it resident.  A slot quarantine does not
            # quarantine the adapter (that verdict is the adapter's own).
            self.adapters.release(task.adapter)
            task.adapter_page = ZERO_PAGE
        self.blocks.release_speculative(self._spec_claims.pop(slot, []))
        published = self._published.pop(slot, [])
        if quarantine and self.prefix is not None and published:
            self.prefix.purge(set(published))
        q_blocks: List[int] = []
        for b in self.tables[slot]:
            if self.blocks.release(b, quarantine=quarantine) \
                    == "quarantined":
                q_blocks.append(b)
        self.tables[slot] = []
        if quarantine:
            self._q_blocks_by_slot[slot] = q_blocks
            self.allocator.quarantine(slot)
            logger.warning(
                "slot %d quarantined after request %d was flagged "
                "anomalous (%d private block(s) impounded, %d slots "
                "remain in service)", slot, task.request_id, len(q_blocks),
                self.allocator.capacity)
        else:
            self.allocator.free(slot)

    def release_quarantine(self, slot: int) -> None:
        """Operator action: return a quarantined row and the blocks
        impounded with it to service."""
        self.allocator.release(slot)
        for b in self._q_blocks_by_slot.pop(slot, []):
            self.blocks.unquarantine(b)

    # -- live migration (serve/migrate.py) -----------------------------------

    def export_migration(self, task: SlotTask) -> Optional[Dict[str, Any]]:
        """Source side of a live hand-off: the decode-phase task's block
        table, committed length and admission-time placement.  None,
        nothing touched, mid-prefill or for an unknown task.  Outstanding
        speculative claims unwind first, so no unverified draft K/V
        travels (the accepted length already excludes it)."""
        slot = task.slot
        if slot < 0 or self.tasks.get(slot) is not task:
            return None
        if slot in self._prefill or not task.emitted:
            return None
        self.blocks.release_speculative(self._spec_claims.pop(slot, []))
        return {"task": task, "length": int(self.lengths[slot]),
                "block_ids": list(self.tables[slot]),
                "placement": self.attribution_info(task)}

    def claim_migration(self, n_blocks: int, adapter: Optional[str]
                        ) -> Optional[Dict[str, Any]]:
        """Destination side, CLAIM: a decode row, ``n_blocks`` fresh blocks
        (with the prefix-evict retry of ``admit``) and, for an adapter
        request, its page, all through the normal allocators.  None with
        nothing claimed on any shortage.  No prefill and no prefix sharing:
        the blocks' contents arrive by device copy."""
        slot = self.allocator.alloc()
        if slot is None:
            return None
        fresh = self.blocks.alloc(n_blocks)
        if fresh is None and self.prefix is not None:
            self.prefix.evict(n_blocks - self.blocks.free_count)
            fresh = self.blocks.alloc(n_blocks)
        if fresh is None:
            self.allocator.free(slot)
            return None
        page = ZERO_PAGE
        if adapter is not None:
            page = (self.adapters.acquire(adapter)
                    if self.adapters is not None else None)
            if page is None:
                # Adapterless destination, a pool of live pages or a
                # quarantined adapter: unwind everything.
                for b in fresh:
                    self.blocks.release(b)
                self.allocator.free(slot)
                return None
        return {"slot": slot, "block_ids": list(fresh), "adapter": adapter,
                "adapter_page": int(page)}

    def abort_migration(self, claim: Dict[str, Any]) -> None:
        """Unwind a claim that never committed: the exact inverse of
        :meth:`claim_migration`."""
        if claim.get("adapter") is not None and self.adapters is not None:
            self.adapters.release(claim["adapter"])
        for b in claim["block_ids"]:
            self.blocks.release(b)
        self.allocator.free(claim["slot"])

    def commit_migration(self, task: SlotTask, claim: Dict[str, Any],
                         length: int,
                         migrated_from: Optional[Dict[str, Any]] = None
                         ) -> None:
        """COMMIT: register the migrated task on the claimed row (host
        bookkeeping only; the block copy has landed).  The placement names
        the destination's blocks; ``migrated_from`` (the source blocks and
        journal) rides it for ``verify_attribution``."""
        slot = claim["slot"]
        task.slot = slot
        task.adapter_page = int(claim["adapter_page"])
        self.tables[slot] = list(claim["block_ids"])
        self.lengths[slot] = int(length)
        self.tasks[slot] = task
        info: Dict[str, Any] = {
            "layout": "paged", "slot": slot,
            "block_ids": list(claim["block_ids"]),
            "prefix_block_ids": [], "prefix_publishers": {},
            "adapter": task.adapter,
            "adapter_page": int(claim["adapter_page"]),
        }
        if migrated_from is not None:
            info["migrated_from"] = dict(migrated_from)
        self._attrib[slot] = info
