"""Continuous (iteration-level) batching over the paged KV pool.

Counterpart of the paged half of ``trustworthy_dl_tpu/serve/scheduler.py``.
Each engine tick advances every mid-prefill slot by one chunk, then runs
one fused decode step for every decode-phase slot.  Three device programs,
as in the JAX package:

* ``_paged_prefill_impl``: a prompt that fits one chunk with no prefix
  hit runs through a full-precision local dense cache (plain torch ops,
  no kernel), and its K/V are scattered into the pool block-wise;
* ``_paged_chunk_impl``: one chunk of a longer prompt, or the suffix of a
  prefix-cache hit, attends through the pool (B6 on the kernel path);
* ``_paged_decode_impl``: one token for every decode row, live or not
  (inactive rows point at the trash block), through B5.

The trust signals of every first token and every decode tick come from
``_logit_signals`` (B7 on the kernel path).  Host-facing outputs ride one
packed f32 [3, B] tensor, one device-to-host copy per program.

Sampling is per slot: greedy rows take the argmax, sampled rows one draw
from their request's own ``torch.Generator`` (the counterpart of the JAX
per-request key stream, whose threefry draws the port does not
reproduce).  Speculative decoding, adapters, migration, the stripe
scheduler and the compile watcher are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from trustworthy_dl_tpu_torch.models import generate as gen
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.serve.kv_slots import (
    TRASH_BLOCK,
    BlockAllocator,
    PagedKV,
    PrefixCache,
    SlotAllocator,
    init_paged_pool,
    resolve_prefill_chunk,
    validate_paged_geometry,
)

logger = logging.getLogger(__name__)


def _sample_tokens(logits: torch.Tensor,
                   generators: Sequence[Optional[torch.Generator]],
                   temps: Sequence[float], greedy: Sequence[bool]
                   ) -> torch.Tensor:
    """[B, V] -> [B]: argmax for greedy rows, one draw from
    softmax(logits / temp) with the row's generator for the others."""
    tokens = logits.argmax(dim=-1)
    for i, is_greedy in enumerate(greedy):
        if not is_greedy:
            probs = torch.softmax(logits[i] / max(temps[i], 1e-6), dim=-1)
            tokens[i] = torch.multinomial(probs, 1,
                                          generator=generators[i])[0]
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
                   real_len: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the blocks over the padded prompt [C] through a full-precision
    local cache; returns (logits at ``real_len - 1`` [1, V], local K,
    local V [L, 1, H, C, Dh])."""
    local = gen.init_cache(cfg, 1, tokens.shape[0], tokens.device)
    logits, local = gen._apply_with_cache(view, tokens[None], local, cfg,
                                          last_pos=real_len - 1)
    return logits, local.k, local.v


def _sample_pack(logits: torch.Tensor,
                 generator: Optional[torch.Generator], temp: float,
                 greedy: bool, attn_impl: str) -> torch.Tensor:
    """Single-slot tail: first token + trust signals, packed [3, 1]."""
    token = _sample_tokens(logits, [generator], [temp], [greedy])
    entropy, margin = _logit_signals(logits, attn_impl)
    return _pack_step_outputs(token, entropy, margin)


def _paged_prefill_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                        tokens: torch.Tensor, real_len: int,
                        block_ids: torch.Tensor,
                        generator: Optional[torch.Generator], temp: float,
                        greedy: bool, attn_impl: str) -> torch.Tensor:
    """Whole-prompt prefill into the pool: the local-cache prologue, then
    the local K/V re-laid out block-wise and written at ``block_ids``
    (entries past the slot's allocation point at the trash block)."""
    c = tokens.shape[0]
    bsz = kv.block_size
    logits, k_rows, v_rows = _local_prefill(cfg, view, tokens, real_len)

    def to_blocks(a: torch.Tensor) -> torch.Tensor:
        l, _, h, _, dh = a.shape                   # [L, 1, H, C, Dh]
        a = a[:, 0].permute(0, 2, 1, 3).reshape(l, c // bsz, bsz, h, dh)
        return a.permute(0, 1, 3, 2, 4).to(kv.k.dtype)

    kv.k[:, block_ids] = to_blocks(k_rows)
    kv.v[:, block_ids] = to_blocks(v_rows)
    return _sample_pack(logits, generator, temp, greedy, attn_impl)


def _paged_chunk_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                      tokens: torch.Tensor, table: torch.Tensor,
                      start: torch.Tensor, last_idx: int, final: bool,
                      generator: Optional[torch.Generator], temp: float,
                      greedy: bool, attn_impl: str
                      ) -> Optional[torch.Tensor]:
    """One chunk of a paged prefill: C prompt positions from ``start``
    (i32 [1]) attending to everything already in the slot's blocks and
    writing their own K/V.  Only the prompt's final chunk projects logits
    and samples (the JAX program computes them on every chunk and the
    host drops them; here the host knows which chunk is final)."""
    out = gen._apply_with_cache_paged(
        view, tokens[None], kv.k, kv.v, table, start, cfg,
        last_pos=last_idx, attn_impl=attn_impl, hidden=not final)
    if not final:
        return None
    return _sample_pack(out, generator, temp, greedy, attn_impl)


def _paged_decode_impl(cfg: gpt2.GPT2Config, kv: PagedKV, view: Any,
                       tokens: torch.Tensor, tables: torch.Tensor,
                       lengths: torch.Tensor,
                       generators: Sequence[Optional[torch.Generator]],
                       temps: Sequence[float], greedy: Sequence[bool],
                       attn_impl: str) -> torch.Tensor:
    """The fused paged decode step: one token for every row; returns the
    packed [3, MAX_SLOTS] outputs."""
    logits = gen._apply_with_cache_paged(view, tokens[:, None], kv.k, kv.v,
                                         tables, lengths, cfg,
                                         attn_impl=attn_impl)
    next_tok = _sample_tokens(logits, generators, temps, greedy)
    entropy, margin = _logit_signals(logits, attn_impl)
    return _pack_step_outputs(next_tok, entropy, margin)


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
    generator: Optional[torch.Generator] = None   # None for greedy
    eos_id: Optional[int] = None
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
    per tick, interleaved with the fused decode step.  Host state: per
    slot lengths and block tables (numpy/lists), the task table and the
    allocators.  Device state: the pool, updated in place."""

    def __init__(self, params: Any, cfg: gpt2.GPT2Config, max_slots: int,
                 max_seq: int, device: torch.device,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 attn_impl: str = "kernel", view: Any = None):
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
        self.view = view if view is not None else gen._decode_view(params,
                                                                   cfg)
        self.block_size = block_size
        self.nbps = max_seq // block_size
        self.num_blocks = (num_blocks if num_blocks is not None
                           else max_slots * self.nbps)
        self.chunk = resolve_prefill_chunk(max_seq, block_size,
                                           prefill_chunk)
        self.kv = init_paged_pool(cfg, self.num_blocks, block_size, device)
        self.allocator = SlotAllocator(max_slots)
        self.blocks = BlockAllocator(self.num_blocks)
        self.prefix = (PrefixCache(block_size, self.blocks)
                       if prefix_cache else None)
        self.max_seq = max_seq
        self.lengths = np.zeros(max_slots, np.int32)
        self.tables: List[List[int]] = [[] for _ in range(max_slots)]
        self.tasks: Dict[int, SlotTask] = {}       # slot -> task
        self._prefill: Dict[int, _PrefillProgress] = {}
        self._q_blocks_by_slot: Dict[int, List[int]] = {}
        self._published: Dict[int, List[int]] = {}
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_tokens_reused = 0
        self.decode_ticks = 0
        self.local_prefills = 0
        self.prefill_chunks = 0

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
            # At least one prompt token always prefills, so the first
            # sampled token has fresh logits.
            shared = self.prefix.lookup(task.prompt.tolist(),
                                        (p - 1) // self.block_size)
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
        if shared:
            self.prefix_hits += 1
            self.prefix_tokens_reused += len(shared) * self.block_size
        self.tables[slot] = shared + fresh
        self.lengths[slot] = 0
        task.slot = slot
        self.tasks[slot] = task
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
        n_real = min(st.plen - st.pos, c)
        chunk = np.zeros(c, np.int32)
        chunk[:n_real] = task.prompt[st.pos:st.pos + n_real]
        final = st.pos + n_real >= st.plen
        temp = max(task.temperature, 1e-6)
        if st.pos == 0 and st.plen <= c:
            # Whole prompt in one chunk, nothing shared: the dense local
            # prefill.
            ids = np.full(c // self.block_size, TRASH_BLOCK, np.int32)
            n_ids = min(len(self.tables[slot]), len(ids))
            ids[:n_ids] = self.tables[slot][:n_ids]
            tokens, ids_dev = _device_i32(self.device, chunk, ids)
            packed = _paged_prefill_impl(
                self.cfg, self.kv, self.view, tokens.long(), st.plen,
                ids_dev.long(), task.generator, temp, task.greedy,
                self.attn_impl)
            self.local_prefills += 1
        else:
            last_idx = int(np.clip(st.plen - 1 - st.pos, 0, c - 1))
            tokens, table, start = _device_i32(
                self.device, chunk, self._table_row(slot)[None],
                np.array([st.pos]))
            packed = _paged_chunk_impl(
                self.cfg, self.kv, self.view, tokens.long(), table, start,
                last_idx, final, task.generator, temp, task.greedy,
                self.attn_impl)
            self.prefill_chunks += 1
        if not final:
            st.pos += c
            return None
        token, ent, margin = packed.cpu().numpy()[:, 0]
        task._record(int(token), float(ent), float(margin))
        self.lengths[slot] = st.plen
        del self._prefill[slot]
        if self.prefix is not None:
            # The prompt's full blocks are authoritative in the pool now:
            # publish them for later same-prefix requests.
            self._published[slot] = self.prefix.insert(
                task.prompt.tolist(),
                self.tables[slot][:st.plen // self.block_size])
        return task

    def decode_tick(self) -> List[SlotTask]:
        """Advance every mid-prefill slot by one chunk, then run the fused
        decode step for every decode-phase slot.  Returns the tasks that
        received a token."""
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
        ms = self.allocator.max_slots
        tokens = np.zeros(ms, np.int32)
        tables = np.full((ms, self.nbps), TRASH_BLOCK, np.int32)
        generators: List[Optional[torch.Generator]] = [None] * ms
        temps = [1.0] * ms
        greedy = [True] * ms
        for slot, task in active.items():
            tokens[slot] = task.next_token
            tables[slot] = self._table_row(slot)
            generators[slot] = task.generator
            temps[slot] = max(task.temperature, 1e-6)
            greedy[slot] = task.greedy
        tokens_dev, tables_dev, lengths_dev = _device_i32(
            self.device, tokens, tables, self.lengths)
        packed = _paged_decode_impl(
            self.cfg, self.kv, self.view, tokens_dev.long(), tables_dev,
            lengths_dev, generators, temps, greedy, self.attn_impl)
        self.decode_ticks += 1
        host = packed.cpu().numpy()      # the tick's one device-to-host copy
        next_tok, ent, margin = host[0], host[1], host[2]
        for slot, task in active.items():
            self.lengths[slot] += 1
            task._record(int(next_tok[slot]), float(ent[slot]),
                         float(margin[slot]))
            ticked.append(task)
        return ticked

    # -- retirement --------------------------------------------------------

    def retire(self, task: SlotTask, quarantine: bool = False) -> None:
        """Release the task's row and drop its block references.  Under
        ``quarantine`` the blocks the task itself published leave the
        prefix cache first, then its unshared blocks are impounded with
        the row until an operator releases them."""
        slot = task.slot
        if slot < 0 or self.tasks.get(slot) is not task:
            return
        del self.tasks[slot]
        self._prefill.pop(slot, None)
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
