"""The paged KV pool and its host-side bookkeeping.

Counterpart of the paged half of ``trustworthy_dl_tpu/serve/kv_slots.py``
(the stripe pool ``SlotKV``/``init_slots`` is not ported yet).

Layout ``[L, NUM_BLOCKS + 1, H, BLOCK, Dh]`` per K and V, physical block 0
reserved as the trash block: inactive decode rows and padded prefill tails
write there, never into a block another request could own.  Per-slot block
tables are host lists of physical ids; the ``BlockAllocator`` keeps
reference counts so prompt prefixes shared through the radix
``PrefixCache`` free only when their last holder lets go, and the
quarantine set impounds the private blocks of a flagged request.  A
request only ever writes blocks it owns alone, so sharing needs no copy.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import torch

from trustworthy_dl_tpu_torch.models import gpt2

#: Physical block reserved as the sink for garbage writes; never handed out.
TRASH_BLOCK = 0


class PagedKV(NamedTuple):
    """Block-pooled K/V: ``[L, NUM_BLOCKS + 1, H, BLOCK, Dh]`` each."""

    k: torch.Tensor
    v: torch.Tensor

    @property
    def num_blocks(self) -> int:
        """Usable blocks (the trash block excluded)."""
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[3]


def kv_bytes_per_token(cfg: gpt2.GPT2Config) -> int:
    """Bytes one cached position costs in the model-dtype pool (K and V,
    every layer and head)."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return 2 * cfg.n_layer * cfg.n_head * cfg.head_dim * itemsize


def validate_paged_geometry(max_seq: int, block_size: int,
                            num_blocks: Optional[int],
                            prefill_chunk: Optional[int]) -> None:
    """Loud validation of the paged-pool knobs."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    if max_seq % block_size != 0:
        raise ValueError(
            f"max_seq={max_seq} must be a multiple of block_size="
            f"{block_size} (the paged pool addresses whole blocks)")
    if num_blocks is not None and num_blocks < max_seq // block_size:
        raise ValueError(
            f"num_blocks={num_blocks} cannot hold even one full sequence "
            f"(max_seq={max_seq} needs {max_seq // block_size} blocks of "
            f"{block_size})")
    if prefill_chunk is not None and (
            prefill_chunk % block_size != 0
            or not block_size <= prefill_chunk <= max_seq):
        raise ValueError(
            f"prefill_chunk={prefill_chunk} must be a multiple of "
            f"block_size={block_size} in [{block_size}, {max_seq}]")


def resolve_prefill_chunk(max_seq: int, block_size: int,
                          prefill_chunk: Optional[int]) -> int:
    """``None`` -> 64 positions rounded down to a block multiple, clamped
    to ``max_seq``; explicit values were validated already."""
    if prefill_chunk is not None:
        return prefill_chunk
    return max(block_size, (min(64, max_seq) // block_size) * block_size)


def init_paged_pool(cfg: gpt2.GPT2Config, num_blocks: int, block_size: int,
                    device: Any = "cpu") -> PagedKV:
    """Allocate ``num_blocks`` usable blocks (+1 trash) of zeros in the
    model dtype."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    if block_size > cfg.n_positions:
        raise ValueError(f"block_size={block_size} exceeds the model's "
                         f"position table (n_positions={cfg.n_positions})")
    shape = (cfg.n_layer, num_blocks + 1, cfg.n_head, block_size,
             cfg.head_dim)
    return PagedKV(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device))


class SlotAllocator:
    """Decode rows: a LIFO free list plus a quarantine set.  A quarantined
    row leaves service until an operator releases it."""

    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self._free: List[int] = list(range(max_slots - 1, -1, -1))
        self._quarantined: Set[int] = set()

    def alloc(self) -> Optional[int]:
        """Claim a free row, or None when every row is taken."""
        return self._free.pop() if self._free else None

    def free(self, slot: int) -> None:
        if slot in self._quarantined:
            return
        if slot in self._free or not 0 <= slot < self.max_slots:
            raise ValueError(f"double free / bad slot {slot}")
        self._free.append(slot)

    def quarantine(self, slot: int) -> None:
        self._quarantined.add(slot)
        if slot in self._free:
            self._free.remove(slot)

    def release(self, slot: int) -> None:
        """Operator action: return a quarantined row to service."""
        if slot in self._quarantined:
            self._quarantined.discard(slot)
            self._free.append(slot)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def quarantined(self) -> Set[int]:
        return set(self._quarantined)

    @property
    def capacity(self) -> int:
        """Rows in service (total minus quarantined)."""
        return self.max_slots - len(self._quarantined)


class BlockAllocator:
    """Physical blocks: LIFO free list over ids [1, num_blocks], reference
    counts and a quarantine set."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._ref: Dict[int, int] = {}
        self._quarantined: Set[int] = set()

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` blocks at refcount 1, or None when the pool cannot
        (backpressure, not an error)."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, block: int) -> None:
        if block not in self._ref:
            raise ValueError(f"incref of unallocated block {block}")
        self._ref[block] += 1

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def release(self, block: int, quarantine: bool = False) -> str:
        """Drop one reference: ``"shared"`` (other holders remain),
        ``"freed"``, or ``"quarantined"`` (last holder was flagged)."""
        if self._ref.get(block, 0) <= 0:
            raise ValueError(f"double free / bad block {block}")
        self._ref[block] -= 1
        if self._ref[block] > 0:
            return "shared"
        del self._ref[block]
        if quarantine:
            self._quarantined.add(block)
            return "quarantined"
        self._free.append(block)
        return "freed"

    def unquarantine(self, block: int) -> None:
        if block in self._quarantined:
            self._quarantined.discard(block)
            self._free.append(block)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Blocks referenced by requests and/or the prefix cache."""
        return len(self._ref)

    @property
    def quarantined(self) -> Set[int]:
        return set(self._quarantined)


def blocks_for_span(table: Sequence[int], block_size: int, start: int,
                    end: int) -> List[int]:
    """Distinct physical blocks backing logical positions [start, end) of
    a slot's table (trash and unallocated positions contribute nothing)."""
    out: List[int] = []
    for lb in range(start // block_size, -(-end // block_size)):
        if lb < len(table) and table[lb] != TRASH_BLOCK \
                and table[lb] not in out:
            out.append(table[lb])
    return out


class PrefixCache:
    """Radix cache over FULL prompt blocks.  A node is keyed by (parent
    node id, its one-block token segment) and holds a physical block on
    which the cache keeps a reference, so a retired request's prompt
    blocks stay resident for later requests with the same prefix.
    Lookups incref what they match for the caller; eviction is LRU over
    leaves whose block has no other holder."""

    def __init__(self, block_size: int, blocks: BlockAllocator):
        self.block_size = block_size
        self._blocks = blocks
        # key -> [block id, last-used tick, node id, cached-child count]
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], List[Any]] = {}
        self._by_id: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        self._next_id = 1
        self._clock = 0

    def _bump(self) -> int:
        self._clock += 1
        return self._clock

    def _segment(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        return tuple(tokens[i * self.block_size:(i + 1) * self.block_size])

    def __len__(self) -> int:
        return len(self._nodes)

    def lookup(self, tokens: Sequence[int], max_blocks: int) -> List[int]:
        """Longest cached full-block prefix of ``tokens`` (at most
        ``max_blocks`` blocks), each matched block increffed."""
        out: List[int] = []
        parent = 0
        for i in range(max_blocks):
            node = self._nodes.get((parent, self._segment(tokens, i)))
            if node is None:
                break
            node[1] = self._bump()
            out.append(node[0])
            parent = node[2]
        for b in out:
            self._blocks.incref(b)
        return out

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]
               ) -> List[int]:
        """Cache ``tokens``' full blocks (backed by ``block_ids``);
        returns the newly cached ids."""
        n = min(len(tokens) // self.block_size, len(block_ids))
        added: List[int] = []
        parent = 0
        for i in range(n):
            key = (parent, self._segment(tokens, i))
            node = self._nodes.get(key)
            if node is not None:
                node[1] = self._bump()
                parent = node[2]
                continue
            nid = self._next_id
            self._next_id += 1
            self._nodes[key] = [block_ids[i], self._bump(), nid, 0]
            self._by_id[nid] = key
            self._blocks.incref(block_ids[i])
            if parent:
                self._nodes[self._by_id[parent]][3] += 1
            added.append(block_ids[i])
            parent = nid
        return added

    def _remove(self, key: Tuple[int, Tuple[int, ...]]) -> List[int]:
        block, _, nid, _ = self._nodes.pop(key)
        del self._by_id[nid]
        if key[0] and key[0] in self._by_id:
            self._nodes[self._by_id[key[0]]][3] -= 1
        return [block, nid]

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cached blocks, LRU leaves first,
        skipping blocks a live request still holds; returns how many."""
        heap = [(node[1], key) for key, node in self._nodes.items()
                if node[3] == 0]
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_blocks:
            _, key = heapq.heappop(heap)
            node = self._nodes.get(key)
            if node is None or node[3] != 0:
                continue
            if self._blocks.refcount(node[0]) != 1:
                continue
            block, _ = self._remove(key)
            if key[0] and key[0] in self._by_id:
                parent_key = self._by_id[key[0]]
                parent = self._nodes[parent_key]
                if parent[3] == 0:
                    heapq.heappush(heap, (parent[1], parent_key))
            self._blocks.release(block)
            freed += 1
        return freed

    def purge(self, block_ids: Set[int]) -> int:
        """Drop every node backed by one of ``block_ids`` and the subtrees
        under them (the quarantine hook); returns nodes removed."""
        doomed = [key for key, node in self._nodes.items()
                  if node[0] in block_ids]
        removed = 0
        while doomed:
            key = doomed.pop()
            if key not in self._nodes:
                continue
            block, nid = self._remove(key)
            doomed.extend(k for k in self._nodes if k[0] == nid)
            self._blocks.release(block)
            removed += 1
        return removed
