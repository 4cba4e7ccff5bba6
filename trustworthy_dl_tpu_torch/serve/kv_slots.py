"""The KV pools of the serving engine and their host-side bookkeeping.

Counterpart of ``trustworthy_dl_tpu/serve/kv_slots.py``: the legacy
stripe pool (``SlotKV``, ``init_slots``) and the paged pool (the default).

The stripe pool holds one cache SLOT per in-flight sequence,
``[L, MAX_SLOTS, H, MAX_SEQ, Dh]`` per K and V (int8 tier: f32 scale
planes ``[L, MAX_SLOTS, H, MAX_SEQ]`` beside them), with the per-slot
lengths on the host.  A freed slot's rows are not scrubbed: the decode
step keeps writing at the stale slot's position, but a slot is reused only
after its prefill rewrites positions [0, prompt), and a row attends only
to positions it has written.

The paged pool's layout is ``[L, NUM_BLOCKS + 1, H, BLOCK, Dh]`` per K and
V, physical block 0 reserved as the trash block: inactive decode rows and
padded prefill tails write there, never into a block another request could
own.  Per-slot block tables are host lists of physical ids; the
``BlockAllocator`` keeps
reference counts so prompt prefixes shared through the radix
``PrefixCache`` free only when their last holder lets go, and the
quarantine set impounds the private blocks of a flagged request.  A
request only ever writes blocks it owns alone, so sharing needs no copy.
The int8 tier pages f32 per-(head, position) scales ``[L, NUM_BLOCKS + 1,
H, BLOCK]`` beside the int8 values, block for block.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Sequence, \
    Set, Tuple

import torch

from trustworthy_dl_tpu_torch.models import gpt2

#: Physical block reserved as the sink for garbage writes; never handed out.
TRASH_BLOCK = 0

#: Entries kept in a block allocator's lifecycle journal (JAX's default).
JOURNAL_CAPACITY = 65536


class SlotKV(NamedTuple):
    """Slot-pooled K/V ``[L, MAX_SLOTS, H, MAX_SEQ, Dh]`` each; on the
    int8 tier ``k_scale``/``v_scale`` ``[L, MAX_SLOTS, H, MAX_SEQ]``.
    Lengths live on the host (the scheduler)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_slots(self) -> int:
        return self.k.shape[1]

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def pool_bytes(self) -> int:
        """Device bytes the pool holds (values + scales): what
        ``tddl_serve_kv_bytes`` reports."""
        total = self.k.nbytes + self.v.nbytes
        if self.k_scale is not None:
            total += self.k_scale.nbytes + self.v_scale.nbytes
        return total

    @property
    def bytes_per_slot(self) -> int:
        return self.pool_bytes // self.max_slots


class PagedKV(NamedTuple):
    """Block-pooled K/V: ``[L, NUM_BLOCKS + 1, H, BLOCK, Dh]`` each; on the
    int8 tier ``k_scale``/``v_scale`` ``[L, NUM_BLOCKS + 1, H, BLOCK]``."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def num_blocks(self) -> int:
        """Usable blocks (the trash block excluded)."""
        return self.k.shape[1] - 1

    @property
    def block_size(self) -> int:
        return self.k.shape[3]

    @property
    def pool_bytes(self) -> int:
        """Device bytes the pool holds (values + scales, the trash block
        included): what ``tddl_serve_kv_bytes`` reports."""
        total = self.k.nbytes + self.v.nbytes
        if self.k_scale is not None:
            total += self.k_scale.nbytes + self.v_scale.nbytes
        return total

    @property
    def bytes_per_block(self) -> int:
        """Device bytes of one block (values + scales)."""
        return self.pool_bytes // (self.num_blocks + 1)


def kv_bytes_per_token(cfg: gpt2.GPT2Config,
                       dtype: Optional[torch.dtype] = None) -> int:
    """Bytes one cached position costs (K and V, every layer and head) in a
    pool of ``dtype`` (default the compute dtype); int8 counts one byte an
    element plus the 4-byte per-(head, position) scale."""
    dtype = cfg.dtype if dtype is None else dtype
    heads = cfg.n_layer * cfg.n_head
    if dtype == torch.int8:
        return 2 * heads * (cfg.head_dim + 4)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * heads * cfg.head_dim * itemsize


def kv_bytes_per_slot(cfg: gpt2.GPT2Config, max_seq: int,
                      dtype: Optional[torch.dtype] = None) -> int:
    """Bytes one stripe slot costs: ``max_seq`` cached positions."""
    return max_seq * kv_bytes_per_token(cfg, dtype)


def paged_pool_blocks(cfg: gpt2.GPT2Config, hbm_bytes: int, block_size: int,
                      kv_dtype: Optional[torch.dtype] = None) -> int:
    """The most usable blocks whose paged pool, the trash block included,
    fits in ``hbm_bytes``: how an equal-memory comparison sizes a pool."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    per_block = block_size * kv_bytes_per_token(cfg, kv_dtype)
    return max(int(hbm_bytes // per_block) - 1, 0)


def init_slots(cfg: gpt2.GPT2Config, max_slots: int, max_seq: int,
               device: Any = "cpu",
               kv_dtype: Optional[torch.dtype] = None) -> SlotKV:
    """Allocate the stripe pool: zeros in ``kv_dtype`` (default the model
    dtype); ``torch.int8`` adds zero scale planes, so an untouched row
    dequantizes to exact zeros."""
    if max_seq > cfg.n_positions:
        raise ValueError(
            f"max_seq={max_seq} exceeds the model's position table "
            f"(n_positions={cfg.n_positions})")
    kv_dtype = cfg.dtype if kv_dtype is None else kv_dtype
    shape = (cfg.n_layer, max_slots, cfg.n_head, max_seq, cfg.head_dim)
    pool = SlotKV(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                  v=torch.zeros(shape, dtype=kv_dtype, device=device))
    if kv_dtype == torch.int8:
        return pool._replace(
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
    return pool


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
                    device: Any = "cpu",
                    kv_dtype: Optional[torch.dtype] = None) -> PagedKV:
    """Allocate ``num_blocks`` usable blocks (+1 trash) of zeros in
    ``kv_dtype`` (default the model dtype); ``torch.int8`` adds zero scale
    planes (one tensor each: the port writes them in place)."""
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    if block_size > cfg.n_positions:
        raise ValueError(f"block_size={block_size} exceeds the model's "
                         f"position table (n_positions={cfg.n_positions})")
    kv_dtype = cfg.dtype if kv_dtype is None else kv_dtype
    shape = (cfg.n_layer, num_blocks + 1, cfg.n_head, block_size,
             cfg.head_dim)
    pool = PagedKV(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                   v=torch.zeros(shape, dtype=kv_dtype, device=device))
    if kv_dtype == torch.int8:
        return pool._replace(
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
    return pool


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
    counts and a quarantine set, with the lifecycle evidence
    ``obs.attribution.verify_attribution`` reads: ``journal``, a bounded
    ring of (op, block, seq[, outcome]) tuples, and ``lifetime``, exact
    cumulative per-block op counts (bounded by the pool size, so a
    long-pinned block's alloc never rotates out of the evidence)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks, 0, -1))
        self._ref: Dict[int, int] = {}
        self._quarantined: Set[int] = set()
        self.journal: Deque[tuple] = deque(maxlen=JOURNAL_CAPACITY)
        self._journal_seq = 0
        self.lifetime: Dict[int, Dict[str, int]] = {}

    def _journal_add(self, op: str, block: int, *extra: Any) -> None:
        self._journal_seq += 1
        self.journal.append((op, block, self._journal_seq, *extra))
        counts = self.lifetime.setdefault(
            block, {"alloc": 0, "incref": 0, "release": 0,
                    "unquarantine": 0})
        counts[op] += 1

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
            self._journal_add("alloc", b)
        return out

    def incref(self, block: int) -> None:
        if block not in self._ref:
            raise ValueError(f"incref of unallocated block {block}")
        self._ref[block] += 1
        self._journal_add("incref", block)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def release(self, block: int, quarantine: bool = False) -> str:
        """Drop one reference: ``"shared"`` (other holders remain),
        ``"freed"``, or ``"quarantined"`` (last holder was flagged)."""
        if self._ref.get(block, 0) <= 0:
            raise ValueError(f"double free / bad block {block}")
        self._ref[block] -= 1
        if self._ref[block] > 0:
            self._journal_add("release", block, "shared")
            return "shared"
        del self._ref[block]
        if quarantine:
            self._quarantined.add(block)
            self._journal_add("release", block, "quarantined")
            return "quarantined"
        self._free.append(block)
        self._journal_add("release", block, "freed")
        return "freed"

    def unquarantine(self, block: int) -> None:
        if block in self._quarantined:
            self._quarantined.discard(block)
            self._free.append(block)
            self._journal_add("unquarantine", block)

    def claim_speculative(self, blocks: Sequence[int]) -> None:
        """Pin the blocks a speculative draft window is about to write: one
        extra reference each, so while un-verified draft K/V sits in them
        no eviction can see them as single-holder-free."""
        for b in blocks:
            self.incref(b)

    def release_speculative(self, blocks: Sequence[int]) -> None:
        """Drop the speculative claims after the verify pass: the rollback.
        Rejected positions lie past the accepted length, are causally
        invisible and are overwritten by the next write."""
        for b in blocks:
            self.release(b)

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
    leaves whose block has no other holder.

    Every tree hangs from the root of a ``scope``: the model that computed
    its K/V.  Base-model requests use ``None`` (root 0); a request served
    through an adapter uses the adapter's id, so it only ever reuses K/V
    that the same adapter computed.  (The JAX cache keys by tokens alone,
    ``trustworthy_dl_tpu/serve/scheduler.py:987-997``: there an adapter
    request can take a base model's prefix, whose K/V past layer 0 differ,
    and publish its own for other tenants.)"""

    def __init__(self, block_size: int, blocks: BlockAllocator):
        self.block_size = block_size
        self._blocks = blocks
        # key -> [block id, last-used tick, node id, cached-child count]
        self._nodes: Dict[Tuple[int, Tuple[int, ...]], List[Any]] = {}
        self._by_id: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        # scope -> root id; adapter scopes get negative ids, never node ids.
        self._roots: Dict[Optional[str], int] = {None: 0}
        # block id -> the request id that PUBLISHED it (attribution: a
        # prefix hit records whose prefill it is trusting).
        self._publisher: Dict[int, int] = {}
        self._next_id = 1
        self._clock = 0

    def _bump(self) -> int:
        self._clock += 1
        return self._clock

    def _segment(self, tokens: Sequence[int], i: int) -> Tuple[int, ...]:
        return tuple(tokens[i * self.block_size:(i + 1) * self.block_size])

    def __len__(self) -> int:
        return len(self._nodes)

    def _root(self, scope: Optional[str]) -> int:
        if scope not in self._roots:
            self._roots[scope] = -len(self._roots)
        return self._roots[scope]

    def lookup(self, tokens: Sequence[int], max_blocks: int,
               scope: Optional[str] = None) -> List[int]:
        """Longest cached full-block prefix of ``tokens`` (at most
        ``max_blocks`` blocks) under ``scope``, each matched block
        increffed."""
        out: List[int] = []
        parent = self._roots.get(scope)
        for i in range(max_blocks if parent is not None else 0):
            node = self._nodes.get((parent, self._segment(tokens, i)))
            if node is None:
                break
            node[1] = self._bump()
            out.append(node[0])
            parent = node[2]
        for b in out:
            self._blocks.incref(b)
        return out

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int],
               scope: Optional[str] = None,
               publisher: Optional[int] = None) -> List[int]:
        """Cache ``tokens``' full blocks (backed by ``block_ids``) under
        ``scope``, remembering ``publisher`` (the owning request id) per
        newly cached block; returns the newly cached ids."""
        n = min(len(tokens) // self.block_size, len(block_ids))
        added: List[int] = []
        parent = self._root(scope)
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
            if publisher is not None:
                self._publisher[block_ids[i]] = publisher
            if parent > 0:
                self._nodes[self._by_id[parent]][3] += 1
            added.append(block_ids[i])
            parent = nid
        return added

    def publishers(self, block_ids: Sequence[int]) -> Dict[int, int]:
        """Publisher request id per cached block (blocks with no recorded
        publisher are omitted)."""
        return {b: self._publisher[b] for b in block_ids
                if b in self._publisher}

    def _remove(self, key: Tuple[int, Tuple[int, ...]]) -> List[int]:
        block, _, nid, _ = self._nodes.pop(key)
        self._publisher.pop(block, None)
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
