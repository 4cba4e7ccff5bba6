"""Paged multi-tenant adapter pool: the second paged device resource.

Counterpart of ``trustworthy_dl_tpu/serve/adapters.py``.  Per-tenant rank-r
low-rank deltas ("adapters") on the attention output and the MLP live in
one pool tensor per side, on the engine's device::

    a        [L, P+1, 2, D, r]   down-projections (sites: 0 = attention
    b        [L, P+1, 2, r, D]   output, 1 = MLP), page 0 reserved as the
                                 ZERO page, the adapter-off identity
    a_scale  [L, P+1, 2]         int8 tier only: per-(layer, page, site)
    b_scale  [L, P+1, 2]         f32 dequant scales, 1.0 where unwritten

Each serve forward adds, per row, ``(site_x @ A[page]) @ B[page]`` at both
sites, the page coming from the per-slot adapter-page row
(:func:`adapter_page_row`); on the kernel path B9
(``ops.paged_attention.adapter_delta``) reads the pages straight from the
pool, on the plain path the pages are gathered and go through
``ops.fused_dequant_matmul.lowrank_delta``.  Residency changes write one
page in place (:meth:`AdapterPool._upload`).

Host side, :class:`AdapterPool` runs the same lifecycle as the JAX pool
over the port's ``kv_slots.BlockAllocator``: the pool holds one reference
on every resident page, each admitted request one more; LRU eviction
considers only pages at refcount 1 (no live request); a quarantined
adapter's page is impounded through ``release(quarantine=True)`` when its
last request drains.  Adapter weights are materialised deterministically
from the adapter id (:func:`materialize_adapter`), bit for bit the JAX
package's draws.  As in JAX, every residency change is an
``adapter_swap`` trace event and the engine binds the pool's pages-in-use
gauge and evictions counter.  The pool's partition specs
(:func:`adapter_partition_specs`) replicate it, as the KV pool is.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.serve.kv_slots import BlockAllocator

#: Reserved all-zeros pool page: slots without an adapter point here and
#: receive an exactly-zero delta.
ZERO_PAGE = 0

#: The two delta injection sites, in pool-axis order.
SITE_ATTN_OUT = 0
SITE_MLP = 1

#: Default init scale of materialised adapter weights.
DEFAULT_INIT_SCALE = 0.02


def adapter_bytes_per_page(cfg: gpt2.GPT2Config, rank: int,
                           adapter_dtype: str = "model") -> int:
    """Device bytes ONE pool page costs (both sides, both sites, every
    layer)."""
    if rank < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    elems = cfg.n_layer * 2 * cfg.n_embd * rank * 2      # a + b
    if adapter_dtype == "int8":
        return elems + cfg.n_layer * 2 * 2 * 4           # int8 + f32 scales
    return elems * torch.empty((), dtype=cfg.dtype).element_size()


def adapter_pool_bytes(cfg: gpt2.GPT2Config, pages: int, rank: int,
                       adapter_dtype: str = "model") -> int:
    """Total pool bytes for ``pages`` usable pages (+1 zero page)."""
    return (pages + 1) * adapter_bytes_per_page(cfg, rank, adapter_dtype)


def adapter_page_row(page_by_slot: Dict[int, int],
                     max_slots: int) -> np.ndarray:
    """The per-slot adapter-page row: i32 [max_slots], ``ZERO_PAGE``
    wherever a slot carries no adapter."""
    row = np.full((max_slots,), ZERO_PAGE, np.int32)
    for slot, page in page_by_slot.items():
        row[slot] = page
    return row


def adapter_partition_specs() -> Tuple[Any, Any]:
    """The partition specs of the pool's (a, b) tensors: replicated, so
    every device of a replica serves every tenant, as with the KV pool.
    Spelled only here (lint: adapter-locality), through the sharding
    registry."""
    from trustworthy_dl_tpu_torch.core import sharding as shreg

    return shreg.replicated_spec(), shreg.replicated_spec()


def _adapter_seed(name: str) -> int:
    """Stable 64-bit seed from the adapter id (``hash()`` is salted per
    process; this must not be)."""
    return int.from_bytes(
        hashlib.sha256(name.encode("utf-8")).digest()[:8], "little")


def materialize_adapter(name: str, cfg: gpt2.GPT2Config, rank: int,
                        init_scale: float = DEFAULT_INIT_SCALE
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic per-tenant weights: (a [L, 2, D, r], b [L, 2, r, D])
    f32, drawn from a generator seeded by the adapter id alone, so every
    replica agrees bit for bit on what tenant X's delta is."""
    rng = np.random.default_rng(_adapter_seed(name))
    d = cfg.n_embd
    a = rng.standard_normal((cfg.n_layer, 2, d, rank),
                            dtype=np.float32) * init_scale
    b = rng.standard_normal((cfg.n_layer, 2, rank, d),
                            dtype=np.float32) * init_scale
    return a, b


def quantize_adapter(a: np.ndarray, b: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Symmetric int8 per-(layer, site) quantization of one adapter's
    (a, b): returns (a_q, a_scale [L, 2], b_q, b_scale)."""
    out = []
    for w in (a, b):
        amax = np.max(np.abs(w), axis=(2, 3))            # [L, 2]
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.rint(w / scale[:, :, None, None]),
                    -127, 127).astype(np.int8)
        out.extend([q, scale])
    return tuple(out)


class AdapterPool:
    """Device pool tensors + the host-side page lifecycle.

    ``pages`` usable pages (ids [1, pages]; page 0 = the zero page).
    Every RESIDENT page carries one reference held by the pool itself;
    each admitted request holds one more.  LRU eviction considers only
    refcount-1 (cold) pages, so an adapter with in-flight traffic is never
    evicted under it.  ``quarantine`` impounds a page through
    ``BlockAllocator.release(quarantine=True)``: at once when cold, else
    when the last request releases it."""

    def __init__(self, cfg: gpt2.GPT2Config, rank: int, pages: int,
                 adapter_dtype: str = "model",
                 init_scale: float = DEFAULT_INIT_SCALE,
                 device: Any = "cpu", trace: Any = None):
        if pages < 1:
            raise ValueError(f"pages must be >= 1, got {pages}")
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        if adapter_dtype not in ("model", "int8"):
            raise ValueError(
                f"adapter_dtype must be 'model' or 'int8', got "
                f"{adapter_dtype!r}")
        self.cfg = cfg
        self.rank = int(rank)
        self.pages = int(pages)
        self.adapter_dtype = adapter_dtype
        self.init_scale = float(init_scale)
        d = cfg.n_embd
        shape_a = (cfg.n_layer, pages + 1, 2, d, rank)
        shape_b = (cfg.n_layer, pages + 1, 2, rank, d)
        dtype = torch.int8 if adapter_dtype == "int8" else cfg.dtype
        self.a = torch.zeros(shape_a, dtype=dtype, device=device)
        self.b = torch.zeros(shape_b, dtype=dtype, device=device)
        self.a_scale: Optional[torch.Tensor] = None
        self.b_scale: Optional[torch.Tensor] = None
        if adapter_dtype == "int8":
            # 1.0 everywhere (the zero page included): an untouched page
            # dequantises to exactly 0.0 * 1.0 = 0.0.
            self.a_scale = torch.ones((cfg.n_layer, pages + 1, 2),
                                      dtype=torch.float32, device=device)
            self.b_scale = torch.ones_like(self.a_scale)
        # The allocator KV blocks use: refcounts, LIFO free list over
        # [1, pages], quarantine set.
        self.alloc = BlockAllocator(pages)
        self._page_of: Dict[str, int] = {}
        self._adapter_of: Dict[int, str] = {}
        self._lru: Dict[str, int] = {}
        self._clock = 0
        self._quarantined: Set[str] = set()
        self._impounded: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.uploads = 0
        # Telemetry: an obs TraceBus for every residency change
        # (``adapter_swap``); the engine binds the pages-in-use gauge and
        # the evictions counter by evicted adapter.
        self.pages_gauge: Any = None
        self.evictions_counter: Any = None
        self.trace = trace

    # -- device upload -----------------------------------------------------

    def _upload(self, name: str, page: int) -> None:
        """Materialise ``name``'s weights into pool page ``page``, IN PLACE
        (JAX rebuilds the array with ``.at[:, page].set``).  Called only
        for a page that is free or was just evicted cold, so no live
        request reads the page being overwritten; the copies run on the
        current stream, the one every kernel launch of the serve path
        uses, so they land between the ticks that read the pool."""
        a_np, b_np = materialize_adapter(name, self.cfg, self.rank,
                                         self.init_scale)
        if self.adapter_dtype == "int8":
            a_q, a_s, b_q, b_s = quantize_adapter(a_np, b_np)
            self.a[:, page] = torch.from_numpy(a_q).to(self.a.device)
            self.b[:, page] = torch.from_numpy(b_q).to(self.b.device)
            self.a_scale[:, page] = torch.from_numpy(a_s).to(self.a.device)
            self.b_scale[:, page] = torch.from_numpy(b_s).to(self.a.device)
        else:
            self.a[:, page] = torch.from_numpy(a_np).to(self.a.device,
                                                        self.a.dtype)
            self.b[:, page] = torch.from_numpy(b_np).to(self.b.device,
                                                        self.b.dtype)
        self.uploads += 1

    # -- lifecycle ---------------------------------------------------------

    def _touch(self, name: str) -> None:
        self._clock += 1
        self._lru[name] = self._clock

    def _evict_cold(self) -> Optional[str]:
        """Evict the least-recently-used COLD resident (residency ref only)
        and return its name, or None when every resident page is live
        (backpressure, not an error)."""
        for name in sorted(self._lru, key=self._lru.get):
            page = self._page_of[name]
            if self.alloc.refcount(page) == 1:
                self._page_of.pop(name)
                self._adapter_of.pop(page)
                self._lru.pop(name)
                self.alloc.release(page)           # residency ref -> freed
                self.evictions += 1
                if self.evictions_counter is not None:
                    self.evictions_counter.inc(tenant=name)
                return name
        return None

    def acquire(self, name: str) -> Optional[int]:
        """Claim one request reference on ``name``'s page, resolving
        residency on a miss (alloc, else LRU-evict a cold tenant, else
        None = backpressure).  Quarantined adapters never resolve."""
        if name in self._quarantined:
            return None
        page = self._page_of.get(name)
        if page is not None:
            self.hits += 1
            self.alloc.incref(page)
            self._touch(name)
            self._set_gauge()
            return page
        self.misses += 1
        got = self.alloc.alloc(1)
        evicted: Optional[str] = None
        if got is None:
            evicted = self._evict_cold()
            if evicted is None:
                return None
            got = self.alloc.alloc(1)
            if got is None:
                raise RuntimeError("free page vanished after eviction")
        page = got[0]
        self._upload(name, page)
        self._page_of[name] = page
        self._adapter_of[page] = name
        self._touch(name)
        if self.trace is not None:
            from trustworthy_dl_tpu_torch.obs.events import EventType

            self.trace.emit(EventType.ADAPTER_SWAP, adapter=name,
                            page=page, evicted=evicted)
        self.alloc.incref(page)                    # the request's ref
        self._set_gauge()
        return page

    def release(self, name: str) -> None:
        """Drop one request reference.  A quarantined adapter whose last
        request just drained has its residency ref released too: the page
        leaves the pool impounded."""
        page = self._page_of.get(name)
        if page is None:
            return                 # impounded on quarantine: refs settled
        self.alloc.release(page)
        if name in self._quarantined and self.alloc.refcount(page) == 1:
            self._impound(name, page)
        self._set_gauge()

    def _impound(self, name: str, page: int) -> None:
        self._page_of.pop(name)
        self._adapter_of.pop(page)
        self._lru.pop(name, None)
        self.alloc.release(page, quarantine=True)
        self._impounded[name] = page

    def quarantine(self, name: str) -> None:
        """Trust verdict against the ADAPTER: refuse every future resolve
        and impound its page, at once when no request is in flight, else
        when the last one drains."""
        self._quarantined.add(name)
        page = self._page_of.get(name)
        if page is not None and self.alloc.refcount(page) == 1:
            self._impound(name, page)
        self._set_gauge()

    def unquarantine(self, name: str) -> None:
        """Operator action: lift the verdict.  The impounded page returns
        to the free list; the adapter re-uploads on next use."""
        self._quarantined.discard(name)
        page = self._impounded.pop(name, None)
        if page is not None:
            self.alloc.unquarantine(page)
        self._set_gauge()

    def _set_gauge(self) -> None:
        if self.pages_gauge is not None:
            self.pages_gauge.set(float(self.pages_in_use))

    # -- introspection -----------------------------------------------------

    @property
    def resident(self) -> Dict[str, int]:
        return dict(self._page_of)

    @property
    def quarantined(self) -> Set[str]:
        return set(self._quarantined)

    @property
    def pages_in_use(self) -> int:
        """Resident pages, impounded ones included."""
        return self.alloc.in_use + len(self._impounded)

    def is_quarantined(self, name: str) -> bool:
        return name in self._quarantined

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def device_args(self) -> Tuple[torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """(a, b, a_scale, b_scale): the pool tensors every serve forward
        reads; the scales are None on the model-dtype tier."""
        return self.a, self.b, self.a_scale, self.b_scale

    def metrics(self) -> Dict[str, Any]:
        return {
            "pages": self.pages,
            "pages_in_use": self.pages_in_use,
            "resident": len(self._page_of),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate(),
            "evictions": self.evictions,
            "uploads": self.uploads,
            "quarantined": sorted(self._quarantined),
        }


__all__ = [
    "DEFAULT_INIT_SCALE", "SITE_ATTN_OUT", "SITE_MLP", "ZERO_PAGE",
    "AdapterPool", "adapter_bytes_per_page", "adapter_page_row",
    "adapter_partition_specs", "adapter_pool_bytes", "materialize_adapter", "quantize_adapter",
]
