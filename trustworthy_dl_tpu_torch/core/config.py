"""Serving configuration.

Counterpart of ``ServeConfig`` in ``trustworthy_dl_tpu/core/config.py``,
with the fields this slice serves: the paged pool's geometry, the prefix
cache, chunked prefill and the attention path.  The int8 KV/weight tiers,
speculative decoding, adapters, the stripe pool and tensor parallelism
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from trustworthy_dl_tpu_torch.models.generate import ATTN_IMPLS
from trustworthy_dl_tpu_torch.serve.kv_slots import validate_paged_geometry


@dataclass
class ServeConfig:
    """``attn_impl``: "kernel" (the hand-written CUDA kernels; their plain
    twins on CPU tensors) or "plain" (the gathered-view reference path).
    Bad values fail here, at construction."""

    max_slots: int = 8
    max_seq: int = 256
    queue_limit: int = 64
    block_size: int = 16
    num_blocks: Optional[int] = None
    prefix_cache: bool = True
    prefill_chunk: Optional[int] = None
    attn_impl: str = "kernel"

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
