"""Serving kernels: ragged paged-decode attention (B5), query-tiled
chunked-prefill attention (B6) and the trust epilogue (B7).

Counterpart of ``trustworthy_dl_tpu/ops/paged_attention.py``.  Each wrapper
takes CPU tensors to its plain PyTorch twin (``*_plain``) and CUDA tensors
to its hand-written kernel in ``csrc/paged_attention.cu`` (see the note at
the top of that file for what each kernel replaces, what bounds it and how
its design answers that).  The plain twins are the same functions as the
JAX package's ``paged_attention_reference`` and
``logit_trust_stats_reference``; tests hold them against the JAX kernels
and ``chip_smoke.py`` holds the kernels against them on the card.

Each wrapper carries a plain integer ``launches`` that it increments where
it launches its kernel and nowhere else.

Semantics shared by the attention pair: ``q`` [R, H, T, Dh] are queries at
absolute positions ``start[r] + t``; ``pool_k``/``pool_v`` [NB, H, BLOCK,
Dh] are one layer's block pool; ``table`` i32 [R, NBPS] holds each row's
physical block ids.  The K/V of positions [0, start + T) must already be in
the pool (the caller writes the fresh rows first).  Query t of row r sees
cache positions ``kpos <= start[r] + t``; each row reads its table only up
to the last block its window needs, clipped into the table.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from trustworthy_dl_tpu_torch.ops import (DTYPE_CODES, check_launch,
                                          kernel_library, on_cuda,
                                          stream_handle)

NEG_INF = -1e30
#: Query rows per CTA: the decode kernel's ceiling on T, and the
#: prefill kernel's query tile (the TPU kernels' sublane tile).
QROWS = 8

Start = Union[int, torch.Tensor]


def _start_vector(start: Start, r: int, device: torch.device
                  ) -> torch.Tensor:
    """``start`` as i32 [R] on ``device`` (a scalar broadcasts)."""
    if isinstance(start, torch.Tensor) and start.dim() == 1:
        return start.to(device=device, dtype=torch.int32)
    return torch.full((r,), int(start), dtype=torch.int32, device=device)


def _gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[NB, H, BLOCK, Dh] pool + [R, NBPS] table -> [R, H, NBPS*BLOCK, Dh]."""
    g = pool[table.long()]                          # [R, NBPS, H, BLOCK, Dh]
    r, nbps, h, bsz, dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(r, h, nbps * bsz, dh)


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, table: torch.Tensor,
                          start: Start) -> torch.Tensor:
    """Gather semantics, spelled standalone (f32 softmax over the whole
    gathered view, NEG_INF mask): the twin of both attention kernels."""
    r, h, t, dh = q.shape
    start = _start_vector(start, r, q.device).long()
    view_k = _gather(pool_k, table).float()
    view_v = _gather(pool_v, table).float()
    s = torch.einsum("rhtd,rhkd->rhtk", q.float(), view_k)
    s = s / math.sqrt(dh)
    kpos = torch.arange(view_k.shape[2], device=q.device)
    qpos = start[:, None] + torch.arange(t, device=q.device)[None, :]
    s = torch.where(kpos[None, None, None, :] <= qpos[:, None, :, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("rhtk,rhkd->rhtd", p, view_v).to(q.dtype)


#: The prefill kernel computes the same function as the decode kernel.
paged_prefill_attention_plain = paged_attention_plain


def _check_attention(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, table: torch.Tensor,
                     start: torch.Tensor, op: str) -> None:
    r, h, t, dh = q.shape
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported "
                         f"(one of {sorted(map(str, DTYPE_CODES))})")
    for name, a in (("pool_k", pool_k), ("pool_v", pool_v)):
        if a.dtype != q.dtype:
            raise ValueError(f"{op}: {name} is {a.dtype}, q is {q.dtype}")
        if a.dim() != 4 or a.shape[1] != h or a.shape[3] != dh:
            raise ValueError(f"{op}: {name} shape {tuple(a.shape)} is not "
                             f"[NB, {h}, BLOCK, {dh}]")
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"{op}: pool_k {tuple(pool_k.shape)} and pool_v "
                         f"{tuple(pool_v.shape)} differ")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != r:
        raise ValueError(f"{op}: table must be int32 [{r}, NBPS], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if start.shape != (r,):
        raise ValueError(f"{op}: start must be [{r}], got "
                         f"{tuple(start.shape)}")
    for name, a in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("table", table), ("start", start)):
        if a.device != q.device:
            raise ValueError(f"{op}: {name} on {a.device}, q on {q.device}")
        if not a.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")


def _launch_attention(entry: str, q: torch.Tensor, pool_k: torch.Tensor,
                      pool_v: torch.Tensor, table: torch.Tensor,
                      start: torch.Tensor, *extra: int) -> torch.Tensor:
    r, h, t, dh = q.shape
    lib = kernel_library("paged_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            table.data_ptr(), start.data_ptr(), out.data_ptr(),
            r, h, t, dh, pool_k.shape[2], table.shape[1], *extra,
            DTYPE_CODES[q.dtype], stream_handle(q.device))
    check_launch(lib, err, entry)
    return out


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, table: torch.Tensor,
                    start: Start) -> torch.Tensor:
    """Ragged paged-decode attention (B5) over one layer's block pool,
    T <= :data:`QROWS`.  Returns [R, H, T, Dh] in q's dtype."""
    if not on_cuda(q, "paged_attention"):
        return paged_attention_plain(q, pool_k, pool_v, table, start)
    r, _, t, _ = q.shape
    if t > QROWS:
        raise ValueError(f"paged_attention: T={t} > {QROWS}; chunks go "
                         "through paged_prefill_attention")
    start = _start_vector(start, r, q.device)
    _check_attention(q, pool_k, pool_v, table, start, "paged_attention")
    out = _launch_attention("tddl_paged_decode", q, pool_k, pool_v, table,
                            start)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_prefill_attention(q: torch.Tensor, pool_k: torch.Tensor,
                            pool_v: torch.Tensor, table: torch.Tensor,
                            start: Start) -> torch.Tensor:
    """Query-tiled chunked-prefill attention (B6): T query rows split into
    :data:`QROWS`-row tiles, each reading the pool only up to the last
    block its own causal window reaches.  Same contract as
    :func:`paged_attention`."""
    if not on_cuda(q, "paged_prefill_attention"):
        return paged_prefill_attention_plain(q, pool_k, pool_v, table,
                                             start)
    start = _start_vector(start, q.shape[0], q.device)
    _check_attention(q, pool_k, pool_v, table, start,
                     "paged_prefill_attention")
    out = _launch_attention("tddl_paged_prefill", q, pool_k, pool_v, table,
                            start, QROWS)
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0


def logit_trust_stats_plain(logits: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax entropy [B], top-1 margin [B]) by log_softmax and top-2."""
    logp = torch.log_softmax(logits, dim=-1)
    entropy = -(logp.exp() * logp).sum(dim=-1)
    top2 = torch.topk(logits, 2, dim=-1).values
    return entropy, top2[:, 0] - top2[:, 1]


def logit_trust_stats(logits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trust epilogue (B7): f32 logits [B, V] -> (entropy [B],
    margin [B]) in one read of each row.  The margin is bit-exact against
    the plain version; the entropy agrees to f32 rounding."""
    if not on_cuda(logits, "logit_trust_stats"):
        return logit_trust_stats_plain(logits)
    if (logits.dtype != torch.float32 or logits.dim() != 2
            or not logits.is_contiguous()):
        raise ValueError("logit_trust_stats: logits must be contiguous f32 "
                         f"[B, V], got {logits.dtype} {tuple(logits.shape)}")
    b, v = logits.shape
    lib = kernel_library("paged_attention")
    entropy = torch.empty(b, dtype=torch.float32, device=logits.device)
    margin = torch.empty_like(entropy)
    with torch.cuda.device(logits.device):
        err = lib.tddl_trust_stats(logits.data_ptr(), entropy.data_ptr(),
                                   margin.data_ptr(), b, v,
                                   stream_handle(logits.device))
    check_launch(lib, err, "tddl_trust_stats")
    logit_trust_stats.launches += 1
    return entropy, margin


logit_trust_stats.launches = 0

#: The kernels of this module, by the wrapper that launches each.
KERNEL_WRAPPERS = (paged_attention, paged_prefill_attention,
                   logit_trust_stats)


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` back to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "KERNEL_WRAPPERS", "NEG_INF", "QROWS", "logit_trust_stats",
    "logit_trust_stats_plain", "paged_attention", "paged_attention_plain",
    "paged_prefill_attention", "paged_prefill_attention_plain",
    "reset_launch_counts",
]
