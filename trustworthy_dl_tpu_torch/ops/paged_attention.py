"""Serving kernels: ragged paged-decode attention (B5), query-tiled
chunked-prefill attention (B6), each over a model-dtype or an int8 pool,
the trust epilogue (B7), the fused speculative-verify tail (B8) and the
paged per-tenant adapter delta (B9).

Counterpart of ``trustworthy_dl_tpu/ops/paged_attention.py``.  Each wrapper
takes CPU tensors to its plain PyTorch twin (``*_plain``) and CUDA tensors
to its hand-written kernel in ``csrc/paged_attention.cu`` (B9 in
``csrc/adapter_delta.cu``; see the note at the top of each file for what
each kernel replaces, what bounds it and how its design answers that).  The plain twins are the same functions as the
JAX package's ``paged_attention_reference`` and
``logit_trust_stats_reference``; tests hold them against the JAX kernels
and ``chip_smoke.py`` holds the kernels against them on the card.

Each wrapper carries a plain integer ``launches`` that it increments where
it launches its kernel and nowhere else; there it also adds its kernel's
products (``*_flops``, the products of its plain twin) to an open FLOP
tally (``ops.count_kernel_flops``).  The int8 instances of B5 and B6
have wrappers of their own (``paged_attention_int8``,
``paged_prefill_attention_int8``), so their launches count apart.

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
from typing import List, Optional, Tuple, Union

import torch

from trustworthy_dl_tpu_torch.ops import (DTYPE_CODES, check_launch,
                                          kernel_library, on_cuda,
                                          stream_handle, tally_flops)
from trustworthy_dl_tpu_torch.ops.fused_dequant_matmul import lowrank_delta

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


def gather_pool(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[NB, H, BLOCK(, Dh)] pool (or scale plane) + [R, NBPS] table ->
    [R, H, NBPS*BLOCK(, Dh)]."""
    g = pool[table.long()]                       # [R, NBPS, H, BLOCK(, Dh)]
    r, nbps, h, bsz = g.shape[:4]
    order = (0, 2, 1, 3) + tuple(range(4, g.dim()))
    return g.permute(*order).reshape(r, h, nbps * bsz, *g.shape[4:])


def paged_attention_plain(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, table: torch.Tensor,
                          start: Start, k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Gather semantics, spelled standalone (f32 softmax over the whole
    gathered view, NEG_INF mask, int8 scales after the dot and before the
    PV contraction): the twin of every attention kernel here."""
    r, h, t, dh = q.shape
    start = _start_vector(start, r, q.device).long()
    view_k = gather_pool(pool_k, table).float()
    view_v = gather_pool(pool_v, table).float()
    s = torch.einsum("rhtd,rhkd->rhtk", q.float(), view_k)
    s = s / math.sqrt(dh)
    if k_scale is not None:
        s = s * gather_pool(k_scale, table)[:, :, None, :]
    kpos = torch.arange(view_k.shape[2], device=q.device)
    qpos = start[:, None] + torch.arange(t, device=q.device)[None, :]
    s = torch.where(kpos[None, None, None, :] <= qpos[:, None, :, None], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if v_scale is not None:
        p = p * gather_pool(v_scale, table)[:, :, None, :]
    return torch.einsum("rhtk,rhkd->rhtd", p, view_v).to(q.dtype)


#: The prefill kernel computes the same function as the decode kernel.
paged_prefill_attention_plain = paged_attention_plain


def paged_attention_flops(r: int, h: int, t: int, dh: int, keys: int
                          ) -> int:
    """Product FLOPs of B5 or B6 (either pool) for q [R, H, T, Dh] over a
    gathered view of ``keys`` positions (table width x block size): the
    plain twin's QK^T and PV, as ``torch.utils.flop_counter`` counts
    :func:`paged_attention_plain`.  The function is counted over the
    whole view; the kernels stop at each row's causal window."""
    return 4 * r * h * t * keys * dh


def _attention_flops(q: torch.Tensor, pool_k: torch.Tensor,
                     table: torch.Tensor) -> int:
    r, h, t, dh = q.shape
    return paged_attention_flops(r, h, t, dh,
                                 table.shape[1] * pool_k.shape[2])


def _check_attention(q: torch.Tensor, pool_k: torch.Tensor,
                     pool_v: torch.Tensor, table: torch.Tensor,
                     start: torch.Tensor, op: str,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> None:
    r, h, t, dh = q.shape
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{op}: dtype {q.dtype} not supported "
                         f"(one of {sorted(map(str, DTYPE_CODES))})")
    pool_dtype = q.dtype if k_scale is None else torch.int8
    for name, a in (("pool_k", pool_k), ("pool_v", pool_v)):
        if a.dtype != pool_dtype:
            raise ValueError(f"{op}: {name} is {a.dtype}, want {pool_dtype}")
        if a.dim() != 4 or a.shape[1] != h or a.shape[3] != dh:
            raise ValueError(f"{op}: {name} shape {tuple(a.shape)} is not "
                             f"[NB, {h}, BLOCK, {dh}]")
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"{op}: pool_k {tuple(pool_k.shape)} and pool_v "
                         f"{tuple(pool_v.shape)} differ")
    scales = (("k_scale", k_scale), ("v_scale", v_scale))
    for name, a in scales if k_scale is not None else ():
        if (a is None or a.dtype != torch.float32
                or tuple(a.shape) != tuple(pool_k.shape[:3])):
            raise ValueError(f"{op}: {name} must be f32 "
                             f"{list(pool_k.shape[:3])}")
        if a.device != q.device or not a.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous on "
                             f"{q.device}")
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
                      start: torch.Tensor, *extra: int,
                      scales: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    r, h, t, dh = q.shape
    lib = kernel_library("paged_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            *(a.data_ptr() for a in scales),
            table.data_ptr(), start.data_ptr(), out.data_ptr(),
            r, h, t, dh, pool_k.shape[2], table.shape[1], *extra,
            DTYPE_CODES[q.dtype], stream_handle(q.device))
    check_launch(lib, err, entry)
    return out


#: Head widths the bf16-query kernels (B5's split-K decode, B6's
#: tensor-core prefill over either pool) are built for: multiples of 16 up
#: to 128.
BF16_KERNEL_DH_MULTIPLE = 16
BF16_KERNEL_MAX_DH = 128
#: The CUDA-core kernel (f32 q, B5, B6) takes 48 KB of shared memory.
STATIC_SMEM_LIMIT = 48 * 1024


def _bf16_head_width_limit(dh: int) -> Optional[str]:
    if dh < 1 or dh % BF16_KERNEL_DH_MULTIPLE:
        return (f"Dh={dh} must be a positive multiple of "
                f"{BF16_KERNEL_DH_MULTIPLE}")
    if dh > BF16_KERNEL_MAX_DH:
        return f"Dh={dh} > {BF16_KERNEL_MAX_DH}"
    return None


def attn_template_smem_bytes(q_tile: int, dh: int, keys: int) -> int:
    """Shared memory of the CUDA-core kernel (f32 q) at ``q_tile`` query
    rows, head width ``dh`` and ``keys`` staged keys: ``attn_smem_bytes``
    in ``csrc/paged_attention.cu`` (q and acc [q_tile, Dh], K [keys, Dh +
    1], V [keys, Dh], scores [q_tile, keys], m, l and the correction
    [q_tile], two scale rows [keys], all f32)."""
    return 4 * (2 * q_tile * dh + keys * (dh + 1) + keys * dh
                + q_tile * keys + 3 * q_tile + 2 * keys)


def _attn_kernel_limit(dh: int, bsz: int, q_dtype: torch.dtype,
                       q_tile: int) -> Optional[str]:
    """Why B5 or B6 cannot take head width ``dh`` over ``bsz``-position
    blocks with queries in ``q_dtype``: bf16 q's kernels take Dh a
    multiple of 16, at most 128, at any block size; the CUDA-core kernel
    (f32 q) stages at least one whole block a stage and ``q_tile`` query
    rows in :data:`STATIC_SMEM_LIMIT` bytes."""
    if bsz < 1:
        return f"block size {bsz} must be >= 1"
    if q_dtype == torch.bfloat16:
        return _bf16_head_width_limit(dh)
    if q_dtype != torch.float32:
        return f"q must be bf16 or f32 on the card, got {q_dtype}"
    if dh < 1:
        return f"Dh={dh} must be >= 1"
    smem = attn_template_smem_bytes(q_tile, dh, bsz)
    if smem > STATIC_SMEM_LIMIT:
        return (f"Dh={dh}, block size {bsz} needs {smem} bytes of shared "
                f"memory (limit {STATIC_SMEM_LIMIT})")
    return None


def decode_kernel_limit(dh: int, t: int, q_dtype: torch.dtype, bsz: int
                        ) -> Optional[str]:
    """Why B5 cannot take head width ``dh``, ``t`` query rows and
    ``bsz``-position blocks with queries in ``q_dtype``, or None when it
    can.  bf16 q runs the split-K cluster kernel (Dh a multiple of 16, at
    most 128, over a bf16 or an int8 pool, any block size); f32 q the
    CUDA-core kernel (its shared memory at one block a stage and ``t``
    rows).  Both take 1 <= T <= :data:`QROWS` (longer chunks go through
    ``paged_prefill_attention``).  The launch check and ``ServingEngine``'s
    check at construction both read it."""
    if not 1 <= t <= QROWS:
        return (f"T={t} is outside [1, {QROWS}]; chunks go through "
                "paged_prefill_attention")
    return _attn_kernel_limit(dh, bsz, q_dtype, t)


def prefill_kernel_limit(dh: int, bsz: int, q_dtype: torch.dtype
                         ) -> Optional[str]:
    """Why B6 over a model-dtype pool cannot take head width ``dh`` over
    ``bsz``-position blocks with queries in ``q_dtype``, or None when it
    can.  bf16 q runs the tensor-core kernel (Dh a multiple of 16, at most
    128, any block size); f32 q the CUDA-core kernel (its shared memory at
    one block a stage and :data:`QROWS`-row tiles).  The launch check and
    ``ServingEngine``'s check at construction both read it."""
    return _attn_kernel_limit(dh, bsz, q_dtype, QROWS)


def _check_kernel_limit(limit: Optional[str], q: torch.Tensor,
                        pools: Tuple[torch.Tensor, ...], op: str) -> None:
    """Raise on a limit; bf16 q's kernels load q and the pools 16 bytes
    at a time."""
    if limit is not None:
        raise ValueError(f"{op}: {limit}")
    if q.dtype == torch.bfloat16 and any(
            a.data_ptr() % 16 for a in (q, *pools)):
        raise ValueError(f"{op}: q, pool_k and pool_v must be 16-byte "
                         "aligned")


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                    pool_v: torch.Tensor, table: torch.Tensor,
                    start: Start) -> torch.Tensor:
    """Ragged paged-decode attention (B5) over one layer's block pool,
    T <= :data:`QROWS`.  Returns [R, H, T, Dh] in q's dtype.  On the card,
    bf16 q launches the split-K cluster kernel, f32 q the CUDA-core
    kernel (``csrc/paged_attention.cu``); their limits are
    :func:`decode_kernel_limit`."""
    if not on_cuda(q, "paged_attention"):
        return paged_attention_plain(q, pool_k, pool_v, table, start)
    op = "paged_attention"
    start = _start_vector(start, q.shape[0], q.device)
    _check_attention(q, pool_k, pool_v, table, start, op)
    _check_kernel_limit(decode_kernel_limit(q.shape[3], q.shape[2], q.dtype,
                                            pool_k.shape[2]),
                        q, (pool_k, pool_v), op)
    out = _launch_attention("tddl_paged_decode", q, pool_k, pool_v, table,
                            start)
    paged_attention.launches += 1
    tally_flops("paged_attention", _attention_flops(q, pool_k, table))
    return out


paged_attention.launches = 0


def paged_attention_int8(q: torch.Tensor, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, table: torch.Tensor,
                         start: Start, k_scale: torch.Tensor,
                         v_scale: torch.Tensor) -> torch.Tensor:
    """B5 over an int8 pool with f32 scales [NB, H, BLOCK]; kernels and
    limits as :func:`paged_attention`'s."""
    if not on_cuda(q, "paged_attention_int8"):
        return paged_attention_plain(q, pool_k, pool_v, table, start,
                                     k_scale, v_scale)
    op = "paged_attention_int8"
    start = _start_vector(start, q.shape[0], q.device)
    _check_attention(q, pool_k, pool_v, table, start, op, k_scale, v_scale)
    _check_kernel_limit(decode_kernel_limit(q.shape[3], q.shape[2], q.dtype,
                                            pool_k.shape[2]),
                        q, (pool_k, pool_v), op)
    out = _launch_attention("tddl_paged_decode_int8", q, pool_k, pool_v,
                            table, start, scales=(k_scale, v_scale))
    paged_attention_int8.launches += 1
    tally_flops("paged_attention_int8",
                _attention_flops(q, pool_k, table))
    return out


paged_attention_int8.launches = 0


def paged_prefill_attention(q: torch.Tensor, pool_k: torch.Tensor,
                            pool_v: torch.Tensor, table: torch.Tensor,
                            start: Start) -> torch.Tensor:
    """Query-tiled chunked-prefill attention (B6): T query rows split into
    tiles, each reading the pool only up to the last key its own causal
    window reaches.  Same contract as :func:`paged_attention`.  On the
    card, bf16 q launches the tensor-core kernel (64-row query tiles, K/V
    rows gathered through the table by ``cp.async`` into a ring that
    ``ldmatrix`` reads in place, ``mma.sync`` products); f32 q launches
    the CUDA-core kernel with :data:`QROWS`-row tiles.  Both are
    hand-written (``csrc/paged_attention.cu``); their limits are
    :func:`prefill_kernel_limit`."""
    if not on_cuda(q, "paged_prefill_attention"):
        return paged_prefill_attention_plain(q, pool_k, pool_v, table,
                                             start)
    op = "paged_prefill_attention"
    start = _start_vector(start, q.shape[0], q.device)
    _check_attention(q, pool_k, pool_v, table, start, op)
    _check_kernel_limit(
        prefill_kernel_limit(q.shape[3], pool_k.shape[2], q.dtype), q,
        (pool_k, pool_v), op)
    out = _launch_attention("tddl_paged_prefill", q, pool_k, pool_v, table,
                            start, QROWS)
    paged_prefill_attention.launches += 1
    tally_flops("paged_prefill_attention",
                _attention_flops(q, pool_k, table))
    return out


paged_prefill_attention.launches = 0


#: B6's limits are the same over the int8 pool: the bf16-query kernel is
#: one body for both pools, and the CUDA-core kernel stages the two scale
#: rows whatever the pool.
prefill_int8_kernel_limit = prefill_kernel_limit


def paged_prefill_attention_int8(q: torch.Tensor, pool_k: torch.Tensor,
                                 pool_v: torch.Tensor, table: torch.Tensor,
                                 start: Start, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor) -> torch.Tensor:
    """B6 over an int8 pool with f32 scales [NB, H, BLOCK].  On the card,
    bf16 q launches the tensor-core kernel (64-row query tiles, int8 K/V
    staged by ``cp.async`` and widened in shared memory, ``mma.sync``
    products); f32 q launches the CUDA-core kernel with :data:`QROWS`-row
    tiles.  Both are hand-written (``csrc/paged_attention.cu``); their
    limits are :func:`prefill_int8_kernel_limit`."""
    if not on_cuda(q, "paged_prefill_attention_int8"):
        return paged_prefill_attention_plain(q, pool_k, pool_v, table, start,
                                             k_scale, v_scale)
    op = "paged_prefill_attention_int8"
    start = _start_vector(start, q.shape[0], q.device)
    _check_attention(q, pool_k, pool_v, table, start, op, k_scale, v_scale)
    _check_kernel_limit(
        prefill_int8_kernel_limit(q.shape[3], pool_k.shape[2], q.dtype), q,
        (pool_k, pool_v), op)
    out = _launch_attention("tddl_paged_prefill_int8", q, pool_k, pool_v,
                            table, start, QROWS, scales=(k_scale, v_scale))
    paged_prefill_attention_int8.launches += 1
    tally_flops("paged_prefill_attention_int8",
                _attention_flops(q, pool_k, table))
    return out


paged_prefill_attention_int8.launches = 0


def logit_trust_stats_plain(logits: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(softmax entropy [B], top-1 margin [B]) by log_softmax and top-2."""
    logp = torch.log_softmax(logits, dim=-1)
    entropy = -(logp.exp() * logp).sum(dim=-1)
    top2 = torch.topk(logits, 2, dim=-1).values
    return entropy, top2[:, 0] - top2[:, 1]


def logit_trust_stats_flops(b: int, v: int) -> int:
    """Product FLOPs of B7 over [B, V]: 0, as ``torch.utils.flop_counter``
    counts :func:`logit_trust_stats_plain` (a softmax and a top-2 are not
    products)."""
    return 0


def logit_trust_stats(logits: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trust epilogue (B7): f32 logits [B, V] -> (entropy [B],
    margin [B]) in one read of each row, each row spread over a cluster of
    CTAs (any B and V).  The margin is bit-exact against the plain
    version; the entropy agrees to f32 rounding."""
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
    tally_flops("logit_trust_stats", logit_trust_stats_flops(b, v))
    return entropy, margin


logit_trust_stats.launches = 0

#: Most rows one launch of the verify-tail kernel takes; the wrapper
#: covers any B with one launch per group of at most this many rows (fewer
#: at widths where they would not fit: :func:`verify_group_rows`).
VERIFY_MAX_ROWS = 96
#: Shared memory one verify-tail CTA may use (the H100's 227 KB a block),
#: and the bytes of its smallest ring: three 64-deep K chunks of a
#: 128-column head tile, rows padded by 16 bytes.  A launch's normed rows
#: (padded to 16, [rows, D + 8] bf16) share the rest.
VERIFY_SMEM_LIMIT = 232448
VERIFY_MIN_RING_BYTES = 3 * 128 * (64 + 8) * 2
#: The verify-tail kernel's vocab tile (a launch takes at most one CTA per
#: tile, so its scratch is at most this many partials a row, then one
#: arrival word), and the multiple D must be (its K chunks are 64 or 128
#: deep, the last one shorter).
VERIFY_TILE_COLS = 128
VERIFY_D_MULTIPLE = 16


def fused_verify_tail_plain(normed: torch.Tensor, head: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``normed`` [B, D] x ``head`` [V, D] -> (logits [B, V] f32, entropy
    [B], margin [B]): the f32 product rounded through ``normed``'s dtype
    (the compute-dtype matmul's output), then the trust epilogue."""
    logits = (normed.float() @ head.float().T).to(normed.dtype).float()
    entropy, margin = logit_trust_stats_plain(logits)
    return logits, entropy, margin


def fused_verify_tail_flops(b: int, d: int, v: int) -> int:
    """Product FLOPs of B8 for ``normed`` [B, D] and the head [V, D]: the
    logits' 2 B D V (the trust epilogue adds none), as
    ``torch.utils.flop_counter`` counts :func:`fused_verify_tail_plain`."""
    return 2 * b * d * v


def verify_group_rows(d: int) -> int:
    """Most rows one launch of B8 takes at width ``d``: at most
    :data:`VERIFY_MAX_ROWS`, fewer (a multiple of 16) where normed's rows
    and the smallest ring would not fit in shared memory - 80 at GPT-2
    medium's 1024, 48 at XL's 1600 - and 0 where not even 16 rows fit
    (past D = 5520)."""
    fit = (VERIFY_SMEM_LIMIT - VERIFY_MIN_RING_BYTES) // ((d + 8) * 2)
    return min(VERIFY_MAX_ROWS, fit // 16 * 16)


def verify_row_groups(b: int, d: int) -> List[Tuple[int, int]]:
    """The row slices [start, stop) that cover ``b`` verify rows at width
    ``d``, one launch of B8 each: :func:`verify_group_rows` rows a slice,
    every start a multiple of it (a multiple of 16 rows keeps each
    slice's base 16-byte aligned at any V or D)."""
    step = verify_group_rows(d)
    return [(s, min(s + step, b)) for s in range(0, b, step)]


def verify_kernel_limit(d: int, dtype: torch.dtype) -> Optional[str]:
    """Why B8 cannot take width ``d`` with ``normed`` and the head in
    ``dtype``, or None when it can: bf16, D a positive multiple of
    :data:`VERIFY_D_MULTIPLE` whose 16 rows fit in shared memory beside
    the smallest ring (D <= 5520; any B, one launch per row group).  A
    ``spec_k > 0`` engine on the card passes it whenever it passes B4's
    limits at construction (``quant.int8.dequant_engine_limit``: bf16,
    n_embd a multiple of 16) at n_embd up to 5520."""
    if dtype != torch.bfloat16:
        return f"the verify tail takes bf16 on the card, got {dtype}"
    if d < 1 or d % VERIFY_D_MULTIPLE:
        return f"D={d} must be a positive multiple of {VERIFY_D_MULTIPLE}"
    if verify_group_rows(d) < 16:
        return (f"D={d}: 16 rows of normed and three ring stages exceed "
                f"{VERIFY_SMEM_LIMIT} bytes of shared memory")
    return None


def fused_verify_tail(normed: torch.Tensor, head: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The speculative-verify tail (B8) in one pass over the vocab:
    post-``ln_f`` activations ``normed`` [B, D] in the compute dtype x the
    tied head [V, D] -> (f32 logits [B, V], entropy [B], margin [B]).  The
    logits are written (the verify sampler reads whole rows) and reduced
    while on chip, and the rows' statistics are folded in the same launch;
    the margin equals top-2 of the returned logits bit for bit.  Rows are
    independent, so any B runs as one launch per :func:`verify_row_groups`
    slice at width D, each writing its rows of the outputs.  The kernel's
    limits are :func:`verify_kernel_limit`."""
    if not on_cuda(normed, "fused_verify_tail"):
        return fused_verify_tail_plain(normed, head)
    if normed.dim() != 2 or head.dim() != 2 or head.shape[1] != normed.shape[1]:
        raise ValueError("fused_verify_tail: normed [B, D] and head [V, D], "
                         f"got {tuple(normed.shape)} and {tuple(head.shape)}")
    b, d = normed.shape
    v = head.shape[0]
    if head.dtype != normed.dtype:
        raise ValueError("fused_verify_tail: normed and head must share a "
                         f"dtype, got {normed.dtype} and {head.dtype}")
    limit = verify_kernel_limit(d, normed.dtype)
    if limit is not None:
        raise ValueError(f"fused_verify_tail: {limit}")
    if b < 1:
        raise ValueError(f"fused_verify_tail: B={b} must be >= 1")
    for name, a in (("normed", normed), ("head", head)):
        if (a.device != normed.device or not a.is_contiguous()
                or a.data_ptr() % 16):
            raise ValueError(f"fused_verify_tail: {name} must be contiguous "
                             f"and 16-byte aligned on {normed.device}")
    ntiles = -(-v // VERIFY_TILE_COLS)
    dev = normed.device
    logits = torch.empty(b, v, dtype=torch.float32, device=dev)
    # Scratch: each CTA's (top1, top2, sum e, sum x e) of every row, which
    # the launch's last CTA folds, then the launch's arrival word (the C
    # entry zeroes it on the stream; the next group's partials reuse it).
    partials = torch.empty(b * ntiles + 1, 4, dtype=torch.float32,
                           device=dev)
    entropy = torch.empty(b, dtype=torch.float32, device=dev)
    margin = torch.empty_like(entropy)
    lib = kernel_library("paged_attention")
    for lo, hi in verify_row_groups(b, d):
        with torch.cuda.device(dev):
            err = lib.tddl_verify_tail(
                normed[lo:hi].data_ptr(), head.data_ptr(),
                logits[lo:hi].data_ptr(), partials[lo * ntiles].data_ptr(),
                entropy[lo:hi].data_ptr(), margin[lo:hi].data_ptr(), hi - lo,
                d, v, stream_handle(dev))
        check_launch(lib, err, "tddl_verify_tail")
        fused_verify_tail.launches += 1
    tally_flops("fused_verify_tail", fused_verify_tail_flops(b, d, v))
    return logits, entropy, margin


fused_verify_tail.launches = 0

#: B9's largest rank, the multiple D must be (x, the pool pages and B's
#: columns are read in 16-byte vectors, 16 int8 values each), its
#: positions of T per CTA past T = 1, its output columns and warps per CTA.
ADAPTER_MAX_RANK = 64
ADAPTER_D_MULTIPLE = 16
ADAPTER_TILE_T = 8
ADAPTER_COLUMNS = 256
ADAPTER_WARPS = 8
#: Shared memory one B9 CTA may use (the H100's 227 KB per block).
ADAPTER_SMEM_LIMIT = 232448
_ADAPTER_POOL_CODES = {torch.bfloat16: 1, torch.int8: 2}


def adapter_delta_plain(x: torch.Tensor, a_pool: torch.Tensor,
                        b_pool: torch.Tensor, pages: torch.Tensor,
                        a_scale: Optional[torch.Tensor] = None,
                        b_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The page gather, then :func:`lowrank_delta`: the twin of B9."""
    idx = pages.long()
    return lowrank_delta(x, a_pool[idx], b_pool[idx],
                         None if a_scale is None else a_scale[idx],
                         None if b_scale is None else b_scale[idx])


def adapter_delta_flops(r: int, t: int, d: int, rank: int) -> int:
    """Product FLOPs of B9 for ``x`` [R, T, D] through rank-``rank``
    pages: (x A) then (h B), 2 R T D r each, as ``torch.utils.
    flop_counter`` counts :func:`adapter_delta_plain`."""
    return 4 * r * t * d * rank


def adapter_smem_bytes(rank: int, d: int, tile_t: int = ADAPTER_TILE_T,
                       itemsize: int = 2) -> int:
    """Bytes of shared memory of one B9 CTA (``smem_bytes`` of
    ``csrc/adapter_delta.cu``): the partial sums [warps][tile_t][rpad] and
    h [rpad][tile_t] in f32, the x tile [tile_t][d] in bf16 and B's
    columns [rank][ADAPTER_COLUMNS] in pages of ``itemsize`` bytes; rpad
    is ``rank`` rounded up to a power of two, at least 8."""
    rpad = max(8, 1 << (rank - 1).bit_length())
    return (4 * (ADAPTER_WARPS * tile_t * rpad + rpad * tile_t)
            + 2 * tile_t * d + itemsize * rank * ADAPTER_COLUMNS)


def adapter_kernel_limit(rank: int, d: int, x_dtype: torch.dtype
                         ) -> Optional[str]:
    """Why B9 cannot take an adapter of ``rank`` over width ``d`` with
    ``x`` in ``x_dtype``, or None when it can: the limits that depend on
    nothing but these three.  The launch check and the engine's check at
    construction both read it, so the two cannot drift.  Shared memory
    grows with D only through the x tile (bf16 pages, the larger, at the
    8-position tile): rank 64 takes D up to 11,328."""
    if x_dtype != torch.bfloat16:
        return f"x must be bf16 on the card, got {x_dtype}"
    if d < 1 or d % ADAPTER_D_MULTIPLE:
        return f"D={d} must be a positive multiple of {ADAPTER_D_MULTIPLE}"
    if not 1 <= rank <= ADAPTER_MAX_RANK:
        return f"rank {rank} outside [1, {ADAPTER_MAX_RANK}]"
    smem = adapter_smem_bytes(rank, d)
    if smem > ADAPTER_SMEM_LIMIT:
        return (f"D={d}, r={rank} needs {smem} bytes of shared memory "
                f"(limit {ADAPTER_SMEM_LIMIT})")
    return None


def _check_adapter(x: torch.Tensor, a_pool: torch.Tensor,
                   b_pool: torch.Tensor, pages: torch.Tensor,
                   a_scale: Optional[torch.Tensor],
                   b_scale: Optional[torch.Tensor]) -> None:
    op = "adapter_delta"
    if x.dim() != 3:
        raise ValueError(f"{op}: x must be [R, T, D], got "
                         f"{tuple(x.shape)}")
    r_rows, t, d = x.shape
    if r_rows < 1 or t < 1:
        raise ValueError(f"{op}: R={r_rows} and T={t} must be >= 1")
    if a_pool.dtype not in _ADAPTER_POOL_CODES or b_pool.dtype != a_pool.dtype:
        raise ValueError(f"{op}: pool pages must be bf16 or int8 (both "
                         f"sides alike), got {a_pool.dtype} / "
                         f"{b_pool.dtype}")
    if a_pool.dim() != 3 or a_pool.shape[1] != d:
        raise ValueError(f"{op}: a_pool must be [P+1, {d}, r], got "
                         f"{tuple(a_pool.shape)}")
    npg, _, rank = a_pool.shape
    if tuple(b_pool.shape) != (npg, rank, d):
        raise ValueError(f"{op}: b_pool must be [{npg}, {rank}, {d}], got "
                         f"{tuple(b_pool.shape)}")
    limit = adapter_kernel_limit(rank, d, x.dtype)
    if limit is not None:
        raise ValueError(f"{op}: {limit}")
    # A site view of the pool: pages may be strided, each page dense and
    # 16-byte aligned.
    if (a_pool.stride(1), a_pool.stride(2)) != (rank, 1) or \
            (b_pool.stride(1), b_pool.stride(2)) != (d, 1):
        raise ValueError(f"{op}: each pool page must be dense (strides "
                         f"{a_pool.stride()} / {b_pool.stride()})")
    for name, pool in (("a_pool", a_pool), ("b_pool", b_pool)):
        if pool.data_ptr() % 16 or pool.stride(0) * pool.element_size() % 16:
            raise ValueError(f"{op}: {name}'s pages must be 16-byte "
                             "aligned")
    if (a_scale is None) != (b_scale is None):
        raise ValueError(f"{op}: give both scales or neither")
    for name, s in (("a_scale", a_scale), ("b_scale", b_scale)):
        if s is not None and (s.dtype != torch.float32
                              or tuple(s.shape) != (npg,)
                              or s.stride(0) != a_scale.stride(0)
                              or s.device != x.device):
            raise ValueError(f"{op}: {name} must be f32 [{npg}] on "
                             f"{x.device}, strided like a_scale")
    if pages.dtype != torch.int32 or tuple(pages.shape) != (r_rows,) \
            or not pages.is_contiguous():
        raise ValueError(f"{op}: pages must be contiguous int32 "
                         f"[{r_rows}], got {pages.dtype} "
                         f"{tuple(pages.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{op}: x must be contiguous and 16-byte aligned")
    for name, a in (("a_pool", a_pool), ("b_pool", b_pool),
                    ("pages", pages)):
        if a.device != x.device:
            raise ValueError(f"{op}: {name} on {a.device}, x on {x.device}")


def adapter_delta(x: torch.Tensor, a_pool: torch.Tensor,
                  b_pool: torch.Tensor, pages: torch.Tensor,
                  a_scale: Optional[torch.Tensor] = None,
                  b_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged low-rank delta for ONE adapter site (B9): ``x`` [R, T, D] x
    pool pages ``a_pool`` [P+1, D, r] / ``b_pool`` [P+1, r, D] selected
    by ``pages`` i32 [R] -> f32 [R, T, D], reading each row's pages
    straight from the pool (no gathered copy).  ``a_scale``/``b_scale``
    [P+1] are the int8 tier's per-page scales for this site (None: 1.0).
    The pools may be strided site views (``a_l[:, site]``).  Page indices
    are the caller's host-validated row (``serve.adapters.
    adapter_page_row``); the kernel writes NaN rows for one outside [0,
    P] rather than read outside the pool.  The kernel takes bf16 x, bf16
    or int8 pages, r <= :data:`ADAPTER_MAX_RANK` and D a multiple of
    :data:`ADAPTER_D_MULTIPLE`."""
    if not on_cuda(x, "adapter_delta"):
        return adapter_delta_plain(x, a_pool, b_pool, pages, a_scale,
                                   b_scale)
    _check_adapter(x, a_pool, b_pool, pages, a_scale, b_scale)
    r_rows, t, d = x.shape
    npg, _, rank = a_pool.shape
    out = torch.empty(r_rows, t, d, dtype=torch.float32, device=x.device)
    lib = kernel_library("adapter_delta")
    with torch.cuda.device(x.device):
        err = lib.tddl_adapter_delta(
            x.data_ptr(), a_pool.data_ptr(), b_pool.data_ptr(),
            None if a_scale is None else a_scale.data_ptr(),
            None if b_scale is None else b_scale.data_ptr(),
            pages.data_ptr(), out.data_ptr(), a_pool.stride(0),
            b_pool.stride(0), 0 if a_scale is None else a_scale.stride(0),
            r_rows, t, d, rank, npg, _ADAPTER_POOL_CODES[a_pool.dtype],
            stream_handle(x.device))
    check_launch(lib, err, "tddl_adapter_delta")
    adapter_delta.launches += 1
    tally_flops("adapter_delta", adapter_delta_flops(r_rows, t, d, rank))
    return out


adapter_delta.launches = 0

#: The kernels of this module, by the wrapper that launches each.
KERNEL_WRAPPERS = (paged_attention, paged_prefill_attention,
                   logit_trust_stats, paged_attention_int8,
                   paged_prefill_attention_int8, fused_verify_tail,
                   adapter_delta)


def reset_launch_counts() -> None:
    """Set every wrapper's ``launches`` back to 0."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


__all__ = [
    "ADAPTER_MAX_RANK", "BF16_KERNEL_MAX_DH", "KERNEL_WRAPPERS", "NEG_INF",
    "QROWS", "VERIFY_MAX_ROWS", "adapter_delta", "adapter_delta_flops",
    "adapter_delta_plain", "adapter_kernel_limit", "adapter_smem_bytes",
    "attn_template_smem_bytes", "decode_kernel_limit",
    "fused_verify_tail", "fused_verify_tail_flops",
    "fused_verify_tail_plain", "gather_pool", "logit_trust_stats",
    "logit_trust_stats_flops", "logit_trust_stats_plain",
    "paged_attention", "paged_attention_flops", "paged_attention_int8",
    "paged_attention_plain", "paged_prefill_attention",
    "paged_prefill_attention_int8", "paged_prefill_attention_plain",
    "prefill_int8_kernel_limit", "prefill_kernel_limit",
    "reset_launch_counts", "verify_group_rows", "verify_kernel_limit",
    "verify_row_groups",
]
