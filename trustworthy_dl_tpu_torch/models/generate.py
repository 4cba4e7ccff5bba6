"""Cached and paged generation for GPT-2.

Counterpart of ``trustworthy_dl_tpu/models/generate.py``: the dense KV
cache used by batch ``generate()`` and by the serving engine's local
prefill, and the paged read/write path over the serving block pool.

Numerics follow the JAX spelling step by step: the residual stream is f32;
LayerNorm runs in f32 and casts to the compute dtype; the dense cache path
computes its scores in the compute dtype, masks with that dtype's
``finfo.min`` and takes the softmax in f32 cast back; the logits are
``(ln_f(x) in compute dtype) @ wte_head.T`` upcast to f32, with
``wte_head`` pre-cast once by :func:`_decode_view`.

Unlike JAX, which threads caches and pools functionally, the port updates
them IN PLACE (slice assignment / ``index_put_``): a cache or pool passed
in is the one written.

int8 KV tier: a cache or pool with scale planes stores int8 K/V with f32
per-(head, position) scales (``quant/int8.py``); fresh rows are quantized
at the write, the K scale multiplies the scores after the dot and the V
scale the probabilities before the PV contraction.  Weight-only int8
views (``quant.int8.quantize_decode_view``) run the four block matrices
through ``quant.int8.qdense`` (B4 on the card).

Paged path (``attn_impl``):

* ``"kernel"``: write-then-attend.  The fresh K/V are scattered into the
  pool first, then the B5 decode kernel (T <= 8) or the B6 chunked-prefill
  kernel (T > 8) reads positions [0, start + T) straight from the pool.
  On CPU tensors the kernels' plain twins run instead.
* ``"plain"``: the reference semantics.  Each row's logical view is
  gathered through its block table, the dense ``_block_with_cache`` core
  writes into the view and attends, and the written rows are scattered
  back.  Write-then-attend equals write-into-view because a row only ever
  writes blocks it owns alone.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.ops.fused_dequant_matmul import lowrank_delta
from trustworthy_dl_tpu_torch.quant import int8 as q8

Params = Dict[str, Any]
Start = Union[int, torch.Tensor]

#: Paged attention paths (see the module docstring).
ATTN_IMPLS = ("kernel", "plain")


class KVCache(NamedTuple):
    k: torch.Tensor       # [L, B, H, S, Dh]
    v: torch.Tensor       # [L, B, H, S, Dh]
    # Valid positions: an int shared by every row, or i64 [B] per row.
    length: Start
    # int8 tier: f32 per-(head, position) scales [L, B, H, S].
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init_cache(cfg: gpt2.GPT2Config, batch: int, max_len: int,
               device: Any = "cpu",
               kv_dtype: Optional[torch.dtype] = None) -> KVCache:
    """Zeros in ``kv_dtype`` (default the compute dtype); ``torch.int8``
    adds zero scale planes, so untouched rows dequantize to exact zeros."""
    kv_dtype = cfg.dtype if kv_dtype is None else kv_dtype
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.head_dim)
    cache = KVCache(k=torch.zeros(shape, dtype=kv_dtype, device=device),
                    v=torch.zeros(shape, dtype=kv_dtype, device=device),
                    length=0)
    if kv_dtype == torch.int8:
        return cache._replace(
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32,
                                device=device))
    return cache


def _positions(start: Start, t: int, device: torch.device) -> torch.Tensor:
    """Absolute positions [T] (int start) or [B, T] (per-row start)."""
    ar = torch.arange(t, device=device)
    if isinstance(start, torch.Tensor):
        return start.long()[:, None] + ar[None, :]
    return start + ar


def _embed(view: Params, tokens: torch.Tensor, start: Start,
           cfg: gpt2.GPT2Config) -> torch.Tensor:
    # Padded positions past the table clamp to its last row, as JAX's
    # gather does; their activations are discarded by the caller.
    pos = _positions(start, tokens.shape[-1], tokens.device)
    return gpt2.embed(view, tokens, pos.clamp(max=cfg.n_positions - 1))


def _write_cache_rows(layer_kv: torch.Tensor, new: torch.Tensor,
                      start: Start) -> None:
    """Write [B, H, T(, Dh)] rows into the [B, H, S(, Dh)] cache (or scale
    plane) at ``start`` (int: every row at one offset; tensor [B]: each row
    at its own)."""
    t = new.shape[2]
    new = new.to(layer_kv.dtype)
    if not isinstance(start, torch.Tensor):
        layer_kv[:, :, start:start + t] = new
        return
    idx = _positions(start, t, layer_kv.device)              # [B, T]
    rows = torch.arange(layer_kv.shape[0], device=layer_kv.device)[:, None]
    layer_kv[rows, :, idx] = new.transpose(1, 2)


def _attn_qkv(block: Params, x: torch.Tensor, cfg: gpt2.GPT2Config
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln_1 + fused qkv projection + head split: [B, T, D] -> q, k, v
    [B, H, T, Dh] in the compute dtype."""
    y = L.layernorm(block["ln_1"], x).to(cfg.dtype)
    qkv = q8.qdense(block["attn"]["qkv"], y, cfg.dtype)
    q, k, v = qkv.split(cfg.n_embd, dim=-1)
    return tuple(gpt2.split_heads(a, cfg.n_head) for a in (q, k, v))


def _attn_mlp_tail(block: Params, x: torch.Tensor, out: torch.Tensor,
                   cfg: gpt2.GPT2Config, adapter: Optional[tuple] = None,
                   adapter_pool: Optional[tuple] = None) -> torch.Tensor:
    """Merge heads, attention projection + residual, MLP (ln_2, fc,
    tanh GELU, proj) + residual; every matrix through ``qdense``.

    Adapter deltas (``serve/adapters.py``), JAX ``_attn_mlp_tail``'s
    order: site 0 takes the merged attention output and adds to ``x``
    after the projection's residual; site 1 takes the ``ln_2`` output and
    adds to the MLP output before its residual.  ``adapter`` is the
    gathered form ``(a [B, 2, D, r], b [B, 2, r, D], a_scale [B, 2] or
    None, b_scale)`` for :func:`lowrank_delta`; ``adapter_pool`` the
    ungathered one-layer pool ``(a_l [P+1, 2, D, r], b_l, a_scale_l
    [P+1, 2] or None, b_scale_l, pages i32 [B])`` for B9
    (``ops.paged_attention.adapter_delta``).  With neither, this is the
    adapter-free tail bit for bit."""
    dtype = cfg.dtype
    b, t, d = x.shape
    out = out.permute(0, 2, 1, 3).reshape(b, t, d)

    def delta(site_x: torch.Tensor, site: int) -> Optional[torch.Tensor]:
        if adapter_pool is not None:
            a_l, b_l, as_l, bs_l, pages = adapter_pool
            return pattn.adapter_delta(
                site_x, a_l[:, site], b_l[:, site], pages,
                None if as_l is None else as_l[:, site],
                None if bs_l is None else bs_l[:, site])
        if adapter is not None:
            a_s, b_s, as_s, bs_s = adapter
            return lowrank_delta(site_x, a_s[:, site], b_s[:, site],
                                 None if as_s is None else as_s[:, site],
                                 None if bs_s is None else bs_s[:, site])
        return None

    x = x + q8.qdense(block["attn"]["proj"], out, dtype).to(x.dtype)
    d0 = delta(out, 0)
    if d0 is not None:
        x = x + d0.to(x.dtype)
    y = L.layernorm(block["ln_2"], x).to(dtype)
    ln2 = y
    y = F.gelu(q8.qdense(block["mlp"]["fc"], y, dtype), approximate="tanh")
    mlp = q8.qdense(block["mlp"]["proj"], y, dtype).to(x.dtype)
    d1 = delta(ln2, 1)
    if d1 is not None:
        mlp = mlp + d1.to(x.dtype)
    return x + mlp


def _block_with_cache(block: Params, x: torch.Tensor,
                      layer_k: torch.Tensor, layer_v: torch.Tensor,
                      start: Start, cfg: gpt2.GPT2Config,
                      layer_k_scale: Optional[torch.Tensor] = None,
                      layer_v_scale: Optional[torch.Tensor] = None,
                      adapter: Optional[tuple] = None) -> torch.Tensor:
    """One block over [B, T, D] new positions: writes their K/V into the
    cache [B, H, S, Dh] at ``start`` (in place), then attends causally to
    cache positions [0, start + t].  With scale planes [B, H, S] the cache
    is int8: rows are quantized at the write, the K scale multiplies the
    compute-dtype scores and the V scale the probabilities (JAX
    ``_block_with_cache``'s int8 branch, step for step).  ``adapter`` is
    the gathered per-row adapter slice (:func:`_attn_mlp_tail`)."""
    dtype = cfg.dtype
    t = x.shape[1]
    s = layer_k.shape[-2]
    q, k, v = _attn_qkv(block, x, cfg)
    quantized = layer_k_scale is not None
    if quantized:
        k_q, k_s = q8.quantize_kv(k)
        v_q, v_s = q8.quantize_kv(v)
        _write_cache_rows(layer_k, k_q, start)
        _write_cache_rows(layer_v, v_q, start)
        _write_cache_rows(layer_k_scale, k_s, start)
        _write_cache_rows(layer_v_scale, v_s, start)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, layer_k.to(dtype))
        scores = scores * layer_k_scale[:, :, None, :] \
            / math.sqrt(cfg.head_dim)
    else:
        _write_cache_rows(layer_k, k, start)
        _write_cache_rows(layer_v, v, start)
        scores = torch.einsum("bhqd,bhkd->bhqk", q, layer_k) \
            / math.sqrt(cfg.head_dim)
    q_pos = _positions(start, t, x.device)
    k_pos = torch.arange(s, device=x.device)
    if q_pos.dim() == 1:
        mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    else:
        mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]
    scores = torch.where(mask, scores,
                         torch.full_like(scores,
                                         torch.finfo(scores.dtype).min))
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    if quantized:
        pv = (probs * layer_v_scale[:, :, None, :]).to(dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", pv, layer_v.to(dtype))
    else:
        out = torch.einsum("bhqk,bhkd->bhqd", probs, layer_v)
    return _attn_mlp_tail(block, x, out, cfg, adapter=adapter)


def _decode_view(params: Params, cfg: gpt2.GPT2Config) -> Params:
    """The serving view of the weights, built once: per-layer dicts with
    the dense weights pre-cast to the compute dtype (LayerNorms keep f32),
    f32 ``wte``/``wpe`` for the embedding lookups, and ``wte_head``, the
    tied head pre-cast once.  Numerically the same casts ``dense`` and
    ``gpt2.head_weight`` would do at every use."""
    def cast(d: Params) -> Params:
        return {"w": d["w"].to(cfg.dtype), "b": d["b"].to(cfg.dtype)}

    layers: List[Params] = []
    for block in gpt2.unstack_blocks(params["blocks"], cfg.n_layer):
        layers.append({
            "ln_1": block["ln_1"], "ln_2": block["ln_2"],
            "attn": {"qkv": cast(block["attn"]["qkv"]),
                     "proj": cast(block["attn"]["proj"])},
            "mlp": {"fc": cast(block["mlp"]["fc"]),
                    "proj": cast(block["mlp"]["proj"])},
        })
    return {"wte": params["wte"], "wpe": params["wpe"],
            "ln_f": params["ln_f"], "layers": layers,
            "wte_head": params["wte"].to(cfg.dtype)}


def _final_logits(view: Params, x: torch.Tensor, cfg: gpt2.GPT2Config,
                  last_pos: Optional[int] = None) -> torch.Tensor:
    """Project one position's activations (the last, or ``last_pos``) to
    f32 logits [B, V]."""
    x_last = x[:, -1] if last_pos is None else x[:, last_pos]
    normed = L.layernorm(view["ln_f"], x_last)
    return (normed.to(cfg.dtype) @ view["wte_head"].T).float()


def _all_logits(view: Params, x: torch.Tensor, cfg: gpt2.GPT2Config
                ) -> torch.Tensor:
    """Every fed position's logits [B, T, V] (the speculative verify
    pass's materialised tail): :func:`_final_logits`' math, row-wise."""
    normed = L.layernorm(view["ln_f"], x)
    return (normed.to(cfg.dtype) @ view["wte_head"].T).float()


def fused_verify_logits(view: Params, x: torch.Tensor, cfg: gpt2.GPT2Config
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel twin of :func:`_all_logits` + the trust epilogue: pre-``ln_f``
    activations [R, T, D] -> (logits [R, T, V] f32, entropy [R*T], margin
    [R*T]) in one pass over the vocab (``ops.paged_attention.
    fused_verify_tail``, B8), against the same ``wte_head``."""
    r, t, d = x.shape
    normed = L.layernorm(view["ln_f"], x).to(cfg.dtype)
    logits, ent, mar = pattn.fused_verify_tail(
        normed.reshape(r * t, d).contiguous(), view["wte_head"])
    return logits.reshape(r, t, -1), ent, mar


def _apply_with_cache(view: Params, tokens: torch.Tensor, cache: KVCache,
                      cfg: gpt2.GPT2Config, last_pos: Optional[int] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """All blocks over ``tokens`` [B, T] from ``cache.length``; returns
    (logits [B, V] of the last position or ``last_pos``, the cache with
    its length advanced).  The cache tensors are written in place."""
    start = cache.length
    t = tokens.shape[-1]
    x = _embed(view, tokens, start, cfg)
    quantized = cache.k_scale is not None
    for i, block in enumerate(view["layers"]):
        x = _block_with_cache(
            block, x, cache.k[i], cache.v[i], start, cfg,
            cache.k_scale[i] if quantized else None,
            cache.v_scale[i] if quantized else None)
    return (_final_logits(view, x, cfg, last_pos),
            cache._replace(length=start + t))


# ---------------------------------------------------------------------------
# Paged read/write path over serve/kv_slots pools [L, NB + 1, H, BLOCK, Dh]
# ---------------------------------------------------------------------------


def _pool_write_coords(table: torch.Tensor, start: torch.Tensor, t: int,
                       bsz: int, nbps: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(positions [R, T], physical block [R*T], in-block offset [R*T]) of
    the T positions each row writes; positions past the slot's table go to
    the trash block 0.  Shared by both paged paths, so they write the same
    values to the same coordinates."""
    pos = _positions(start, t, table.device)                # [R, T]
    lb = pos // bsz
    phys = torch.gather(table.long(), 1, lb.clamp(max=nbps - 1))
    phys = torch.where(lb < nbps, phys, torch.zeros_like(phys))
    return pos, phys.reshape(-1), (pos % bsz).reshape(-1)


def _rows_of(a: torch.Tensor) -> torch.Tensor:
    """[R, H, T(, Dh)] -> [R*T, H(, Dh)], the pool's per-position
    layout."""
    r, h, t = a.shape[:3]
    order = (0, 2, 1) + tuple(range(3, a.dim()))
    return a.permute(*order).reshape(r * t, h, *a.shape[3:])


def _paged_block(block: Params, x: torch.Tensor, pool_k_l: torch.Tensor,
                 pool_v_l: torch.Tensor, table: torch.Tensor,
                 start: torch.Tensor, cfg: gpt2.GPT2Config,
                 attn_impl: str = "kernel",
                 pool_ks_l: Optional[torch.Tensor] = None,
                 pool_vs_l: Optional[torch.Tensor] = None,
                 adapter_l: Optional[tuple] = None) -> torch.Tensor:
    """One block over [R, T, D] new positions against one layer's pool
    (written in place; int8 with scale planes [NB, H, BLOCK] when
    ``pool_ks_l`` is given).  ``start`` is i32 [R] on the pool's device.
    ``adapter_l`` is one layer's adapter pool plus the page row, ``(a_l
    [P+1, 2, D, r], b_l, a_scale_l, b_scale_l, pages i32 [R])``: the
    kernel path hands it to B9 ungathered, the plain path gathers each
    row's pages here."""
    if attn_impl == "kernel":
        return _paged_block_kernel(block, x, pool_k_l, pool_v_l, table,
                                   start, cfg, pool_ks_l, pool_vs_l,
                                   adapter_pool=adapter_l)
    adapter = None
    if adapter_l is not None:
        a_l, b_l, as_l, bs_l, pages = adapter_l
        idx = pages.long()
        adapter = (a_l[idx], b_l[idx],
                   None if as_l is None else as_l[idx],
                   None if bs_l is None else bs_l[idx])
    r, t, _ = x.shape
    nbps = table.shape[1]
    bsz = pool_k_l.shape[2]
    if t > 1:
        # A chunk may run past the logical view (after a prefix hit its
        # start is only block-aligned): pad the table with trash columns
        # so the in-view write never lands on real positions.
        pad = torch.zeros(r, t // bsz + 1, dtype=table.dtype,
                          device=table.device)
        table_read = torch.cat([table, pad], dim=1)
    else:
        table_read = table
    quantized = pool_ks_l is not None
    views = [pattn.gather_pool(p, table_read) for p in
             ((pool_k_l, pool_v_l, pool_ks_l, pool_vs_l) if quantized
              else (pool_k_l, pool_v_l))]
    x = _block_with_cache(block, x, *views[:2], start, cfg, *views[2:],
                          adapter=adapter)
    pos, phys, offs = _pool_write_coords(table_read, start, t, bsz, nbps)
    pools = (pool_k_l, pool_v_l, pool_ks_l, pool_vs_l)
    for pool, view in zip(pools, views):
        idx = pos[:, None, :]
        if view.dim() == 4:
            idx = idx[..., None].expand(-1, view.shape[1], -1,
                                        view.shape[-1])
        else:
            idx = idx.expand(-1, view.shape[1], -1)
        pool[phys, :, offs] = _rows_of(torch.gather(view, 2, idx))
    return x


def _paged_block_kernel(block: Params, x: torch.Tensor,
                        pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
                        table: torch.Tensor, start: torch.Tensor,
                        cfg: gpt2.GPT2Config,
                        pool_ks_l: Optional[torch.Tensor] = None,
                        pool_vs_l: Optional[torch.Tensor] = None,
                        adapter_pool: Optional[tuple] = None
                        ) -> torch.Tensor:
    """Write-then-attend: scatter the fresh K/V into the pool (quantized at
    the write on an int8 pool: the values the plain path writes), then run
    the decode kernel (T <= QROWS) or the chunked-prefill kernel (T >
    QROWS) over the pool; adapter deltas through B9."""
    r, t, _ = x.shape
    q, k, v = _attn_qkv(block, x, cfg)                      # [R, H, T, Dh]
    _, phys, offs = _pool_write_coords(table, start, t, pool_k_l.shape[2],
                                       table.shape[1])
    if pool_ks_l is not None:
        k, k_s = q8.quantize_kv(k)
        v, v_s = q8.quantize_kv(v)
        pool_ks_l[phys, :, offs] = _rows_of(k_s)
        pool_vs_l[phys, :, offs] = _rows_of(v_s)
    pool_k_l[phys, :, offs] = _rows_of(k.to(pool_k_l.dtype))
    pool_v_l[phys, :, offs] = _rows_of(v.to(pool_v_l.dtype))
    if pool_ks_l is not None:
        attend = (pattn.paged_prefill_attention_int8 if t > pattn.QROWS
                  else pattn.paged_attention_int8)
        out = attend(q.contiguous(), pool_k_l, pool_v_l, table, start,
                     pool_ks_l, pool_vs_l)
    else:
        attend = (pattn.paged_prefill_attention if t > pattn.QROWS
                  else pattn.paged_attention)
        out = attend(q.contiguous(), pool_k_l, pool_v_l, table, start)
    return _attn_mlp_tail(block, x, out.to(cfg.dtype), cfg,
                          adapter_pool=adapter_pool)


def _apply_with_cache_paged(view: Params, tokens: torch.Tensor,
                            pool_k: torch.Tensor, pool_v: torch.Tensor,
                            table: torch.Tensor, start: torch.Tensor,
                            cfg: gpt2.GPT2Config,
                            last_pos: Optional[int] = None,
                            attn_impl: str = "kernel",
                            hidden: bool = False,
                            pool_ks: Optional[torch.Tensor] = None,
                            pool_vs: Optional[torch.Tensor] = None,
                            all_logits: bool = False,
                            adapter: Optional[tuple] = None) -> torch.Tensor:
    """All blocks over ``tokens`` [R, T] against the paged pool (updated in
    place; int8 when the scale planes ``pool_ks``/``pool_vs`` [L, NB, H,
    BLOCK] are given), rows starting at ``start`` i32 [R].  Returns logits
    [R, V] of the last position (or ``last_pos``); with ``all_logits``
    every position's [R, T, V] (the verify pass's materialised tail); with
    ``hidden`` the pre-ln_f activations [R, T, D] and no projection.
    ``adapter`` is the adapter pool and page row ``(a [L, P+1, 2, D, r],
    b, a_scale [L, P+1, 2] or None, b_scale, pages i32 [R])``; each layer
    takes its slice."""
    x = _embed(view, tokens, start, cfg)
    quantized = pool_ks is not None
    for i, block in enumerate(view["layers"]):
        adapter_l = None
        if adapter is not None:
            a, b, a_s, b_s, pages = adapter
            adapter_l = (a[i], b[i], None if a_s is None else a_s[i],
                         None if b_s is None else b_s[i], pages)
        x = _paged_block(block, x, pool_k[i], pool_v[i], table, start, cfg,
                         attn_impl, pool_ks[i] if quantized else None,
                         pool_vs[i] if quantized else None, adapter_l)
    if hidden:
        return x
    if all_logits:
        return _all_logits(view, x, cfg)
    return _final_logits(view, x, cfg, last_pos)


def _exact_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, V] -> (values [B, k], indices [B, k]), equal to the first k of
    a stable descending sort: equal values in index order, and of the
    values tied at the k-th, the lowest indices (the order of JAX's
    ``lax.top_k``, whose hierarchical split ``_exact_topk`` in JAX keeps).
    One ``torch.topk`` finds the k-th value; the kept set and its order
    are then fixed without a sort of the vocab or a host sync."""
    b, v = logits.shape
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    above = logits > kth
    tied = logits == kth
    room = k - above.sum(dim=-1, keepdim=True)
    keep = above | (tied & (tied.cumsum(dim=-1) <= room))
    # Each row keeps exactly k entries: scatter their vocab indices, in
    # index order, into k columns (the rest into a spare column k).
    slot = torch.where(keep, keep.cumsum(dim=-1) - 1, k)
    cols = torch.arange(v, device=logits.device).expand(b, v)
    idx = torch.zeros(b, k + 1, dtype=torch.long, device=logits.device)
    idx = idx.scatter(1, slot, cols)[:, :k]
    vals = logits.gather(1, idx)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return vals.gather(1, order), idx.gather(1, order)


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float
                   ) -> torch.Tensor:
    """The logits outside the sampling set set to -inf (JAX's masks):
    top-k masks ``logits < kth``, so every value tied at the k-th stays
    in; then the nucleus keeps the smallest prefix of the sorted
    distribution whose mass reaches ``top_p`` (``cum - p < top_p``),
    mapped back by comparing each probability with the last kept one."""
    if top_k > 0:
        kth = _exact_topk(logits, top_k)[0][:, -1:]
        logits = torch.where(logits < kth, -math.inf, logits)
    if top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        sorted_probs = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sorted_probs, dim=-1)
        keep_sorted = cum - sorted_probs < top_p
        threshold = torch.where(keep_sorted, sorted_probs,
                                math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(probs >= threshold, logits, -math.inf)
    return logits


def _sample(logits: torch.Tensor, temperature: float, top_k: int = 0,
            top_p: float = 1.0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, V] -> [B]: argmax when ``temperature <= 0``; else one draw per
    row from softmax(logits / temperature) restricted to the top ``top_k``
    (0: all) and then to the nucleus of mass ``top_p`` (1: all).  Pure
    top-k draws among the k candidates, the same distribution as the
    masked vocab."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / max(temperature, 1e-6)
    if top_k > 0 and top_p >= 1.0:
        vals, idx = _exact_topk(logits, top_k)
        choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                   generator=generator)
        return idx.gather(1, choice)[:, 0]
    probs = torch.softmax(_filter_logits(logits, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params: Params, cfg: gpt2.GPT2Config, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0, top_k: int = 0,
             top_p: float = 1.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Continue ``prompt`` [B, T] by ``max_new_tokens`` tokens through the
    dense KV cache; returns [B, T + max_new_tokens].  ``temperature=0``
    decodes greedily; ``top_k > 0`` samples among the k most likely
    tokens and ``top_p < 1`` within the nucleus of that mass (top-k
    first, then top-p).  Draws come from ``generator`` (JAX's PRNG
    stream is not reproduced).  Runs on the device ``params`` live on."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    b, t = prompt.shape
    if t + max_new_tokens > cfg.n_positions:
        raise ValueError(f"prompt+new = {t + max_new_tokens} exceeds "
                         f"n_positions={cfg.n_positions}")
    if not 0 <= top_k <= cfg.vocab_size:
        raise ValueError(f"top_k={top_k} out of range [0, vocab_size="
                         f"{cfg.vocab_size}]")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p={top_p} out of range (0, 1]")
    view = _decode_view(params, cfg)
    device = params["wte"].device
    prompt = prompt.to(device)
    cache = init_cache(cfg, b, t + max_new_tokens, device)
    logits, cache = _apply_with_cache(view, prompt, cache, cfg)
    out = [prompt, _sample(logits, temperature, top_k, top_p,
                           generator)[:, None]]
    for _ in range(max_new_tokens - 1):
        logits, cache = _apply_with_cache(view, out[-1], cache, cfg)
        out.append(_sample(logits, temperature, top_k, top_p,
                           generator)[:, None])
    return torch.cat(out, dim=1)
