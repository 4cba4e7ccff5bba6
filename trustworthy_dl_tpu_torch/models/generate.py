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

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn

Params = Dict[str, Any]
Start = Union[int, torch.Tensor]

#: Paged attention paths (see the module docstring).
ATTN_IMPLS = ("kernel", "plain")


class KVCache(NamedTuple):
    k: torch.Tensor       # [L, B, H, S, Dh]
    v: torch.Tensor       # [L, B, H, S, Dh]
    # Valid positions: an int shared by every row, or i64 [B] per row.
    length: Start


def init_cache(cfg: gpt2.GPT2Config, batch: int, max_len: int,
               device: Any = "cpu") -> KVCache:
    shape = (cfg.n_layer, batch, cfg.n_head, max_len, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=device),
                   length=0)


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
    """Write [B, H, T, Dh] rows into the [B, H, S, Dh] cache at ``start``
    (int: every row at one offset; tensor [B]: each row at its own)."""
    t = new.shape[2]
    new = new.to(layer_kv.dtype)
    if not isinstance(start, torch.Tensor):
        layer_kv[:, :, start:start + t] = new
        return
    idx = _positions(start, t, layer_kv.device)              # [B, T]
    rows = torch.arange(layer_kv.shape[0], device=layer_kv.device)[:, None]
    layer_kv[rows, :, idx] = new.permute(0, 2, 1, 3)


def _attn_qkv(block: Params, x: torch.Tensor, cfg: gpt2.GPT2Config
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln_1 + fused qkv projection + head split: [B, T, D] -> q, k, v
    [B, H, T, Dh] in the compute dtype."""
    y = L.layernorm(block["ln_1"], x).to(cfg.dtype)
    qkv = L.dense(block["attn"]["qkv"], y, cfg.dtype)
    q, k, v = qkv.split(cfg.n_embd, dim=-1)
    return tuple(gpt2.split_heads(a, cfg.n_head) for a in (q, k, v))


def _attn_mlp_tail(block: Params, x: torch.Tensor, out: torch.Tensor,
                   cfg: gpt2.GPT2Config) -> torch.Tensor:
    """Merge heads, attention projection + residual, MLP + residual."""
    b, t, d = x.shape
    out = out.permute(0, 2, 1, 3).reshape(b, t, d)
    x = x + L.dense(block["attn"]["proj"], out, cfg.dtype).to(x.dtype)
    return x + gpt2.mlp(block, x, cfg.dtype).to(x.dtype)


def _block_with_cache(block: Params, x: torch.Tensor,
                      layer_k: torch.Tensor, layer_v: torch.Tensor,
                      start: Start, cfg: gpt2.GPT2Config) -> torch.Tensor:
    """One block over [B, T, D] new positions: writes their K/V into the
    cache [B, H, S, Dh] at ``start`` (in place), then attends causally to
    cache positions [0, start + t]."""
    t = x.shape[1]
    s = layer_k.shape[-2]
    q, k, v = _attn_qkv(block, x, cfg)
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
    probs = torch.softmax(scores.float(), dim=-1).to(cfg.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, layer_v)
    return _attn_mlp_tail(block, x, out, cfg)


def _decode_view(params: Params, cfg: gpt2.GPT2Config) -> Params:
    """The serving view of the weights, built once: per-layer dicts with
    the dense weights pre-cast to the compute dtype (LayerNorms keep f32),
    f32 ``wte``/``wpe`` for the embedding lookups, and ``wte_head``, the
    tied head pre-cast once.  Numerically the same casts ``dense`` and
    ``project_logits`` would do at every use."""
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


def _apply_with_cache(view: Params, tokens: torch.Tensor, cache: KVCache,
                      cfg: gpt2.GPT2Config, last_pos: Optional[int] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """All blocks over ``tokens`` [B, T] from ``cache.length``; returns
    (logits [B, V] of the last position or ``last_pos``, the cache with
    its length advanced).  The cache tensors are written in place."""
    start = cache.length
    t = tokens.shape[-1]
    x = _embed(view, tokens, start, cfg)
    for i, block in enumerate(view["layers"]):
        x = _block_with_cache(block, x, cache.k[i], cache.v[i], start, cfg)
    return (_final_logits(view, x, cfg, last_pos),
            cache._replace(length=start + t))


# ---------------------------------------------------------------------------
# Paged read/write path over serve/kv_slots pools [L, NB + 1, H, BLOCK, Dh]
# ---------------------------------------------------------------------------


def _paged_gather(layer_pool: torch.Tensor, table: torch.Tensor
                  ) -> torch.Tensor:
    """[NB, H, BLOCK, Dh] pool + [R, NBPS] table -> a contiguous copy of
    each row's view [R, H, NBPS * BLOCK, Dh]."""
    g = layer_pool[table.long()]                   # [R, NBPS, H, BLOCK, Dh]
    r, nbps, h, bsz, dh = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(r, h, nbps * bsz, dh)


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
    """[R, H, T, Dh] -> [R*T, H, Dh], the pool's per-position layout."""
    r, h, t, dh = a.shape
    return a.permute(0, 2, 1, 3).reshape(r * t, h, dh)


def _paged_block(block: Params, x: torch.Tensor, pool_k_l: torch.Tensor,
                 pool_v_l: torch.Tensor, table: torch.Tensor,
                 start: torch.Tensor, cfg: gpt2.GPT2Config,
                 attn_impl: str = "kernel") -> torch.Tensor:
    """One block over [R, T, D] new positions against one layer's pool
    (written in place).  ``start`` is i32 [R] on the pool's device."""
    if attn_impl == "kernel":
        return _paged_block_kernel(block, x, pool_k_l, pool_v_l, table,
                                   start, cfg)
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
    view_k = _paged_gather(pool_k_l, table_read)
    view_v = _paged_gather(pool_v_l, table_read)
    x = _block_with_cache(block, x, view_k, view_v, start, cfg)
    pos, phys, offs = _pool_write_coords(table_read, start, t, bsz, nbps)
    idx = pos[:, None, :, None].expand(-1, view_k.shape[1], -1,
                                       view_k.shape[-1])
    pool_k_l[phys, :, offs] = _rows_of(torch.gather(view_k, 2, idx))
    pool_v_l[phys, :, offs] = _rows_of(torch.gather(view_v, 2, idx))
    return x


def _paged_block_kernel(block: Params, x: torch.Tensor,
                        pool_k_l: torch.Tensor, pool_v_l: torch.Tensor,
                        table: torch.Tensor, start: torch.Tensor,
                        cfg: gpt2.GPT2Config) -> torch.Tensor:
    """Write-then-attend: scatter the fresh K/V into the pool, then run the
    decode kernel (T <= QROWS) or the chunked-prefill kernel (T > QROWS)
    over the pool."""
    r, t, _ = x.shape
    q, k, v = _attn_qkv(block, x, cfg)                      # [R, H, T, Dh]
    _, phys, offs = _pool_write_coords(table, start, t, pool_k_l.shape[2],
                                       table.shape[1])
    pool_k_l[phys, :, offs] = _rows_of(k.to(pool_k_l.dtype))
    pool_v_l[phys, :, offs] = _rows_of(v.to(pool_v_l.dtype))
    attend = (pattn.paged_prefill_attention if t > pattn.QROWS
              else pattn.paged_attention)
    out = attend(q.contiguous(), pool_k_l, pool_v_l, table, start)
    return _attn_mlp_tail(block, x, out.to(cfg.dtype), cfg)


def _apply_with_cache_paged(view: Params, tokens: torch.Tensor,
                            pool_k: torch.Tensor, pool_v: torch.Tensor,
                            table: torch.Tensor, start: torch.Tensor,
                            cfg: gpt2.GPT2Config,
                            last_pos: Optional[int] = None,
                            attn_impl: str = "kernel",
                            hidden: bool = False) -> torch.Tensor:
    """All blocks over ``tokens`` [R, T] against the paged pool (updated in
    place), rows starting at ``start`` i32 [R].  Returns logits [R, V] of
    the last position (or ``last_pos``), or with ``hidden`` the pre-ln_f
    activations [R, T, D] and no projection."""
    x = _embed(view, tokens, start, cfg)
    for i, block in enumerate(view["layers"]):
        x = _paged_block(block, x, pool_k[i], pool_v[i], table, start, cfg,
                         attn_impl)
    if hidden:
        return x
    return _final_logits(view, x, cfg, last_pos)


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """[B, V] -> [B]: argmax when ``temperature <= 0``, else one draw per
    row from softmax(logits / temperature)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(params: Params, cfg: gpt2.GPT2Config, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Continue ``prompt`` [B, T] by ``max_new_tokens`` tokens through the
    dense KV cache; returns [B, T + max_new_tokens].  ``temperature=0``
    decodes greedily.  Runs on the device ``params`` live on."""
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    b, t = prompt.shape
    if t + max_new_tokens > cfg.n_positions:
        raise ValueError(f"prompt+new = {t + max_new_tokens} exceeds "
                         f"n_positions={cfg.n_positions}")
    view = _decode_view(params, cfg)
    device = params["wte"].device
    prompt = prompt.to(device)
    cache = init_cache(cfg, b, t + max_new_tokens, device)
    logits, cache = _apply_with_cache(view, prompt, cache, cfg)
    out = [prompt, _sample(logits, temperature, generator)[:, None]]
    for _ in range(max_new_tokens - 1):
        logits, cache = _apply_with_cache(view, out[-1], cache, cfg)
        out.append(_sample(logits, temperature, generator)[:, None])
    return torch.cat(out, dim=1)
