"""Symmetric int8 quantization for the serving engine.

Counterpart of ``trustworthy_dl_tpu/quant/int8.py``.  Two tiers:

* **KV-cache int8**: K/V rows store int8 with a per-(head, position) f32
  scale.  The scale of a cached key is constant along the contracted Dh
  axis, so it multiplies the score after the int8 dot product; a cached
  value's scale folds into the attention probabilities before the PV
  contraction.  No dequantized copy of the cache is ever made.
* **Weight-only int8** for the four block matrices: per-output-channel
  symmetric scales, so ``x @ w`` runs against the int8 weight and one f32
  multiply per output column follows (``ops.fused_dequant_matmul``, B4).
  The embedding, position table, layernorms and the tied head keep the
  precision of the decode view.

The int8 values and scales equal the JAX package's bit for bit: the same
f32 division and round-half-to-even (``torch.round``, as ``jnp.rint``).
Error contract: per-element error <= amax / 254; an all-zero channel keeps
scale 0 and dequantizes to exact zeros.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import torch

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.ops.fused_dequant_matmul import (
    dequant_kernel_limit, dequant_matmul)

logger = logging.getLogger(__name__)

Params = Dict[str, Any]

#: Accepted ServeConfig / engine dtype knob values.  "model" follows the
#: model's compute dtype.
KV_DTYPES = ("model", "bfloat16", "float32", "int8")
WEIGHT_DTYPES = ("model", "int8")

#: Largest int8 magnitude of the symmetric scheme (clip to [-127, 127]).
QMAX = 127.0

#: A greedy token flip is tolerated only where the reference path's own
#: top-1 margin is below this (a near tie, where any change of numerics
#: can flip the argmax).  A decisive flip fails the parity probe.
PARITY_MARGIN_TOL = 0.05


def validate_dtypes(kv_dtype: str, weight_dtype: str) -> None:
    """Fail where the operator typed an unknown dtype string."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    if weight_dtype not in WEIGHT_DTYPES:
        raise ValueError(
            f"weight_dtype must be one of {WEIGHT_DTYPES}, got "
            f"{weight_dtype!r}")


def resolve_kv_dtype(kv_dtype: str, cfg: gpt2.GPT2Config) -> torch.dtype:
    """The pool's storage dtype for a ``kv_dtype`` string (``torch.int8``
    selects the quantized pool)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(
            f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return {"model": cfg.dtype, "bfloat16": torch.bfloat16,
            "float32": torch.float32, "int8": torch.int8}[kv_dtype]


# ---------------------------------------------------------------------------
# Symmetric per-channel quantize / dequantize
# ---------------------------------------------------------------------------


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce |max| over ``axis``: returns ``(q int8, scale f32)`` with
    ``scale = amax / 127`` shaped like ``x`` minus ``axis``."""
    x = x.float()
    amax = x.abs().amax(dim=axis)
    scale = amax / QMAX
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.round(x / safe.unsqueeze(axis)).clamp(-QMAX, QMAX)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, axis: int = -1,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` up to the rounding error."""
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


def quantize_kv(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K or V rows ``[..., Dh]`` per cached position (scale over Dh)."""
    return quantize_int8(kv, axis=-1)


# ---------------------------------------------------------------------------
# Weight-only int8 decode view
# ---------------------------------------------------------------------------


def quantize_dense(d: Params) -> Params:
    """``{"w": [in, out], "b"}`` -> ``{"w_q": int8 [in, out], "scale": f32
    [out], "b"}``: per-output-channel, reduced over ``in``."""
    q, scale = quantize_int8(d["w"].float(), axis=-2)
    return {"w_q": q.contiguous(), "scale": scale.contiguous(),
            "b": d["b"]}


def is_quantized_dense(d: Params) -> bool:
    return isinstance(d, dict) and "w_q" in d


def qdense(d: Params, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense dispatcher: ``{"w", "b"}`` goes through ``layers.dense``;
    ``{"w_q", "scale", "b"}`` through the dequant matmul (B4 on a CUDA
    tensor, its plain twin on the CPU), rounded to ``dtype`` before the
    bias as the JAX spelling does."""
    if not is_quantized_dense(d):
        return L.dense(d, x, dtype)
    lead = x.shape[:-1]
    y = dequant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), d["w_q"],
                       d["scale"])
    return y.reshape(*lead, -1).to(dtype) + d["b"].to(dtype)


_MATRICES = (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc"),
             ("mlp", "proj"))


def block_matrix_shapes(cfg: gpt2.GPT2Config) -> Dict[str, Tuple[int, int]]:
    """``[in, out]`` of the four block matrices the int8 tier quantizes."""
    d = cfg.n_embd
    return {"qkv": (d, 3 * d), "attn_proj": (d, d), "fc": (d, 4 * d),
            "mlp_proj": (4 * d, d)}


def dequant_engine_limit(cfg: gpt2.GPT2Config, weight_dtype: str,
                         spec_k: int) -> Optional[str]:
    """Why an engine on the card cannot run B4, or None when it can or
    never reaches it.  B4 runs every int8 block matrix: under
    ``weight_dtype="int8"`` and in the int8 self-draft of ``spec_k > 0``,
    with ``x`` in the compute dtype.  A pure function of its arguments
    (``ServingEngine`` reads it before it allocates anything)."""
    if weight_dtype != "int8" and spec_k <= 0:
        return None
    for name, (k, n) in block_matrix_shapes(cfg).items():
        limit = dequant_kernel_limit(k, n, cfg.dtype)
        if limit is not None:
            return f"{name} [{k}, {n}]: {limit}"
    return None


def quantize_decode_view(params: Params, cfg: gpt2.GPT2Config,
                         view: Optional[Params] = None) -> Params:
    """Weight-only int8 decode view: the four block matrices of every layer
    carry int8 weights and f32 scales, quantized from the dense decode
    view (so from the compute-dtype weights, as the JAX package does);
    everything else is the dense view's.  Pass ``view`` when the dense
    view exists already."""
    from trustworthy_dl_tpu_torch.models import generate as gen

    if view is None:
        view = gen._decode_view(params, cfg)
    layers = []
    for layer in view["layers"]:
        q = dict(layer)
        q["attn"] = {"qkv": quantize_dense(layer["attn"]["qkv"]),
                     "proj": quantize_dense(layer["attn"]["proj"])}
        q["mlp"] = {"fc": quantize_dense(layer["mlp"]["fc"]),
                    "proj": quantize_dense(layer["mlp"]["proj"])}
        layers.append(q)
    out = dict(view)
    out["layers"] = layers
    return out


def draft_decode_view(params: Params, cfg: gpt2.GPT2Config,
                      dense_view: Optional[Params] = None,
                      qview: Optional[Params] = None) -> Params:
    """The int8 self-draft of speculative decoding: the served weights at
    the weight-only int8 tier.  ``qview`` (an int8 view already built) is
    returned as it is; else ``dense_view`` is quantized."""
    if qview is not None:
        return qview
    return quantize_decode_view(params, cfg, view=dense_view)


def weight_roundtrip_errors(params: Params, cfg: gpt2.GPT2Config,
                            qview: Optional[Params] = None) -> List[float]:
    """Max relative quantization error per block matrix over all layers,
    ``max|w - deq(q(w))| / max|w|``, against the f32 master weights.
    ``qview`` reuses its ``w_q``/``scale``."""
    errs: List[float] = []
    blocks = params["blocks"]
    for group, name in _MATRICES:
        w = blocks[group][name]["w"].float()              # [L, in, out]
        if qview is not None:
            q = torch.stack([l[group][name]["w_q"] for l in qview["layers"]])
            scale = torch.stack([l[group][name]["scale"]
                                 for l in qview["layers"]])
        else:
            q, scale = quantize_int8(w, axis=-2)
        err = (w - q.float() * scale[..., None, :]).abs().max()
        denom = torch.clamp(w.abs().max(), min=1e-12)
        errs.append(float(err / denom))
    return errs


# ---------------------------------------------------------------------------
# Parity gate in front of the int8 KV swap
# ---------------------------------------------------------------------------


def kv_parity_report(view: Params, cfg: gpt2.GPT2Config, prompt_len: int = 8,
                     decode_tokens: int = 4) -> List[Dict[str, Any]]:
    """Greedy decode of a fixed prompt twice, full-precision KV and int8
    KV over the same weight view, the reference token teacher-forced into
    both at every step.  One record per step: both argmax tokens and the
    reference top-1 margin."""
    from trustworthy_dl_tpu_torch.models import generate as gen

    device = view["wte"].device
    max_len = prompt_len + decode_tokens
    prompt = (torch.arange(prompt_len, device=device)
              % cfg.vocab_size)[None, :]
    ref_cache = gen.init_cache(cfg, 1, max_len, device)
    q_cache = gen.init_cache(cfg, 1, max_len, device, kv_dtype=torch.int8)
    with torch.no_grad():
        ref_logits, ref_cache = gen._apply_with_cache(view, prompt, ref_cache,
                                                      cfg)
        q_logits, q_cache = gen._apply_with_cache(view, prompt, q_cache, cfg)
        records = []
        for step in range(decode_tokens):
            top2 = torch.topk(ref_logits[0], 2).values
            ref_tok = int(ref_logits[0].argmax())
            records.append({"ref_token": ref_tok,
                            "int8_token": int(q_logits[0].argmax()),
                            "margin": float(top2[0] - top2[1])})
            if step == decode_tokens - 1:
                break
            tok = torch.tensor([[ref_tok]], device=device)
            ref_logits, ref_cache = gen._apply_with_cache(view, tok,
                                                          ref_cache, cfg)
            q_logits, q_cache = gen._apply_with_cache(view, tok, q_cache, cfg)
    return records


def kv_parity_probe(view: Params, cfg: gpt2.GPT2Config, prompt_len: int = 8,
                    decode_tokens: int = 4) -> bool:
    """Construction-time gate of the int8 KV pool: every greedy token of
    :func:`kv_parity_report` agrees, or flips only at a reference margin
    below :data:`PARITY_MARGIN_TOL`."""
    for rec in kv_parity_report(view, cfg, prompt_len, decode_tokens):
        if (rec["int8_token"] != rec["ref_token"]
                and rec["margin"] >= PARITY_MARGIN_TOL):
            logger.warning(
                "int8 KV parity probe failed: greedy token %d != %d at "
                "top-1 margin %.4f (tolerance %.4f)", rec["int8_token"],
                rec["ref_token"], rec["margin"], PARITY_MARGIN_TOL)
            return False
    return True


__all__ = [
    "KV_DTYPES", "PARITY_MARGIN_TOL", "QMAX", "WEIGHT_DTYPES",
    "block_matrix_shapes", "dequant_engine_limit", "dequantize_int8",
    "draft_decode_view", "is_quantized_dense",
    "kv_parity_probe", "kv_parity_report", "qdense", "quantize_decode_view",
    "quantize_dense", "quantize_int8", "quantize_kv", "resolve_kv_dtype",
    "validate_dtypes", "weight_roundtrip_errors",
]
