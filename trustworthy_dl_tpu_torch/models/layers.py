"""Primitive layers as plain functions over parameter dicts.

Counterpart of ``trustworthy_dl_tpu/models/layers.py``.  Weights keep the
JAX layout (``w`` is [in, out]) so converted parameters are used as they
are.
"""

from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def dense(params: Params, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w + b`` in ``dtype``: the bias is added in the compute dtype,
    after the product is rounded to it, as the JAX spelling does."""
    return x @ params["w"].to(dtype) + params["b"].to(dtype)


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (returns f32)."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]
