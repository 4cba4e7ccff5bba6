"""Primitive layers as plain functions over parameter dicts.

Counterpart of ``trustworthy_dl_tpu/models/layers.py``.  Weights keep the
JAX layout (a dense ``w`` is [in, out], a conv ``w`` is [kh, kw, in, out])
and images are NHWC at the API, so converted parameters are used as they
are.  Inside, a conv runs on the NCHW view of the NHWC tensor (PyTorch's
``channels_last``) with the weight permuted to match.

The convolutional layers follow JAX's dtype flow: a conv runs in the
compute dtype it is given (bias added in that dtype), GroupNorm normalises
in its input's dtype and its f32 scale and bias promote the result to f32,
and the next conv casts back.  GroupNorm stands in for BatchNorm, as in
JAX: batch statistics would couple the nodes outside the trust-gated
aggregation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def uniform_scaling_init(generator: torch.Generator, shape: Tuple[int, ...],
                         scale: float, device: Any = "cpu") -> torch.Tensor:
    """normal(``scale``) f32 draws of ``shape`` from ``generator`` (JAX's
    takes a key)."""
    return torch.randn(*shape, generator=generator, device=device) * scale


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               scale: Optional[float] = None, device: Any = "cpu") -> Params:
    """normal(1 / sqrt(in_dim)) weights (or ``scale``), zero bias."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    return {"w": uniform_scaling_init(generator, (in_dim, out_dim), scale,
                                      device),
            "b": torch.zeros(out_dim, device=device)}


def dense(params: Params, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x @ w + b`` in ``dtype``: the bias is added in the compute dtype,
    after the product is rounded to it, as the JAX spelling does."""
    return x @ params["w"].to(dtype) + params["b"].to(dtype)


def layernorm_init(dim: int, device: Any = "cpu") -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    """LayerNorm over the last axis, computed in f32 (returns f32)."""
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


def groupnorm_init(channels: int, device: Any = "cpu") -> Params:
    return {"scale": torch.ones(channels, device=device),
            "bias": torch.zeros(channels, device=device)}


def groupnorm(params: Params, x: torch.Tensor, groups: int = 8,
              eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of [..., H, W, C] ``x`` over (H, W, C / groups):
    ``groups`` is lowered until it divides C.  Normalises in ``x``'s
    dtype; the f32 scale and bias make the result f32."""
    c = x.shape[-1]
    groups = min(groups, c)
    while c % groups:
        groups -= 1
    xs = x.reshape((-1,) + tuple(x.shape[-3:])).movedim(-1, 1)
    # The aten op: F.group_norm refuses a group of one value (one sample's
    # 1x1 map of a one-channel group), which normalises to 0 in JAX.
    y = torch.group_norm(xs, groups, None, None, eps).movedim(1, -1)
    y = y.reshape(x.shape)
    return y * params["scale"] + params["bias"]


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int, device: Any = "cpu") -> Params:
    """He-normal [kh, kw, cin, cout] weights, zero bias."""
    scale = math.sqrt(2.0 / (kh * kw * cin))
    return {"w": uniform_scaling_init(generator, (kh, kw, cin, cout),
                                      scale, device),
            "b": torch.zeros(cout, device=device)}


def embedding_init(generator: torch.Generator, vocab: int, dim: int,
                   device: Any = "cpu") -> torch.Tensor:
    """normal(0.02) [vocab, dim] f32 embeddings."""
    return uniform_scaling_init(generator, (vocab, dim), 0.02, device)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one axis as (low, high): the total
    ``max((out - 1) * stride + kernel - size, 0)`` for ``out =
    ceil(size / stride)``, the odd pixel on the high side (a 3x3 stride-2
    conv on 32 pads (0, 1), a 7x7 stride-2 conv on 224 pads (2, 3))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(params: Params, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME", dtype: torch.dtype = torch.float32
           ) -> torch.Tensor:
    """NHWC conv with HWIO weights in ``dtype``, bias added in ``dtype``.
    ``padding`` is "SAME" (XLA's, asymmetric where the total is odd) or
    "VALID"."""
    w = params["w"].to(dtype)
    kh, kw = int(w.shape[0]), int(w.shape[1])
    xc = x.to(dtype).movedim(-1, 1)              # NCHW view of NHWC
    pad: Any = 0
    if padding == "SAME":
        ph = same_padding(int(xc.shape[2]), kh, stride)
        pw = same_padding(int(xc.shape[3]), kw, stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                         f"{padding!r}")
    # OIHW view of the HWIO weight, stored channels-last like x.
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc, wc, stride=stride, padding=pad).movedim(1, -1)
    return y + params["b"].to(dtype)


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2
             ) -> torch.Tensor:
    """VALID max pooling of NHWC ``x``."""
    return F.max_pool2d(x.movedim(-1, 1), window, stride).movedim(1, -1)


def avg_pool_global(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W of NHWC ``x``."""
    return x.mean(dim=(-3, -2))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor
                       ) -> torch.Tensor:
    """Mean token cross-entropy, ``logsumexp(logits) - logits[target]`` in
    f32 (one fused reduction, no second [..., V] tensor)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def accuracy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Share of positions whose argmax is the target (f32 [])."""
    return (logits.argmax(dim=-1) == targets).float().mean()
