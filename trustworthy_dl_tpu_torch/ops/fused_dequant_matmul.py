"""Weight-only int8 dequant matmul (B4): ``y = (x @ w_q) * scale``, and
the adapter tier's gathered low-rank delta (``lowrank_delta``, plain
torch).

Counterpart of ``trustworthy_dl_tpu/ops/fused_dequant_matmul.py``
(``dequant_matmul`` and ``lowrank_delta``).  ``x`` [M, K] float, ``w_q`` int8 [K, N], ``scale`` f32
[N] -> f32 [M, N], accumulated in f32.  The wrapper takes CPU tensors to
the plain twin and CUDA tensors to the hand-written kernel in
``csrc/fused_dequant_matmul.cu`` (its note says what it replaces, what
bounds it and how its design answers that).

The kernel takes a bf16 ``x`` only: bf16 times an int8 value is exact in
f32 and int8 values are exact in bf16, so its bf16 tensor-core product
with f32 accumulation is the JAX package's f32 product up to summation
order.  An f32 ``x`` on the card raises (the serving path always feeds
the compute dtype, bf16 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from trustworthy_dl_tpu_torch.ops import (check_launch, kernel_library,
                                          on_cuda, stream_handle)

#: The kernel's N and K granularity (one CTA per 64-column N tile and
#: 64-row M tile; K walked in 64-deep chunks).
TILE = 64


def dequant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ w_q`` times the column scales."""
    return (x.float() @ w_q.float()) * scale.float()


def dequant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    """``[M, K] @ int8 [K, N] * f32 [N] -> f32 [M, N]`` (B4 on the card)."""
    if not on_cuda(x, "dequant_matmul"):
        return dequant_matmul_plain(x, w_q, scale)
    if x.dtype != torch.bfloat16 or x.dim() != 2:
        raise ValueError("dequant_matmul: x must be bf16 [M, K] on the card, "
                         f"got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"dequant_matmul: w_q must be int8 [{k}, N], got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    n = w_q.shape[1]
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"dequant_matmul: scale must be f32 [{n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if m < 1 or k % TILE or n % TILE:
        raise ValueError(f"dequant_matmul: K={k} and N={n} must be multiples "
                         f"of {TILE} and M={m} >= 1")
    for name, a in (("x", x), ("w_q", w_q), ("scale", scale)):
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"dequant_matmul: {name} must be contiguous on "
                             f"{x.device}")
    lib = kernel_library("fused_dequant_matmul")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tddl_dequant_matmul(x.data_ptr(), w_q.data_ptr(),
                                      scale.data_ptr(), out.data_ptr(), m, k,
                                      n, stream_handle(x.device))
    check_launch(lib, err, "tddl_dequant_matmul")
    dequant_matmul.launches += 1
    return out


dequant_matmul.launches = 0

def lowrank_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  a_scale: Optional[torch.Tensor] = None,
                  b_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched gathered low-rank delta ``(x @ A) @ B`` for the paged adapter
    tier, one site at a time::

        x [R, T, D] @ a [R, D, r] -> h [R, T, r] @ b [R, r, D] -> f32

    ``a``/``b`` are each row's gathered pool page (model dtype, or int8
    with per-row scales [R]).  Accumulation is f32; ``a_scale`` multiplies
    ``h`` between the two contractions and ``b_scale`` the result, the
    JAX order exactly (folding the two would change the f32 rounding)."""
    h = torch.einsum("rtd,rdk->rtk", x.float(), a.float())
    if a_scale is not None:
        h = h * a_scale.float()[:, None, None]
    out = torch.einsum("rtk,rkd->rtd", h, b.float())
    if b_scale is not None:
        out = out * b_scale.float()[:, None, None]
    return out


#: The kernels of this module, by the wrapper that launches each.
KERNEL_WRAPPERS = (dequant_matmul,)

__all__ = ["KERNEL_WRAPPERS", "TILE", "dequant_matmul",
           "dequant_matmul_plain", "lowrank_delta"]
