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
order.  It takes K and N multiples of 16 and any M >= 1
(:func:`dequant_kernel_limit`, the one statement of its limits, read
before every launch and by ``ServingEngine`` when it is built on the
card); an f32 ``x`` on the card raises (the serving path always feeds
the compute dtype, bf16 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch

from trustworthy_dl_tpu_torch.ops import (check_launch, kernel_library,
                                          on_cuda, stream_handle,
                                          tally_flops)

#: The kernel's K and N granularity: K in k16 blocks of the tensor-core
#: product, N in 16-byte copies of int8 weight columns.
MULTIPLE = 16
#: Rows one launch takes: 65,535 M tiles of 64 rows (the grid's z).
MAX_ROWS = 65535 * 64


def dequant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """f32 ``x @ w_q`` times the column scales."""
    return (x.float() @ w_q.float()) * scale.float()


def dequant_matmul_flops(m: int, k: int, n: int) -> int:
    """Product FLOPs of B4 at [M, K] x [K, N]: 2 M K N, as
    ``torch.utils.flop_counter`` counts :func:`dequant_matmul_plain`."""
    return 2 * m * k * n


def dequant_kernel_limit(k: int, n: int, x_dtype: torch.dtype
                         ) -> Optional[str]:
    """Why B4 cannot take ``x`` in ``x_dtype`` against an int8 ``[k, n]``
    weight, or None when it can: bf16 x, K and N positive multiples of
    :data:`MULTIPLE` (M is free).  The launch check and the engine's
    check at construction both read it, so the two cannot drift."""
    if x_dtype != torch.bfloat16:
        return f"x must be bf16 on the card, got {x_dtype}"
    if k < 1 or k % MULTIPLE:
        return f"K={k} must be a positive multiple of {MULTIPLE}"
    if n < 1 or n % MULTIPLE:
        return f"N={n} must be a positive multiple of {MULTIPLE}"
    return None


def dequant_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                   ) -> torch.Tensor:
    """``[M, K] @ int8 [K, N] * f32 [N] -> f32 [M, N]`` (B4 on the card)."""
    if not on_cuda(x, "dequant_matmul"):
        return dequant_matmul_plain(x, w_q, scale)
    if x.dim() != 2:
        raise ValueError(f"dequant_matmul: x must be [M, K], got "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[0] != k:
        raise ValueError(f"dequant_matmul: w_q must be int8 [{k}, N], got "
                         f"{w_q.dtype} {tuple(w_q.shape)}")
    n = w_q.shape[1]
    if scale.dtype != torch.float32 or scale.shape != (n,):
        raise ValueError(f"dequant_matmul: scale must be f32 [{n}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    limit = dequant_kernel_limit(k, n, x.dtype)
    if limit is not None:
        raise ValueError(f"dequant_matmul: {limit}")
    if not 1 <= m <= MAX_ROWS:
        raise ValueError(f"dequant_matmul: M={m} outside [1, {MAX_ROWS}]")
    for name, a in (("x", x), ("w_q", w_q), ("scale", scale)):
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"dequant_matmul: {name} must be contiguous on "
                             f"{x.device}")
        if a.data_ptr() % 16:
            # The kernel copies x, w_q and scale 16 bytes at a time.
            raise ValueError(f"dequant_matmul: {name} must be 16-byte "
                             "aligned")
    lib = kernel_library("fused_dequant_matmul")
    out = torch.empty(m, n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tddl_dequant_matmul(x.data_ptr(), w_q.data_ptr(),
                                      scale.data_ptr(), out.data_ptr(), m, k,
                                      n, stream_handle(x.device))
    check_launch(lib, err, "tddl_dequant_matmul")
    dequant_matmul.launches += 1
    tally_flops("dequant_matmul", dequant_matmul_flops(m, k, n))
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

__all__ = ["KERNEL_WRAPPERS", "MAX_ROWS", "MULTIPLE", "dequant_kernel_limit",
           "dequant_matmul", "dequant_matmul_flops", "dequant_matmul_plain",
           "lowrank_delta"]
