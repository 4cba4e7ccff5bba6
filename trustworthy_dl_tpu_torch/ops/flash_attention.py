"""Causal flash attention: forward (B2) and backward (B3) behind one
``torch.autograd.Function``.

Counterpart of ``trustworthy_dl_tpu/ops/flash_attention.py``.  Layout
[BH, T, D] with batch and heads merged, as the JAX wrapper does.  Each
wrapper takes CPU tensors to its plain PyTorch twin (``*_plain``) and CUDA
tensors to its hand-written kernel in ``csrc/flash_attention.cu`` (see the
note there for what each kernel replaces, its bound and its design):

* :func:`flash_attention_fwd` -> (o, lse f32 [BH, T]);
* :func:`flash_attention_bwd_dq` -> dq;
* :func:`flash_attention_bwd_dkv` -> (dk, dv),

each with a plain integer ``launches`` that it increments where it launches
its kernel and nowhere else; there it also adds its kernel's products
(``flash_*_flops``) to an open FLOP tally (``ops.count_kernel_flops``).  The backward takes Delta = sum(dO * O) per
row from a plain reduction, as the JAX package leaves it to XLA.

The kernels take bf16 on the card, T a multiple of 64 and D in
:data:`HEAD_DIMS`; anything else raises ``ValueError``.  Unlike the JAX
wrapper, :func:`flash_attention` does not fall back to full attention on a
shape the kernel does not take: an explicit ``attn_impl="flash"`` there is
an error, and ``"auto"`` only picks flash where the kernel runs.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from trustworthy_dl_tpu_torch.ops import check_launch, kernel_library, \
    on_cuda, stream_handle, tally_flops

NEG_INF = -1e30
#: Query/key tile of the kernels: T must be a multiple of it.
TILE = 64
#: Head dimensions the kernels are built for.
HEAD_DIMS = (16, 32, 64, 128)


def supports_flash(t: int, d: int) -> bool:
    """THE kernel-eligibility predicate on shapes, shared by the wrapper
    and the ``auto`` dispatch."""
    return t >= TILE and t % TILE == 0 and d in HEAD_DIMS


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """f32 causal scores [BH, T, T] scaled by 1/sqrt(D), NEG_INF masked."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded through ``dtype``, where the kernels (like the TPU
    kernels) cast probabilities and dS to the input dtype before a
    product; a no-op for f32 inputs."""
    return x.to(dtype).float()


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, lse f32 [BH, T]): the forward kernel's function,
    spelled over the whole [T, T] score matrix."""
    s = _scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bts,bsd->btd", _rounded(p, v.dtype), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_dscores(q, k, v, lse, do, delta):
    """(P, dS) rounded through the input dtype as the kernels use them."""
    p = torch.exp(_scores(q, k) - lse[..., None])
    dp = torch.einsum("btd,bsd->bts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    return _rounded(p, q.dtype), _rounded(ds, q.dtype)


def flash_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: torch.Tensor) -> torch.Tensor:
    """dq = scale * (P o (dO.V^T - Delta)) . K, P = exp(S - lse)."""
    _, ds = _probs_and_dscores(q, k, v, lse, do, delta)
    dq = torch.einsum("bts,bsd->btd", ds, k.float()) / math.sqrt(q.shape[-1])
    return dq.to(q.dtype)


def flash_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) = (scale * dS^T . Q, P^T . dO)."""
    p, ds = _probs_and_dscores(q, k, v, lse, do, delta)
    dk = torch.einsum("bts,btd->bsd", ds, q.float()) / math.sqrt(q.shape[-1])
    dv = torch.einsum("bts,btd->bsd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd_flops(bh: int, t: int, d: int) -> int:
    """Product FLOPs of B2 at [BH, T, D]: the plain twin's two [T, T] x D
    products (QK^T and PV), as ``torch.utils.flop_counter`` counts
    :func:`flash_fwd_plain`.  The function is counted over the whole score
    matrix; the causal kernel skips the tiles above the diagonal."""
    return 4 * bh * t * t * d


def flash_bwd_dq_flops(bh: int, t: int, d: int) -> int:
    """Product FLOPs of B3's dq half: S, dP and dS.K (three [T, T] x D
    products of :func:`flash_bwd_dq_plain`)."""
    return 6 * bh * t * t * d


def flash_bwd_dkv_flops(bh: int, t: int, d: int) -> int:
    """Product FLOPs of B3's dk/dv half: S, dP, dS^T.Q and P^T.dO (four
    [T, T] x D products of :func:`flash_bwd_dkv_plain`)."""
    return 8 * bh * t * t * d


def _check(op: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"{op}: want [BH, T, D], got {tuple(q.shape)}")
    bh, t, d = q.shape
    if not supports_flash(t, d):
        raise ValueError(f"{op}: T={t}, D={d} not taken by the kernel (T a "
                         f"multiple of {TILE}, D in {HEAD_DIMS})")
    for a in tensors:
        if a.dtype == torch.float32 and a.dim() == 2:     # lse / Delta rows
            if a.shape != (bh, t):
                raise ValueError(f"{op}: row tensor {tuple(a.shape)} is not "
                                 f"[{bh}, {t}]")
        elif a.dtype != torch.bfloat16 or a.shape != q.shape:
            raise ValueError(f"{op}: want bf16 [{bh}, {t}, {d}], got "
                             f"{a.dtype} {tuple(a.shape)}")
        if a.device != q.device or not a.is_contiguous() \
                or a.data_ptr() % 16:
            raise ValueError(f"{op}: tensors must be contiguous, 16-byte "
                             f"aligned and on {q.device}")


def _launch(entry: str, *tensors: torch.Tensor) -> None:
    q = tensors[0]
    bh, t, d = q.shape
    lib = kernel_library("flash_attention")
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(*[a.data_ptr() for a in tensors], bh, t, d,
                                  stream_handle(q.device))
    check_launch(lib, err, entry)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward (B2): [BH, T, D] x3 -> (o, lse)."""
    if not on_cuda(q, "flash_attention_fwd"):
        return flash_fwd_plain(q, k, v)
    _check("flash_attention_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("tddl_flash_fwd", q, k, v, o, lse)
    flash_attention_fwd.launches += 1
    tally_flops("flash_attention_fwd", flash_fwd_flops(*q.shape))
    return o, lse


flash_attention_fwd.launches = 0


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor, delta: torch.Tensor
                           ) -> torch.Tensor:
    """The dq half of the backward (B3): one pass per query tile."""
    if not on_cuda(q, "flash_attention_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta)
    _check("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("tddl_flash_bwd_dq", q, k, v, do, lse, delta, dq)
    flash_attention_bwd_dq.launches += 1
    tally_flops("flash_attention_bwd_dq", flash_bwd_dq_flops(*q.shape))
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv half of the backward (B3): one pass per key tile."""
    if not on_cuda(q, "flash_attention_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta)
    _check("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("tddl_flash_bwd_dkv", q, k, v, do, lse, delta, dk, dv)
    flash_attention_bwd_dkv.launches += 1
    tally_flops("flash_attention_bwd_dkv", flash_bwd_dkv_flops(*q.shape))
    return dk, dv


flash_attention_bwd_dkv.launches = 0


class FlashAttention(torch.autograd.Function):
    """[BH, T, D] causal attention; saves q, k, v, o and lse for the
    backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """[B, H, T, D] (or [BH, T, D]) causal flash attention, differentiable.
    Raises ``ValueError`` for a shape the kernels do not take."""
    if not causal:
        raise ValueError("flash_attention: the kernels are causal only")
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, t, d = q.shape
    if not supports_flash(t, d):
        raise ValueError(f"flash_attention: T={t}, D={d} not taken by the "
                         f"kernel (T a multiple of {TILE}, D in {HEAD_DIMS});"
                         " use attn_impl='full'")
    merge = lambda a: a.reshape(b * h, t, d).contiguous()   # noqa: E731
    out = FlashAttention.apply(merge(q), merge(k), merge(v)).reshape(
        b, h, t, d)
    return out[0] if squeeze else out


#: The kernels of this module, by the wrapper that launches each.
KERNEL_WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dq,
                   flash_attention_bwd_dkv)

__all__ = [
    "FlashAttention", "HEAD_DIMS", "KERNEL_WRAPPERS", "NEG_INF", "TILE",
    "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
    "flash_attention_fwd", "flash_bwd_dkv_flops", "flash_bwd_dkv_plain",
    "flash_bwd_dq_flops", "flash_bwd_dq_plain", "flash_fwd_flops",
    "flash_fwd_plain", "supports_flash",
]
