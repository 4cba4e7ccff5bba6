"""Flash attention, causal and not: forward (B2) and backward (B3) behind
``torch.autograd.Function``s.

Counterpart of ``trustworthy_dl_tpu/ops/flash_attention.py``.  Layout
[BH, T, D] with batch and heads merged, as the JAX wrapper does.  Each
wrapper takes CPU tensors to its plain PyTorch twin (``*_plain``) and CUDA
tensors to its hand-written kernel in ``csrc/flash_attention.cu`` (see the
note there for what each kernel replaces, its bound and its design):

* :func:`flash_attention_fwd` -> (o, lse f32 [BH, T]);
* :func:`flash_attention_bwd_dq` -> dq from the caller's Delta when
  causal, and (dq, Delta) when not: the non-causal kernel computes Delta
  = sum(dO * O) - dlse itself from o and the lse cotangent;
* :func:`flash_attention_bwd_dkv` -> (dk, dv),

each taking ``causal`` (JAX's static flag: ``False`` drops the mask and
the tile skip, and launches the kernel's non-causal instance), each with
a plain integer ``launches`` that it increments where it launches its
kernel and nowhere else, and ``launches_full`` beside it, which counts the
non-causal launches among them; there it also adds its kernel's products
(``flash_*_flops``) to an open FLOP tally (``ops.count_kernel_flops``).
The causal backward takes Delta = sum(dO * O) per row from a plain
reduction, as the JAX package leaves it to XLA; the non-causal backward is
two launches, dq (which writes Delta) and then dk/dv (which reads it).

:class:`FlashAttention` (:func:`flash_attention`) returns o;
:class:`FlashChunk` (:func:`flash_chunk`) returns (o, lse) with a
gradient through lse as well, the building block of ring attention
(``parallel/sequence.py``): its backward folds the lse cotangent into
Delta (JAX's Delta_eff = Delta - dlse), in the plain reduction when causal
and inside the non-causal dq kernel when not.

The kernels take bf16 on the card, T a multiple of 64 and D in
:data:`HEAD_DIMS`; anything else raises ``ValueError``.  Unlike the JAX
wrapper, :func:`flash_attention` does not fall back to full attention on a
shape the kernel does not take: an explicit ``attn_impl="flash"`` there is
an error, and ``"auto"`` only picks flash where the kernel runs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool = True
            ) -> torch.Tensor:
    """f32 scores [BH, T, T] scaled by 1/sqrt(D), NEG_INF masked above the
    diagonal when ``causal``."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) / math.sqrt(d)
    if not causal:
        return s
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """f32 ``x`` rounded through ``dtype``, where the kernels (like the TPU
    kernels) cast probabilities and dS to the input dtype before a
    product; a no-op for f32 inputs."""
    return x.to(dtype).float()


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o in q's dtype, lse f32 [BH, T]): the forward kernel's function,
    spelled over the whole [T, T] score matrix."""
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    o = torch.einsum("bts,bsd->btd", _rounded(p, v.dtype), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _probs_and_dscores(q, k, v, lse, do, delta, causal):
    """(P, dS) rounded through the input dtype as the kernels use them."""
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.einsum("btd,bsd->bts", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    return _rounded(p, q.dtype), _rounded(ds, q.dtype)


def row_delta(do: torch.Tensor, o: torch.Tensor,
              dlse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Delta = sum(dO * O) per row in f32 [BH, T], less the lse cotangent
    ``dlse`` where the caller differentiates through lse."""
    delta = (do.float() * o.float()).sum(dim=-1)
    return delta if dlse is None else delta - dlse.float()


def flash_bwd_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, lse: torch.Tensor,
                       delta: Optional[torch.Tensor] = None,
                       causal: bool = True, o: Optional[torch.Tensor] = None,
                       dlse: Optional[torch.Tensor] = None):
    """dq = scale * (P o (dO.V^T - Delta)) . K, P = exp(S - lse).  Given
    ``delta``, returns dq; given ``o`` (and ``dlse`` or None) instead, it
    takes Delta = :func:`row_delta` itself and returns (dq, delta), as the
    non-causal kernel does."""
    own = delta is None
    if own:
        if o is None:
            raise ValueError("flash_bwd_dq_plain: give delta, or o")
        delta = row_delta(do, o, dlse)
    _, ds = _probs_and_dscores(q, k, v, lse, do, delta, causal)
    dq = torch.einsum("bts,bsd->btd", ds, k.float()) / math.sqrt(q.shape[-1])
    dq = dq.to(q.dtype)
    return (dq, delta) if own else dq


def flash_bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) = (scale * dS^T . Q, P^T . dO)."""
    p, ds = _probs_and_dscores(q, k, v, lse, do, delta, causal)
    dk = torch.einsum("bts,btd->bsd", ds, q.float()) / math.sqrt(q.shape[-1])
    dv = torch.einsum("bts,btd->bsd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_fwd_flops(bh: int, t: int, d: int) -> int:
    """Product FLOPs of B2 at [BH, T, D]: the plain twin's two [T, T] x D
    products (QK^T and PV), as ``torch.utils.flop_counter`` counts
    :func:`flash_fwd_plain`.  The function is counted over the whole score
    matrix, causal or not; the causal kernel skips the tiles above the
    diagonal."""
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


def _launch(entry: str, causal: bool, *tensors: Optional[torch.Tensor]
            ) -> None:
    """Launch ``entry`` (its non-causal instance ``<entry>_full`` when not
    ``causal``) on q's device and stream; None passes a null pointer."""
    q = tensors[0]
    bh, t, d = q.shape
    name = entry if causal else f"{entry}_full"
    lib = kernel_library("flash_attention")
    ptrs = [None if a is None else a.data_ptr() for a in tensors]
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(*ptrs, bh, t, d, stream_handle(q.device))
    check_launch(lib, err, name)


def _count(wrapper, causal: bool, flops: int) -> None:
    """One launch of ``wrapper``'s kernel: its counters and the open FLOP
    tallies."""
    wrapper.launches += 1
    if not causal:
        wrapper.launches_full += 1
    tally_flops(wrapper.__name__, flops)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward (B2): [BH, T, D] x3 -> (o, lse)."""
    if not on_cuda(q, "flash_attention_fwd"):
        return flash_fwd_plain(q, k, v, causal)
    _check("flash_attention_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch("tddl_flash_fwd", causal, q, k, v, o, lse)
    _count(flash_attention_fwd, causal, flash_fwd_flops(*q.shape))
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_full = 0


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, do: torch.Tensor,
                           lse: torch.Tensor,
                           delta: Optional[torch.Tensor] = None,
                           causal: bool = True,
                           o: Optional[torch.Tensor] = None,
                           dlse: Optional[torch.Tensor] = None):
    """The dq half of the backward (B3): one pass per query tile.  Causal,
    it takes the caller's ``delta`` and returns dq.  Not causal, it takes
    ``o`` (and the lse cotangent ``dlse``, or None) in place of ``delta``,
    computes Delta = sum(dO * O) - dlse inside the kernel and returns (dq,
    delta), delta f32 [BH, T] for :func:`flash_attention_bwd_dkv`."""
    if causal != (delta is not None) or causal == (o is not None) \
            or (causal and dlse is not None):
        raise ValueError("flash_attention_bwd_dq: give delta when causal, "
                         "o (and dlse or None) when not")
    if not on_cuda(q, "flash_attention_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, o, dlse)
    dq = torch.empty_like(q)
    if causal:
        _check("flash_attention_bwd_dq", q, k, v, do, lse, delta)
        _launch("tddl_flash_bwd_dq", causal, q, k, v, do, lse, delta, dq)
    else:
        delta = torch.empty(q.shape[:2], dtype=torch.float32,
                            device=q.device)
        rows = (lse, delta) if dlse is None else (lse, dlse, delta)
        _check("flash_attention_bwd_dq", q, k, v, do, o, *rows)
        _launch("tddl_flash_bwd_dq", causal, q, k, v, do, o, lse, dlse,
                delta, dq)
    _count(flash_attention_bwd_dq, causal, flash_bwd_dq_flops(*q.shape))
    return dq if causal else (dq, delta)


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_full = 0


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, do: torch.Tensor,
                            lse: torch.Tensor, delta: torch.Tensor,
                            causal: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv half of the backward (B3): one pass per key tile."""
    if not on_cuda(q, "flash_attention_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    _check("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("tddl_flash_bwd_dkv", causal, q, k, v, do, lse, delta, dk, dv)
    _count(flash_attention_bwd_dkv, causal, flash_bwd_dkv_flops(*q.shape))
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_full = 0


def _backward(q, k, v, o, lse, do, causal, dlse=None):
    """dq, dk, dv from the saved forward and Delta = sum(dO * O) per row,
    less the lse cotangent where the caller differentiates through lse: a
    plain reduction before the two kernels when causal, the dq kernel's
    own when not (two launches, no reduction)."""
    do = do.contiguous()
    if causal:
        delta = row_delta(do, o, dlse)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    else:
        dlse = None if dlse is None else dlse.float().contiguous()
        dq, delta = flash_attention_bwd_dq(q, k, v, do, lse, None, causal,
                                           o, dlse)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """[BH, T, D] attention; saves q, k, v, o and lse for the backward
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        return (*_backward(*ctx.saved_tensors, do, ctx.causal), None)


class FlashChunk(torch.autograd.Function):
    """[BH, T, D] attention returning (o, lse f32 [BH, T]), differentiable
    through both (JAX's ``flash_chunk``): the backward takes (dO, dlse)
    and runs the kernels with Delta - dlse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_backward(*ctx.saved_tensors, do, ctx.causal, dlse), None)


def flash_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """[BH, T, D] -> (o, lse f32 [BH, T]) with full autograd support
    including lse: the per-rotation chunk of ring attention, whose
    cross-chunk combine weights depend on lse."""
    if not supports_flash(q.shape[-2], q.shape[-1]):
        raise ValueError(f"flash_chunk: T={q.shape[-2]}, D={q.shape[-1]} "
                         f"not taken by the kernel (T a multiple of {TILE}, "
                         f"D in {HEAD_DIMS})")
    return FlashChunk.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """[B, H, T, D] (or [BH, T, D]) flash attention, differentiable.
    Raises ``ValueError`` for a shape the kernels do not take."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, t, d = q.shape
    if not supports_flash(t, d):
        raise ValueError(f"flash_attention: T={t}, D={d} not taken by the "
                         f"kernel (T a multiple of {TILE}, D in {HEAD_DIMS});"
                         " use attn_impl='full'")
    merge = lambda a: a.reshape(b * h, t, d).contiguous()   # noqa: E731
    out = FlashAttention.apply(merge(q), merge(k), merge(v), causal).reshape(
        b, h, t, d)
    return out[0] if squeeze else out


#: The kernels of this module, by the wrapper that launches each.
KERNEL_WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dq,
                   flash_attention_bwd_dkv)

__all__ = [
    "FlashAttention", "FlashChunk", "HEAD_DIMS", "KERNEL_WRAPPERS", "NEG_INF",
    "TILE",
    "flash_attention", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
    "flash_attention_fwd", "flash_bwd_dkv_flops", "flash_bwd_dkv_plain",
    "flash_chunk",
    "flash_bwd_dq_flops", "flash_bwd_dq_plain", "flash_fwd_flops",
    "flash_fwd_plain", "row_delta", "supports_flash",
]
