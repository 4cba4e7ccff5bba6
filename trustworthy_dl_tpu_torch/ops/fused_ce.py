"""Vocab-chunked fused lm-head + cross-entropy.

Counterpart of ``trustworthy_dl_tpu/ops/fused_ce.py``.  The GPT-2 loss
would otherwise materialise [N, V] logits (16,384 tokens x 50,257 columns
is 1.65 GB in bf16).  Here the vocab axis is walked in ``chunk``-column
blocks: each block's [N, C] logits fold into a running online logsumexp
(the recurrence flash attention runs along its key axis) and yield the
target column where it lands, so the peak is O(N C).  The forward saves
the compute-dtype activations, the weight, the targets and the per-row
logsumexp, never the logits.  The backward recomputes each block as
``exp(logits - lse)``, subtracts the one-hot, scales by ``g / N``, casts
``dlogits`` to the compute dtype and contracts it straight into ``dx`` (an
f32 accumulator) and that block's rows of ``dW``.

The weight's vocab axis is zero-padded to a multiple of :data:`VOCAB_PAD`
by :func:`pad_vocab`, the one padding of the tied head (the materialised
head in ``models/gpt2.py`` uses it too).  Only blocks that start inside
the real vocab are walked, each at most ``chunk`` wide, so every block
holds a real column and the last one reaches at most to the padded end;
its columns past the vocab are masked to ``-inf``, adding exp(-inf) = 0
to every sum and never an argmax (the JAX package pads to a multiple of
the chunk and masks the same columns).

The products are library products (the JAX package's are jnp einsums,
not Pallas).  JAX contracts the compute-dtype inputs with f32
accumulation into an f32 result; :func:`product_f32` does the same: on
the card ``torch.mm(..., out_dtype=torch.float32)``, elsewhere an f32
product of the compute-dtype-rounded inputs.

:data:`CALLS` counts the head's runs where they happen (``forward``,
``backward``, ``eval``), so a caller can show a path went through it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

#: Default vocab-chunk width, the JAX package's (tuned on a TPU).
DEFAULT_CHUNK = 8192
#: The tied head's vocab axis is padded to a multiple of this inside its
#: products.  GPT-2's 50257 is odd, and cuBLAS then falls back to its
#: 1-element-aligned GEMMs, several times slower than the aligned ones; the
#: padded rows are zero and their columns are masked or sliced off.
VOCAB_PAD = 64

CALLS: Dict[str, int] = {"forward": 0, "backward": 0, "eval": 0}


def reset_calls() -> None:
    for key in CALLS:
        CALLS[key] = 0


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``a @ b`` of two compute-dtype 2-D operands, accumulated in f32
    and not rounded back to the compute dtype."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def pad_vocab(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[V, D] -> [V + pad, D] in ``dtype``, zero rows up to a multiple of
    :data:`VOCAB_PAD`."""
    w = w.to(dtype)
    pad = -w.shape[0] % VOCAB_PAD
    if pad:
        w = torch.cat([w, w.new_zeros(pad, w.shape[1])])
    return w


def _blocks(vocab: int, padded_vocab: int, chunk: int):
    """(base, width) of each block: bases inside the real vocab only, the
    last block widened no further than the padded end."""
    for base in range(0, vocab, chunk):
        yield base, min(chunk, padded_vocab - base)


def _masked_logits(xf: torch.Tensor, wp: torch.Tensor, base: int, width: int,
                   vocab: int) -> torch.Tensor:
    """One block's f32 logits [N, width], columns past the vocab -inf."""
    logits = product_f32(xf, wp[base:base + width].T)
    if base + width > vocab:
        logits[:, vocab - base:] = float("-inf")
    return logits


def _target_logit(logits: torch.Tensor, tgt: torch.Tensor, base: int,
                  width: int, tlogit: torch.Tensor) -> torch.Tensor:
    """``tlogit`` with the rows whose target lies in this block replaced
    by the block's logit there."""
    in_block = (tgt >= base) & (tgt < base + width)
    local = (tgt - base).clamp(0, width - 1)
    picked = logits.gather(1, local[:, None])[:, 0]
    return torch.where(in_block, picked, tlogit)


def _online_lse_step(logits: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                     block_max: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """m' = max(m, block max); s' = s e^(m - m') + sum e^(l - m').  Turns
    ``logits`` into e^(l - m') in place (no second [N, C] block)."""
    m_new = torch.maximum(m, block_max)
    s = s * torch.exp(m - m_new) + logits.sub_(m_new[:, None]).exp_().sum(1)
    return m_new, s


class _FusedLMLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets, chunk, compute_dtype):
        CALLS["forward"] += 1
        d = x.shape[-1]
        xf = x.reshape(-1, d).to(compute_dtype)
        tgt = targets.reshape(-1).long()
        n, vocab = xf.shape[0], w.shape[0]
        wp = pad_vocab(w, compute_dtype)
        m = torch.full((n,), float("-inf"), device=x.device)
        s = torch.zeros(n, device=x.device)
        tlogit = torch.zeros(n, device=x.device)
        for base, width in _blocks(vocab, wp.shape[0], chunk):
            logits = _masked_logits(xf, wp, base, width, vocab)
            tlogit = _target_logit(logits, tgt, base, width, tlogit)
            m, s = _online_lse_step(logits, m, s, logits.amax(1))
            del logits
        lse = m + torch.log(s)
        ctx.save_for_backward(xf, w, tgt, lse)
        ctx.chunk, ctx.compute_dtype = chunk, compute_dtype
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return (lse - tlogit).mean()

    @staticmethod
    def backward(ctx, g):
        CALLS["backward"] += 1
        xf, w, tgt, lse = ctx.saved_tensors
        n, d = xf.shape
        vocab = w.shape[0]
        wp = pad_vocab(w, ctx.compute_dtype)
        scale = g.float() / n
        dx = torch.zeros(n, d, device=xf.device)
        dw = torch.empty(wp.shape, dtype=torch.float32, device=xf.device)
        for base, width in _blocks(vocab, wp.shape[0], ctx.chunk):
            wc = wp[base:base + width]
            probs = product_f32(xf, wc.T).sub_(lse[:, None]).exp_()
            if base + width > vocab:
                probs[:, vocab - base:] = 0.0
            # probs - onehot: -1 at the target column of the rows whose
            # target lies in this block, -0 elsewhere (no host sync).
            hit = (tgt >= base) & (tgt < base + width)
            probs.scatter_add_(1, (tgt - base).clamp(0, width - 1)[:, None],
                               -hit.float()[:, None])
            dlogits = probs.mul_(scale).to(ctx.compute_dtype)
            del probs
            dx += product_f32(dlogits, wc)
            dw[base:base + width] = product_f32(dlogits.T, xf)
            del dlogits
        dx = dx.reshape(ctx.x_shape).to(ctx.x_dtype)
        return dx, dw[:vocab].to(w.dtype), None, None, None


def fused_lm_loss(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                  chunk: int = DEFAULT_CHUNK,
                  compute_dtype: Any = torch.bfloat16) -> torch.Tensor:
    """Mean cross-entropy of ``softmax(x @ w.T)`` against ``targets``
    without materialising the logits.  x: [..., D] final (post-ln)
    activations; w: [V, D] tied embedding (unpadded); targets: [...] int
    labels.  Differentiable in ``x`` and ``w``."""
    return _FusedLMLoss.apply(x, w, targets, int(chunk), compute_dtype)


@torch.no_grad()
def fused_lm_eval(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                  chunk: int = DEFAULT_CHUNK,
                  compute_dtype: Any = torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean NLL, accuracy) without materialising the logits: the online
    logsumexp of :func:`fused_lm_loss` beside a running (max logit,
    argmax), an earlier block keeping ties."""
    CALLS["eval"] += 1
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(compute_dtype)
    tgt = targets.reshape(-1).long()
    n, vocab = xf.shape[0], w.shape[0]
    wp = pad_vocab(w, compute_dtype)
    m = torch.full((n,), float("-inf"), device=x.device)
    s = torch.zeros(n, device=x.device)
    tlogit = torch.zeros(n, device=x.device)
    best = torch.full((n,), float("-inf"), device=x.device)
    best_idx = torch.zeros(n, dtype=torch.long, device=x.device)
    for base, width in _blocks(vocab, wp.shape[0], chunk):
        logits = _masked_logits(xf, wp, base, width, vocab)
        block_max, block_arg = logits.max(1)
        better = block_max > best
        best = torch.where(better, block_max, best)
        best_idx = torch.where(better, block_arg + base, best_idx)
        tlogit = _target_logit(logits, tgt, base, width, tlogit)
        m, s = _online_lse_step(logits, m, s, block_max)
        del logits
    loss = (m + torch.log(s) - tlogit).mean()
    accuracy = (best_idx == tgt).float().mean()
    return loss, accuracy


__all__ = ["CALLS", "DEFAULT_CHUNK", "VOCAB_PAD", "fused_lm_eval",
           "fused_lm_loss", "pad_vocab", "product_f32", "reset_calls"]
