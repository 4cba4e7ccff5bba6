"""GPT-2 family: configuration, initialisation and the training-style
forward with full causal attention.

Counterpart of ``trustworthy_dl_tpu/models/gpt2.py``.  Parameters are a
plain dict laid out like the JAX pytree: ``wte`` [V, D], ``wpe`` [P, D],
``ln_f``, and ``blocks`` whose every leaf carries a leading layer axis.
The flash, ring and Ulysses attention variants and remat are not ported
yet: only ``full`` attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from trustworthy_dl_tpu_torch.models import layers as L

Params = Dict[str, Any]

GPT2_SIZES = {
    "gpt2": dict(n_layer=12, n_embd=768, n_head=12),
    "gpt2-small": dict(n_layer=12, n_embd=768, n_head=12),
    "gpt2-medium": dict(n_layer=24, n_embd=1024, n_head=16),
    "gpt2-large": dict(n_layer=36, n_embd=1280, n_head=20),
    "gpt2-xl": dict(n_layer=48, n_embd=1600, n_head=25),
}


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_layer: int = 12
    n_embd: int = 768
    n_head: int = 12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @staticmethod
    def from_name(name: str, **overrides: Any) -> "GPT2Config":
        key = name.lower()
        if key not in GPT2_SIZES:
            raise ValueError(f"unknown GPT-2 size {name!r}")
        kwargs = dict(GPT2_SIZES[key])
        kwargs.update(overrides)
        return GPT2Config(**kwargs)


def init_params(cfg: GPT2Config, generator: torch.Generator,
                device: Any = "cpu") -> Params:
    """f32 master weights drawn from ``generator`` with the JAX package's
    scheme: normal(0.02) embeddings and qkv/fc weights, normal(0.02 /
    sqrt(2 L)) output projections, zero biases, unit LayerNorms.  The draws
    differ from the JAX init's (another generator); tests that compare the
    two packages convert JAX weights with ``models.convert``."""
    d, n = cfg.n_embd, cfg.n_layer

    def normal(*shape: int, std: float) -> torch.Tensor:
        return (torch.randn(*shape, generator=generator, device=device)
                * std)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(*shape, device=device)

    def ln(*lead: int) -> Params:
        return {"scale": torch.ones(*lead, d, device=device),
                "bias": zeros(*lead, d)}

    proj_std = 0.02 / math.sqrt(2 * n)
    return {
        "wte": normal(cfg.vocab_size, d, std=0.02),
        "wpe": normal(cfg.n_positions, d, std=0.02),
        "blocks": {
            "ln_1": ln(n),
            "attn": {
                "qkv": {"w": normal(n, d, 3 * d, std=0.02),
                        "b": zeros(n, 3 * d)},
                "proj": {"w": normal(n, d, d, std=proj_std),
                         "b": zeros(n, d)},
            },
            "ln_2": ln(n),
            "mlp": {
                "fc": {"w": normal(n, d, 4 * d, std=0.02),
                       "b": zeros(n, 4 * d)},
                "proj": {"w": normal(n, 4 * d, d, std=proj_std),
                         "b": zeros(n, d)},
            },
        },
        "ln_f": ln(),
    }


def map_tree(fn, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_blocks(blocks: Params, n_layer: int) -> List[Params]:
    """Stacked block params -> one dict of views per layer."""
    return [map_tree(lambda a, i=i: a[i], blocks) for i in range(n_layer)]


def split_heads(a: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D/H]."""
    b, t, d = a.shape
    return a.reshape(b, t, n_head, d // n_head).permute(0, 2, 1, 3)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """Causal softmax attention [B, H, T, Dh]: scores in the compute dtype,
    masked with its finfo.min, softmax in f32 cast back."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    t_q, t_k = q.shape[-2], k.shape[-2]
    mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device
                      ).tril(diagonal=t_k - t_q)
    scores = torch.where(mask, scores,
                         torch.full_like(scores,
                                         torch.finfo(scores.dtype).min))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def mlp(block: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """ln_2 -> fc -> tanh-approximate GELU -> proj (``jax.nn.gelu``'s
    default)."""
    y = L.layernorm(block["ln_2"], x).to(dtype)
    y = F.gelu(L.dense(block["mlp"]["fc"], y, dtype), approximate="tanh")
    return L.dense(block["mlp"]["proj"], y, dtype)


def block_forward(block: Params, x: torch.Tensor, cfg: GPT2Config
                  ) -> torch.Tensor:
    """One transformer block on f32 [B, T, D] activations."""
    dtype = cfg.dtype
    b, t, d = x.shape
    y = L.layernorm(block["ln_1"], x).to(dtype)
    q, k, v = L.dense(block["attn"]["qkv"], y, dtype).split(d, dim=-1)
    out = full_attention(*(split_heads(a, cfg.n_head) for a in (q, k, v)))
    out = out.permute(0, 2, 1, 3).reshape(b, t, d)
    x = x + L.dense(block["attn"]["proj"], out, dtype).to(x.dtype)
    return x + mlp(block, x, dtype).to(x.dtype)


def embed(params: Params, tokens: torch.Tensor,
          pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token + position embeddings, f32."""
    if pos is None:
        pos = torch.arange(tokens.shape[-1], device=tokens.device)
    return (params["wte"][tokens] + params["wpe"][pos]).float()


def project_logits(params: Params, normed: torch.Tensor, cfg: GPT2Config
                   ) -> torch.Tensor:
    """Tied-embedding projection [..., D] -> f32 [..., V], in the compute
    dtype."""
    return (normed.to(cfg.dtype) @ params["wte"].to(cfg.dtype).T).float()


def unembed(params: Params, x: torch.Tensor, cfg: GPT2Config
            ) -> torch.Tensor:
    return project_logits(params, L.layernorm(params["ln_f"], x), cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: GPT2Config
            ) -> torch.Tensor:
    """tokens [B, T] -> f32 logits [B, T, V]."""
    x = embed(params, tokens)
    for block in unstack_blocks(params["blocks"], cfg.n_layer):
        x = block_forward(block, x, cfg)
    return unembed(params, x, cfg)

