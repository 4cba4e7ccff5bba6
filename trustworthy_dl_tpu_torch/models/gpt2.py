"""GPT-2 family: configuration, initialisation, the forward and the
monitored training loss.

Counterpart of ``trustworthy_dl_tpu/models/gpt2.py``.  Parameters are a
plain dict laid out like the JAX pytree: ``wte`` [V, D], ``wpe`` [P, D],
``ln_f``, and ``blocks`` whose every leaf carries a leading layer axis.
Attention goes through a registry: ``full`` (softmax over the whole score
matrix), ``flash`` (kernels B2/B3, ``ops/flash_attention``) and ``auto``
(flash at T >= :data:`AUTO_FLASH_MIN_T` where the kernel takes the shape,
full below).  ``remat`` checkpoints every block (policy ``block``) or,
with policy ``attention`` on the effectively-full attention path, only
the attention core.  The loss takes the vocab-chunked fused head
(``ops/fused_ce.py``) where ``lm_head_chunk`` resolves to a width.
``ring`` and ``ulysses`` (``parallel/sequence.py``) register themselves
when first asked for, as in JAX.  :func:`logical_axes` declares the
tensor-parallel layout that ``parallel/tensor_parallel.py`` resolves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.ops import fused_ce
from trustworthy_dl_tpu_torch.utils.tree import map_tree, tree_leaves

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
    # full | flash | auto (see the module docstring).
    attn_impl: str = "auto"
    remat: bool = False
    # "block" checkpoints each block; "attention" checkpoints only the
    # attention core where it is full attention (block remat elsewhere).
    remat_policy: str = "block"
    # 0 materialises the logits; "auto" or an int > 0 may pick the
    # vocab-chunked fused head (resolve_lm_head_chunk).
    lm_head_chunk: Any = "auto"

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
    scheme: normal(0.02) embeddings, the blocks of
    :func:`init_block_params`, a unit final LayerNorm.  The draws differ
    from the JAX init's (another generator); tests that compare the two
    packages convert JAX weights with ``models.convert``."""
    d = cfg.n_embd
    wte = L.embedding_init(generator, cfg.vocab_size, d, device)
    wpe = L.embedding_init(generator, cfg.n_positions, d, device)
    return {
        "wte": wte,
        "wpe": wpe,
        "blocks": init_block_params(cfg, generator, device),
        "ln_f": L.layernorm_init(d, device),
    }


def init_block_params(cfg: GPT2Config, generator: torch.Generator,
                      device: Any = "cpu") -> Params:
    """The stacked blocks (every leaf [n_layer, ...]): normal(0.02) qkv and
    fc weights, normal(0.02 / sqrt(2 L)) output projections, zero biases,
    unit LayerNorms."""
    d, n = cfg.n_embd, cfg.n_layer

    def normal(*shape: int, std: float) -> torch.Tensor:
        return (torch.randn(*shape, generator=generator, device=device)
                * std)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(*shape, device=device)

    def ln() -> Params:
        return {"scale": torch.ones(n, d, device=device), "bias": zeros(n, d)}

    proj_std = 0.02 / math.sqrt(2 * n)
    return {
        "ln_1": ln(),
        "attn": {
            "qkv": {"w": normal(n, d, 3 * d, std=0.02),
                    "b": zeros(n, 3 * d)},
            "proj": {"w": normal(n, d, d, std=proj_std), "b": zeros(n, d)},
        },
        "ln_2": ln(),
        "mlp": {
            "fc": {"w": normal(n, d, 4 * d, std=0.02),
                   "b": zeros(n, 4 * d)},
            "proj": {"w": normal(n, 4 * d, d, std=proj_std),
                     "b": zeros(n, d)},
        },
    }


def logical_axes() -> Params:
    """The model's sharding declaration, named once here and resolved per
    parallelism mode by the registry (``core/sharding.py``).  Each leaf
    is a tuple of logical axis names, one per dim of the matching param
    (blocks carry the stacked ``layer`` leading dim).  Megatron layout:
    qkv/fc shard their output dim (column parallel, ``w_tp``), the two
    proj weights their input dim (row parallel), so the pair needs one
    all-reduce; column-parallel biases shard, row-parallel biases, norms
    and embeddings replicate."""
    from trustworthy_dl_tpu_torch.core import sharding as shreg

    LYR, HID, TP = shreg.LAYER, shreg.HIDDEN, shreg.W_TP
    block = {
        "ln_1": {"scale": (LYR, HID), "bias": (LYR, HID)},
        "attn": {
            "qkv": {"w": (LYR, HID, TP), "b": (LYR, TP)},
            "proj": {"w": (LYR, TP, HID), "b": (LYR, HID)},
        },
        "ln_2": {"scale": (LYR, HID), "bias": (LYR, HID)},
        "mlp": {
            "fc": {"w": (LYR, HID, TP), "b": (LYR, TP)},
            "proj": {"w": (LYR, TP, HID), "b": (LYR, HID)},
        },
    }
    return {
        "wte": (None, HID),
        "wpe": (None, HID),
        "blocks": block,
        "ln_f": {"scale": (HID,), "bias": (HID,)},
    }


def unstack_blocks(blocks: Params, n_layer: int) -> List[Params]:
    """Stacked block params -> one dict of views per layer.  ``unbind``
    (one view per layer from a single op) rather than ``a[i]``: the
    backward of ``a[i]`` scatters each layer's gradient into a zeroed
    full-stack buffer, n_layer full-size adds per leaf, where unbind's
    stacks them once."""
    per_leaf = map_tree(lambda a: a.unbind(0), blocks)
    return [map_tree(lambda views, i=i: views[i], per_leaf)
            for i in range(n_layer)]


def split_heads(a: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, T, D] -> [B, H, T, D/H]."""
    b, t, d = a.shape
    return a.reshape(b, t, n_head, d // n_head).permute(0, 2, 1, 3)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """Softmax attention [B, H, T, Dh]: scores in the compute dtype, masked
    with its finfo.min when ``causal``, softmax in f32 cast back."""
    d = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if causal:
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


# --------------------------------------------------------------------------
# Attention registry
# --------------------------------------------------------------------------

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

#: T from which ``auto`` picks the flash kernels.  The JAX package's
#: threshold, tuned on a TPU; re-deciding it from the card's flash-vs-full
#: times is open work.
AUTO_FLASH_MIN_T = 1024


def auto_picks_flash(t: int, d: int, dtype: torch.dtype) -> bool:
    """THE ``attn_impl="auto"`` predicate: flash for long sequences, on
    shapes and the dtype (bf16) the kernels take; full attention
    elsewhere."""
    from trustworthy_dl_tpu_torch.ops.flash_attention import supports_flash

    return (t >= AUTO_FLASH_MIN_T and supports_flash(t, d)
            and dtype == torch.bfloat16)


def _flash(q, k, v):
    from trustworthy_dl_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v)


def _auto(q, k, v):
    if auto_picks_flash(q.shape[-2], q.shape[-1], q.dtype):
        return _flash(q, k, v)
    return full_attention(q, k, v)


ATTENTION: Dict[str, AttnFn] = {"full": full_attention, "flash": _flash,
                                "auto": _auto}


def register_attention(name: str, fn: AttnFn) -> None:
    ATTENTION[name] = fn


def get_attention(name: str) -> AttnFn:
    if name not in ATTENTION and name in ("ring", "ulysses"):
        # Late registration, as in JAX: the sequence-parallel impls live
        # in parallel/ and register themselves on import.
        import trustworthy_dl_tpu_torch.parallel.sequence  # noqa: F401
    if name not in ATTENTION:
        raise ValueError(f"unknown attention impl {name!r} (one of "
                         f"{sorted(ATTENTION)})")
    return ATTENTION[name]


def _checkpointed_full_attention(q, k, v):
    """Full attention whose O(T^2) scores and probs are recomputed in the
    backward instead of saved (the ``attention`` remat policy)."""
    return checkpoint(full_attention, q, k, v, use_reentrant=False)


def attention_residual(block: Params, x: torch.Tensor, cfg: Any,
                       attn: Optional[AttnFn] = None) -> torch.Tensor:
    """A block's first half on f32 [B, T, D] activations: ln_1, causal
    self-attention through the registry (``attn`` overrides
    ``cfg.attn_impl``) and the residual add.  Shared with the MoE
    family's block."""
    dtype = cfg.dtype
    b, t, d = x.shape
    y = L.layernorm(block["ln_1"], x).to(dtype)
    q, k, v = L.dense(block["attn"]["qkv"], y, dtype).split(d, dim=-1)
    attn = attn or get_attention(cfg.attn_impl)
    out = attn(*(split_heads(a, cfg.n_head) for a in (q, k, v)))
    out = out.permute(0, 2, 1, 3).reshape(b, t, d)
    return x + L.dense(block["attn"]["proj"], out, dtype).to(x.dtype)


def block_forward(block: Params, x: torch.Tensor, cfg: GPT2Config,
                  attn: Optional[AttnFn] = None) -> torch.Tensor:
    """One transformer block on f32 [B, T, D] activations; ``attn``
    overrides the registry's ``cfg.attn_impl``."""
    x = attention_residual(block, x, cfg, attn)
    return x + mlp(block, x, cfg.dtype).to(x.dtype)


def apply_blocks(blocks: Params, x: torch.Tensor, cfg: GPT2Config
                 ) -> torch.Tensor:
    """Every block in turn.  With ``cfg.remat`` each block is checkpointed
    (its forward re-runs in the backward, flash kernels included), except
    under ``remat_policy="attention"`` where attention is effectively full
    (``full``, or ``auto`` where it does not pick flash): there only the
    attention core is checkpointed, so its O(T^2) scores and probs are
    recomputed and every other activation is saved.  The flash kernels
    never hold those, so elsewhere the policy falls through to block
    remat, as the JAX package's does."""
    remat = cfg.remat and torch.is_grad_enabled()
    attn = None
    if remat and cfg.remat_policy == "attention":
        t, d_head = x.shape[-2], cfg.n_embd // cfg.n_head
        if cfg.attn_impl == "full" or (cfg.attn_impl == "auto" and not
                                       auto_picks_flash(t, d_head,
                                                        cfg.dtype)):
            attn = _checkpointed_full_attention
    for block in unstack_blocks(blocks, cfg.n_layer):
        if remat and attn is None:
            x = checkpoint(block_forward, block, x, cfg, use_reentrant=False)
        else:
            x = block_forward(block, x, cfg, attn)
    return x


def embed(params: Params, tokens: torch.Tensor,
          pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token + position embeddings, f32."""
    if pos is None:
        pos = torch.arange(tokens.shape[-1], device=tokens.device)
    return (params["wte"][tokens] + params["wpe"][pos]).float()


def head_weight(params: Params, cfg: GPT2Config) -> torch.Tensor:
    """The tied head's weight: ``wte`` cast to the compute dtype, its vocab
    axis zero-padded by :func:`fused_ce.pad_vocab`.  Built once per
    forward and shared by its products."""
    return fused_ce.pad_vocab(params["wte"], cfg.dtype)


def project_logits(w_head: torch.Tensor, normed: torch.Tensor,
                   cfg: GPT2Config) -> torch.Tensor:
    """Tied-embedding projection [..., D] -> f32 [..., V] through
    :func:`head_weight`, in the compute dtype."""
    return (normed.to(cfg.dtype) @ w_head.T)[..., :cfg.vocab_size].float()


def unembed(params: Params, x: torch.Tensor, cfg: GPT2Config
            ) -> torch.Tensor:
    return project_logits(head_weight(params, cfg),
                          L.layernorm(params["ln_f"], x), cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: GPT2Config
            ) -> torch.Tensor:
    """tokens [B, T] -> f32 logits [B, T, V]."""
    x = apply_blocks(params["blocks"], embed(params, tokens), cfg)
    return unembed(params, x, cfg)


# lm_head_chunk="auto": the per-node materialised-logits budget above which
# the JAX package switches to the vocab-chunked fused head.
AUTO_CE_CHUNK = 8192
AUTO_CE_MAX_LOGITS_BYTES = 1 << 30


def auto_picks_chunked_ce(num_tokens: int, vocab: int,
                          itemsize: int = 2) -> bool:
    """THE ``lm_head_chunk="auto"`` predicate: chunked exactly when this
    node's [tokens, vocab] logits would exceed 1 GiB."""
    return num_tokens * vocab * itemsize > AUTO_CE_MAX_LOGITS_BYTES


def resolve_lm_head_chunk(cfg: GPT2Config, num_tokens: int) -> int:
    """``cfg.lm_head_chunk`` resolved for a loss over ``num_tokens``."""
    chunk = cfg.lm_head_chunk
    if chunk == "auto":
        itemsize = torch.tensor([], dtype=cfg.dtype).element_size()
        if auto_picks_chunked_ce(num_tokens, cfg.vocab_size, itemsize):
            return AUTO_CE_CHUNK
        return 0
    return int(chunk or 0)


def forward_with_monitor(params: Params, tokens: torch.Tensor,
                         cfg: GPT2Config
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [B, T] -> (logits [B, T, V], features [B, T, D],
    mean_logits [V]).  ``features`` are the final hidden activations
    before ln_f (the node-boundary output the detector watches)."""
    return monitor_head(params,
                        apply_blocks(params["blocks"], embed(params, tokens),
                                     cfg), cfg)


def monitor_head(params: Params, x: torch.Tensor, cfg: GPT2Config
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """ln_f + tied head on [B, T, D] hiddens -> (logits, x, mean_logits);
    ``mean_logits`` is exact because the tied projection is linear."""
    normed = L.layernorm(params["ln_f"], x)
    w_head = head_weight(params, cfg)
    mean_normed = normed.mean(dim=tuple(range(normed.dim() - 1)))
    return (project_logits(w_head, normed, cfg), x,
            project_logits(w_head, mean_normed, cfg))


def head_loss_and_signature(params: Params, x: torch.Tensor,
                            targets: torch.Tensor, cfg: GPT2Config
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ln_f + tied head on [B, T, D] hiddens -> (mean CE, mean_logits).
    Where ``lm_head_chunk`` resolves to a width the CE goes through the
    vocab-chunked fused head, fed the unpadded ``wte`` (padded rows would
    join its softmax); ``mean_logits`` stays exact either way, the tied
    projection being linear."""
    normed = L.layernorm(params["ln_f"], x)
    mean_normed = normed.mean(dim=tuple(range(normed.dim() - 1)))
    w_head = head_weight(params, cfg)
    mean_logits = project_logits(w_head, mean_normed, cfg)
    chunk = resolve_lm_head_chunk(cfg, targets.numel())
    if chunk:
        loss = fused_ce.fused_lm_loss(normed, params["wte"], targets, chunk,
                                      cfg.dtype)
    else:
        loss = L.cross_entropy_loss(project_logits(w_head, normed, cfg),
                                    targets)
    return loss, mean_logits


def loss_with_monitor(params: Params, batch: Dict[str, torch.Tensor],
                      cfg: GPT2Config
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """{'input', 'target'} -> (loss, features [B, T, D], mean_logits [V]):
    the training step's loss with the detector's signals."""
    x = apply_blocks(params["blocks"], embed(params, batch["input"]), cfg)
    loss, mean_logits = head_loss_and_signature(params, x, batch["target"],
                                                cfg)
    return loss, x, mean_logits


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: GPT2Config) -> torch.Tensor:
    """Next-token cross entropy on {'input', 'target'} batches."""
    return loss_with_monitor(params, batch, cfg)[0]


def num_params(params: Params) -> int:
    """Elements in every tensor of a parameter tree."""
    return sum(int(p.numel()) for p in tree_leaves(params))
