"""Mixture-of-Experts GPT-2, trained in data mode.

Counterpart of ``trustworthy_dl_tpu/models/moe.py``: GPT-2 with each
block's dense MLP swapped for a router and ``n_experts`` expert FFNs, in
the dense-dispatch form (GShard/Switch).  Routing is two products against
a [tokens, experts, capacity] dispatch/combine tensor: ``dispatch`` (the
combine's support, in the compute dtype) gathers each expert's tokens into
[E, C, d], the experts run as batched products, and ``combine`` (f32)
scatters their outputs back, weighted.  Top-k (default 2) softmax gating,
the combine weights renormalised over the selected experts, per-expert
capacity ``C = ceil(k S / E * factor)``; assignments past capacity fall
through the residual stream and are counted as the drop fraction.  The
Switch load-balance auxiliary loss (``E * sum_e f_e * mean_prob_e``, 1 at
perfect balance) is averaged over layers and added to the LM loss with
weight ``aux_weight``.

Three choices keep the routing equal to JAX's on every backend:

* top-k by a stable descending sort, so that equal gate probabilities
  pick the lower index first, as ``jax.lax.top_k`` does (``torch.topk``
  promises no order for ties);
* the positional dispatcher's overflow slot goes to an extra capacity
  column that is then dropped (``jax.nn.one_hot`` of an out-of-range
  class is an all-zero row, ``F.one_hot`` raises);
* the priority dispatcher places each kept route with a scatter, the
  values ``jnp.einsum("ecs,ec->sec", one_hot, w)`` yields.

Everything outside the MLP is ``models/gpt2.py`` (its attention registry
included, so flash B2/B3 runs at T >= ``AUTO_FLASH_MIN_T``), and the
params keep the stacked-blocks layout.  The routing and expert products
are library matmuls: in JAX they are XLA einsums outside any Pallas
kernel.

Expert parallelism, as in JAX: ``set_expert_mesh`` / ``use_expert_mesh``
bind the mesh whose ``expert`` axis the [E, C, d] expert blocks are
constrained to (the trainer binds it in ``parallelism="expert"``), and
``moe_ep_specs`` is the spec tree that shards the expert weights' E axis.
In JAX the constraints make GSPMD insert the all_to_all pair around the
expert FFNs; on a mesh whose positions share one device that exchange is
the identity, so the port's constraints are too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

Params = Dict[str, Any]
Tensor = torch.Tensor

_EXPERT_MESH: Any = None


def set_expert_mesh(mesh: Any) -> None:
    global _EXPERT_MESH
    _EXPERT_MESH = mesh


def get_expert_mesh() -> Any:
    return _EXPERT_MESH


@contextlib.contextmanager
def use_expert_mesh(mesh: Any) -> Iterator[None]:
    """Make MoE forwards constrain the expert blocks to ``mesh``'s
    ``expert`` axis (the pattern of ``parallel/sequence.use_sequence_mesh``)."""
    global _EXPERT_MESH
    prev = _EXPERT_MESH
    _EXPERT_MESH = mesh
    try:
        yield
    finally:
        _EXPERT_MESH = prev


def _expert_sharding() -> Optional[Any]:
    """The [E, C, d] blocks' sharding on the bound mesh (E over
    ``expert``), or None without a mesh or an ``expert`` axis."""
    from trustworthy_dl_tpu_torch.core import sharding as shreg
    from trustworthy_dl_tpu_torch.core.mesh import EXPERT_AXIS

    mesh = _EXPERT_MESH
    if mesh is None or EXPERT_AXIS not in mesh.axis_names:
        return None
    return shreg.rules_for("expert").named_sharding(
        mesh, shreg.EXPERT, None, None)


def _constrain(blocks: Tensor) -> Tensor:
    """JAX's ``with_sharding_constraint`` of the expert blocks to
    :func:`_expert_sharding`: GSPMD's all_to_all between token and expert
    layouts.  On positions that share one device (every mesh the port
    places on: ``core.sharding`` refuses a mesh of several devices) the
    exchange moves nothing, so this is the identity."""
    return blocks


@dataclasses.dataclass(frozen=True)
class MoEConfig(gpt2.GPT2Config):
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    # Slot assignment under capacity pressure:
    #   "positional" - GShard's in-order claim (rank-0 before rank-1,
    #                  earlier tokens before later): late tokens lose;
    #   "priority"   - each expert keeps its top-``capacity`` assignments
    #                  by gate probability: overflow drops the
    #                  lowest-probability routes.
    dispatch: str = "positional"

    def __post_init__(self) -> None:
        if self.dispatch not in ("positional", "priority"):
            raise ValueError(
                f"dispatch must be 'positional' or 'priority', got "
                f"{self.dispatch!r}"
            )

    @staticmethod
    def from_name(name: str, **overrides: Any) -> "MoEConfig":
        key = name.lower().replace("-moe", "")
        if key not in gpt2.GPT2_SIZES:
            raise ValueError(f"unknown GPT-2 size {name!r}")
        kwargs = dict(gpt2.GPT2_SIZES[key])
        kwargs.update(overrides)
        return MoEConfig(**kwargs)


# --------------------------------------------------------------------------
# Parameters: gpt2 blocks with the dense MLP swapped for router + experts
# --------------------------------------------------------------------------


def init_block_params(cfg: MoEConfig, generator: torch.Generator,
                      device: Any = "cpu") -> Params:
    """gpt2's stacked blocks with the dense MLP swapped for an f32 router
    [L, d, E] (gating decisions are control flow, not compute) and experts
    fc [L, E, d, 4d] and proj [L, E, 4d, d] (normal 0.02 and
    0.02 / sqrt(2 L), zero biases), as JAX's."""
    return _swap_mlp(gpt2.init_block_params(cfg, generator, device), cfg,
                     generator, device)


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device: Any = "cpu") -> Params:
    """gpt2.init_params with the blocks of :func:`init_block_params`.  The
    draws differ from the JAX init's; tests convert JAX weights with
    ``models.convert``."""
    params = gpt2.init_params(cfg, generator, device)
    _swap_mlp(params["blocks"], cfg, generator, device)
    return params


def _swap_mlp(blocks: Params, cfg: MoEConfig, generator: torch.Generator,
              device: Any) -> Params:
    """Replace ``blocks["mlp"]`` with the router and experts, in place."""
    n, d, e, f = cfg.n_layer, cfg.n_embd, cfg.n_experts, 4 * cfg.n_embd

    def normal(*shape: int, std: float) -> Tensor:
        return (torch.randn(*shape, generator=generator, device=device)
                * std)

    del blocks["mlp"]
    blocks["moe"] = {
        "router": {"w": normal(n, d, e, std=0.02)},
        "fc": {"w": normal(n, e, d, f, std=0.02),
               "b": torch.zeros(n, e, f, device=device)},
        "proj": {"w": normal(n, e, f, d, std=0.02 / math.sqrt(2 * n)),
                 "b": torch.zeros(n, e, d, device=device)},
    }
    return blocks


# --------------------------------------------------------------------------
# Routing + expert FFN
# --------------------------------------------------------------------------


def _capacity(num_tokens: int, cfg: MoEConfig) -> int:
    """Per-expert slot count: ceil(k S / E * factor), floored at 4 and
    then clamped to ``num_tokens`` (an expert holds at most every token;
    the priority dispatcher's top-``capacity`` over S needs C <= S), in
    JAX's order."""
    c = math.ceil(num_tokens * cfg.top_k / cfg.n_experts
                  * cfg.capacity_factor)
    return min(max(4, int(c)), num_tokens)


def _top_indices(values: Tensor, k: int) -> Tensor:
    """Indices of the ``k`` largest along the last axis, ties to the lower
    index (``jax.lax.top_k``'s order)."""
    return torch.sort(values, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _topk_gating(probs: Tensor, top_k: int
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Shared by both dispatchers: (raw top-k probs [S, k], renormalised
    combine weights [S, k], expert indices [S, k])."""
    topk_idx = _top_indices(probs, top_k)
    raw_probs = probs.gather(-1, topk_idx)
    norm = raw_probs.sum(dim=-1, keepdim=True)
    return raw_probs, raw_probs / norm.clamp(min=1e-9), topk_idx


def _switch_aux_loss(probs: Tensor, topk_idx: Tensor) -> Tensor:
    """Switch load-balance aux on rank-0 assignments: E * sum_e f_e *
    mean_prob_e (1 at perfect balance)."""
    e = probs.shape[1]
    top1 = F.one_hot(topk_idx[:, 0], e).float()
    return e * (top1.mean(dim=0) * probs.mean(dim=0)).sum()


def router_dispatch(probs: Tensor, cfg: MoEConfig, capacity: int
                    ) -> Tuple[Tensor, Tensor]:
    """[S, E] gate probs -> (combine f32 [S, E, C], aux f32 []).

    Top-k assignment with in-order positions: rank-0 choices claim slots
    before rank-1, positions past capacity drop.  Each assignment is
    scattered to its slot, an overflowing one to an extra column C that
    is dropped at the end.  The dispatch mask is ``combine > 0``."""
    s, e = probs.shape
    _, topk_probs, topk_idx = _topk_gating(probs, cfg.top_k)

    combine = torch.zeros(s, e, capacity + 1, device=probs.device)
    counts = torch.zeros(e, dtype=torch.long, device=probs.device)
    for r in range(cfg.top_k):
        onehot = F.one_hot(topk_idx[:, r], e)                       # [S, E]
        pos = onehot.cumsum(dim=0) - 1 + counts[None, :]
        within = (pos < capacity) & (onehot > 0)
        slot = torch.where(within, pos, torch.full_like(pos, capacity))
        value = topk_probs[:, r, None] * within.float()
        combine = combine.scatter_add(2, slot[..., None], value[..., None])
        counts = counts + onehot.sum(dim=0)
    return combine[..., :capacity], _switch_aux_loss(probs, topk_idx)


def router_dispatch_priority(probs: Tensor, cfg: MoEConfig, capacity: int
                             ) -> Tuple[Tensor, Tensor]:
    """[S, E] gate probs -> (combine f32 [S, E, C], aux f32 []).

    Sorted dispatch: each expert keeps its top-``capacity`` assignments by
    RAW gate probability (ties to the lower token), weighted by the
    renormalised one, so overflow sheds the lowest-confidence routes.
    Same contract as :func:`router_dispatch`; the same routes when
    nothing overflows."""
    s, e = probs.shape
    raw_probs, renorm_probs, topk_idx = _topk_gating(probs, cfg.top_k)

    rank = torch.zeros(s, e, device=probs.device)
    weight = torch.zeros(s, e, device=probs.device)
    for r in range(cfg.top_k):
        onehot = F.one_hot(topk_idx[:, r], e).float()
        rank = rank + onehot * raw_probs[:, r, None]
        weight = weight + onehot * renorm_probs[:, r, None]

    rank_t = rank.T                                                 # [E, S]
    token_idx = _top_indices(rank_t, capacity)                      # [E, C]
    keep = (rank_t.gather(1, token_idx) > 0.0).float()              # real
    w = weight.T.gather(1, token_idx)
    # combine[s, e, c] = w[e, c] iff token_idx[e, c] == s and kept.
    combine = torch.zeros(e, capacity, s, device=probs.device).scatter(
        2, token_idx[..., None], (w * keep)[..., None])
    return combine.permute(2, 0, 1), _switch_aux_loss(probs, topk_idx)


def moe_mlp(moe: Params, x: Tensor, cfg: MoEConfig
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """[B, T, d] -> ([B, T, d] f32, aux loss [], drop fraction []).  The
    router in f32, the dispatch and the experts in ``cfg.dtype``
    (tanh-approximate GELU, ``jax.nn.gelu``'s default), the combine in
    f32 for the residual add.  The drop fraction is the share of the S k
    routed assignments that exceeded expert capacity."""
    b, t, d = x.shape
    s = b * t
    xf = x.reshape(s, d)
    combine, aux = route(moe, xf, cfg, _capacity(s, cfg))          # [S, E, C]
    routed = combine > 0
    drop = 1.0 - routed.float().sum() / (s * cfg.top_k)
    expert_in = _constrain(dispatch_tokens(routed, xf, cfg.dtype))
    out = _constrain(experts(moe, expert_in, cfg.dtype))
    return combine_outputs(combine, out).reshape(b, t, d), aux, drop


def route(moe: Params, xf: Tensor, cfg: MoEConfig, capacity: int
          ) -> Tuple[Tensor, Tensor]:
    """Tokens [S, d] -> (f32 combine weights [S, E, C], aux loss []): the
    f32 router product, softmax and ``cfg.dispatch``'s dispatcher."""
    probs = torch.softmax(xf.float() @ moe["router"]["w"], dim=-1)
    dispatch_fn = (router_dispatch_priority if cfg.dispatch == "priority"
                   else router_dispatch)
    return dispatch_fn(probs, cfg, capacity)


def dispatch_tokens(routed: Tensor, xf: Tensor, dtype: torch.dtype) -> Tensor:
    """Token -> expert slots: bool [S, E, C] support, [S, d] -> [E, C, d]."""
    return torch.einsum("sec,sd->ecd", routed.to(dtype), xf.to(dtype))


def experts(moe: Params, expert_in: Tensor, dtype: torch.dtype) -> Tensor:
    """The expert FFNs as batched products: [E, C, d] -> [E, C, d]."""
    h = torch.einsum("ecd,edf->ecf", expert_in, moe["fc"]["w"].to(dtype))
    h = F.gelu(h + moe["fc"]["b"][:, None].to(dtype), approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, moe["proj"]["w"].to(dtype))
    return out + moe["proj"]["b"][:, None].to(dtype)


def combine_outputs(combine: Tensor, out: Tensor) -> Tensor:
    """Slots -> tokens, weighted, in f32: [S, E, C] x [E, C, d] -> [S, d]."""
    return torch.einsum("sec,ecd->sd", combine, out.float())


def block_forward(block: Params, x: Tensor, cfg: MoEConfig
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """gpt2's block with the MoE MLP; returns (x, aux, drop)."""
    x = gpt2.attention_residual(block, x, cfg)
    y, aux, drop = moe_mlp(block["moe"], L.layernorm(block["ln_2"], x), cfg)
    return x + y.to(x.dtype), aux, drop


def apply_blocks(blocks: Params, x: Tensor, cfg: MoEConfig
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Every block in turn -> (x, mean aux loss, mean capacity-drop
    fraction).  With ``cfg.remat`` each block is checkpointed whole (its
    forward, routing and flash kernels included, re-runs in the
    backward), as JAX's ``jax.checkpoint(body)``; ``remat_policy`` does
    not apply."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux_sum = torch.zeros((), device=x.device)
    drop_sum = torch.zeros((), device=x.device)
    for block in gpt2.unstack_blocks(blocks, cfg.n_layer):
        if remat:
            x, aux, drop = checkpoint(block_forward, block, x, cfg,
                                      use_reentrant=False)
        else:
            x, aux, drop = block_forward(block, x, cfg)
        aux_sum = aux_sum + aux
        drop_sum = drop_sum + drop
    return x, aux_sum / cfg.n_layer, drop_sum / cfg.n_layer


def forward(params: Params, tokens: Tensor, cfg: MoEConfig) -> Tensor:
    """tokens [B, T] -> f32 logits [B, T, V]."""
    x, _, _ = apply_blocks(params["blocks"], gpt2.embed(params, tokens), cfg)
    return gpt2.unembed(params, x, cfg)


def forward_with_monitor(params: Params, tokens: Tensor, cfg: MoEConfig
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """gpt2.forward_with_monitor's contract: (logits, pre-ln features,
    mean logits)."""
    x, _, _ = apply_blocks(params["blocks"], gpt2.embed(params, tokens), cfg)
    return gpt2.monitor_head(params, x, cfg)


def loss_with_monitor(params: Params, batch: Dict[str, Tensor],
                      cfg: MoEConfig
                      ) -> Tuple[Tensor, Tensor, Tensor, Dict[str, Tensor]]:
    """gpt2.loss_with_monitor's contract with the Switch aux loss folded
    in, plus a 4th element, the model diagnostics
    ``{"moe_drop_fraction": f32 []}`` the trusted step surfaces in
    ``StepMetrics.model_aux``.  The head (the fused vocab-chunked one
    where ``lm_head_chunk`` resolves) is gpt2.head_loss_and_signature."""
    x, aux, drop = apply_blocks(params["blocks"],
                                gpt2.embed(params, batch["input"]), cfg)
    lm, mean_logits = gpt2.head_loss_and_signature(params, x,
                                                   batch["target"], cfg)
    return (lm + cfg.aux_weight * aux, x, mean_logits,
            {"moe_drop_fraction": drop})


def loss_fn(params: Params, batch: Dict[str, Tensor], cfg: MoEConfig
            ) -> Tensor:
    return loss_with_monitor(params, batch, cfg)[0]


def moe_ep_specs(params: Params) -> Params:
    """Spec tree for expert parallelism: the expert weights (``moe`` but
    not its router, [L, E, ...]) shard their E axis over ``expert``, the
    layer axis and everything else replicate."""
    from trustworthy_dl_tpu_torch.core import sharding as shreg

    rules = shreg.rules_for("expert")

    def walk(node: Any, keys: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        if "moe" in keys and "router" not in keys:
            return rules.partition_spec(
                shreg.LAYER, shreg.EXPERT, *([None] * (node.dim() - 2)))
        return rules.partition_spec()

    return walk(params, ())


def num_params(params: Params) -> int:
    return sum(int(p.numel()) for p in tree_leaves(params))


__all__ = [
    "MoEConfig", "apply_blocks", "block_forward", "combine_outputs",
    "dispatch_tokens", "experts", "forward", "forward_with_monitor",
    "get_expert_mesh", "init_block_params", "init_params", "loss_fn",
    "loss_with_monitor", "moe_ep_specs", "moe_mlp", "num_params", "route",
    "router_dispatch", "router_dispatch_priority", "set_expert_mesh",
    "use_expert_mesh",
]
