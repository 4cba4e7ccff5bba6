"""Weights carried across from the JAX package.

``params_from_jax`` takes a JAX parameter pytree as numpy arrays (nested
dicts and lists) and returns the port's parameter tree: the same layout,
as tensors on a given device and dtype.  It takes the dense GPT-2 tree
(``blocks`` stacked with a leading layer axis), the MoE GPT-2 tree (the
same with ``blocks.mlp`` swapped for ``blocks.moe``: router, expert fc
and proj) and the ResNet and VGG trees (``blocks`` a list of dicts, a ResNet block with or without its
``proj`` / ``gn_proj``), and refuses any other.  The caller turns the JAX
arrays into numpy (``jax.tree_util.tree_map(np.asarray, params)``), so
this module needs no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from trustworthy_dl_tpu_torch.models.gpt2 import Params
from trustworthy_dl_tpu_torch.utils.tree import map_tree

#: Leaves the port's GPT-2 expects, as dotted paths.
GPT2_LEAVES = (
    "wte", "wpe", "ln_f.scale", "ln_f.bias",
    "blocks.ln_1.scale", "blocks.ln_1.bias",
    "blocks.attn.qkv.w", "blocks.attn.qkv.b",
    "blocks.attn.proj.w", "blocks.attn.proj.b",
    "blocks.ln_2.scale", "blocks.ln_2.bias",
    "blocks.mlp.fc.w", "blocks.mlp.fc.b",
    "blocks.mlp.proj.w", "blocks.mlp.proj.b",
)

#: Leaves of the MoE GPT-2 tree: the dense MLP's replaced by the router
#: [L, d, E] and the experts' fc [L, E, d, 4d] / proj [L, E, 4d, d].
MOE_LEAVES = tuple(p for p in GPT2_LEAVES if not p.startswith(
    "blocks.mlp.")) + (
    "blocks.moe.router.w", "blocks.moe.fc.w", "blocks.moe.fc.b",
    "blocks.moe.proj.w", "blocks.moe.proj.b",
)

_CONV = ("w", "b")
_NORM = ("scale", "bias")
_PROJ = {"proj": _CONV, "gn_proj": _NORM}
#: The block layouts of the vision families: (required, optional) parts.
_VISION_BLOCKS = (
    ({"conv1": _CONV, "gn1": _NORM, "conv2": _CONV, "gn2": _NORM}, _PROJ),
    ({"conv1": _CONV, "gn1": _NORM, "conv2": _CONV, "gn2": _NORM,
      "conv3": _CONV, "gn3": _NORM}, _PROJ),
    ({"conv": _CONV, "gn": _NORM}, {}),
)


def _leaf_paths(tree: Any, prefix: str = "") -> list:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_leaf_paths(v, f"{prefix}{k}."))
        return out
    return [prefix[:-1]]


def _parts_match(node: Any, parts: dict) -> bool:
    return isinstance(node, dict) and set(node) == set(parts) and all(
        isinstance(node[k], dict) and sorted(node[k]) == sorted(leaves)
        for k, leaves in parts.items())


def _is_vision_block(block: Any) -> bool:
    for required, optional in _VISION_BLOCKS:
        if not isinstance(block, dict) or not set(required) <= set(block):
            continue
        extra = {k: block[k] for k in block if k not in required}
        core = {k: block[k] for k in required}
        if _parts_match(core, required) and (
                not extra or _parts_match(extra, optional)):
            return True
    return False


def _is_vision_tree(tree: Any) -> bool:
    """A ResNet tree (stem, gn_stem, blocks, head) or a VGG tree (blocks,
    head) whose blocks are all of one family's layouts."""
    if not isinstance(tree, dict) or not isinstance(tree.get("blocks"), list):
        return False
    top = {"head": _CONV}
    if set(tree) == {"stem", "gn_stem", "blocks", "head"}:
        top.update(stem=_CONV, gn_stem=_NORM)
    elif set(tree) != {"blocks", "head"}:
        return False
    rest = {k: v for k, v in tree.items() if k != "blocks"}
    return _parts_match(rest, top) and bool(tree["blocks"]) and all(
        _is_vision_block(b) for b in tree["blocks"])


def params_from_jax(tree: Any, device: Any = "cpu",
                    dtype: torch.dtype = torch.float32) -> Params:
    """JAX params (numpy leaves) -> the port's params on ``device`` in
    ``dtype``.  Raises when the tree is none of a dense or MoE GPT-2 tree
    and a ResNet or VGG tree."""
    if not _is_vision_tree(tree):
        got = sorted(_leaf_paths(tree))
        if got not in (sorted(GPT2_LEAVES), sorted(MOE_LEAVES)):
            raise ValueError("not a dense or MoE GPT-2, ResNet or VGG "
                             f"parameter tree: leaves {got}")
    return map_tree(
        lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32).copy()
                                   ).to(device=device, dtype=dtype),
        tree)
