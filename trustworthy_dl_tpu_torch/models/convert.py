"""Weights carried across from the JAX package.

``params_from_jax`` takes the JAX GPT-2 parameter pytree as numpy arrays
(nested dicts; ``blocks`` stacked with a leading layer axis) and returns
the port's parameter dict: the same layout, as tensors on a given device
and dtype.  The caller turns the JAX arrays into numpy
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs no
JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from trustworthy_dl_tpu_torch.models.gpt2 import Params, map_tree

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


def _leaf_paths(tree: Any, prefix: str = "") -> list:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_leaf_paths(v, f"{prefix}{k}."))
        return out
    return [prefix[:-1]]


def params_from_jax(tree: Any, device: Any = "cpu",
                    dtype: torch.dtype = torch.float32) -> Params:
    """JAX GPT-2 params (numpy leaves) -> the port's params on ``device``
    in ``dtype``.  Raises when the tree is not a dense GPT-2 pytree."""
    got = sorted(_leaf_paths(tree))
    if got != sorted(GPT2_LEAVES):
        raise ValueError(f"not a dense GPT-2 parameter tree: leaves {got}")
    return map_tree(
        lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32).copy()
                                   ).to(device=device, dtype=dtype),
        tree)
