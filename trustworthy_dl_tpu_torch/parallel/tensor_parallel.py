"""Tensor parallelism: the Megatron layout over the ``model`` axis.

Counterpart of ``trustworthy_dl_tpu/parallel/tensor_parallel.py``.  JAX's
tensor parallelism is declarative: the layout is annotated on the
parameter tree and GSPMD partitions the matmuls and inserts the
collectives, computing the replicated program's values.  The port keeps
the annotation as a spec tree beside dense tensors (``core/sharding.py``)
and runs the replicated step: on one card every position of the mesh is
that card.

Layout (a GPT-2 block): qkv and mlp-fc weights ``[D, k D]`` shard their
output dim (column parallel), attn-proj and mlp-proj ``[k D, D]`` their
input dim (row parallel); column-parallel biases shard, row-parallel
biases, embeddings and norms replicate.  It is the model's logical
declaration (``models/gpt2.logical_axes``) resolved under the ``tensor``
rules.  The trust unit stays the data shard: tensor mode builds a
``(data, model)`` mesh with a TP group a node (``core/mesh.build_mesh``).

The optimizer state is the port's ``OptState`` (moment lists in
``utils.tree`` leaf order, not optax's params-structured tree), so a
moment "follows its param" by leaf index and shape; a statistic of
another shape (Adafactor's factored row and column means) replicates.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.core.mesh import MODEL_AXIS, Mesh
from trustworthy_dl_tpu_torch.utils.tree import map_tree

Params = Dict[str, Any]

#: One rule table for the module: no spec is spelled here.
_TP_RULES = shreg.rules_for("tensor")


def gpt2_tp_specs(params: Params) -> Params:
    """Spec tree of GPT-2 params: the model's logical-axis declaration
    resolved through the registry (blocks have a leading layer axis)."""
    from trustworthy_dl_tpu_torch.models.gpt2 import logical_axes

    del params   # the declaration is the model's, not the tree's
    return shreg.resolve_tree(logical_axes(), _TP_RULES)


def _paths(tree: Any, prefix: str = "") -> set:
    if isinstance(tree, dict):
        return {p for k, v in tree.items()
                for p in _paths(v, f"{prefix}['{k}']")}
    return {prefix}


def _spec_tree_for(params: Params) -> Params:
    """The spec tree matched to ``params``.  Vision trees (no ``blocks``
    and ``wte``) replicate: TP is a transformer play.  A layout whose
    paths differ from the params' raises at once, naming them."""
    if not ("blocks" in params and "wte" in params):
        return map_tree(lambda _: shreg.replicated_spec(), params)
    specs = gpt2_tp_specs(params)
    p_paths, s_paths = _paths(params), _paths(specs)
    if p_paths != s_paths:
        missing = sorted(p_paths - s_paths)
        extra = sorted(s_paths - p_paths)
        raise ValueError(
            "TP layout does not match the parameter tree; "
            f"params-only paths: {missing[:8]}, layout-only paths: "
            f"{extra[:8]}")
    return specs


def apply_tp_sharding(params: Params, mesh: Mesh) -> Tuple[Params, Params]:
    """(params on the mesh, their TP specs); every spec replicated when
    the mesh has no ``model`` axis."""
    placed = map_tree(shreg.replicated_placer(mesh), params)
    if MODEL_AXIS not in mesh.axis_names:
        return placed, map_tree(lambda _: shreg.replicated_spec(), params)
    return placed, _spec_tree_for(params)


def apply_tp_sharding_to_opt(opt_state: Any, params: Params, mesh: Mesh
                             ) -> Tuple[Any, Dict]:
    """(optimizer state on the mesh, its specs): each moment of its
    param's shape takes the param's TP spec; the count and statistics of
    other shapes replicate."""
    place = shreg.replicated_placer(mesh)
    placed = opt_state._replace(count=place(opt_state.count),
                                mu=[place(m) for m in opt_state.mu],
                                nu=[place(v) for v in opt_state.nu])
    _, pspecs = apply_tp_sharding(params, mesh)
    return placed, shreg.follow_specs(opt_state, params, pspecs)


def tp_group_size(mesh: Mesh) -> int:
    return int(mesh.shape.get(MODEL_AXIS, 1))


__all__ = ["apply_tp_sharding", "apply_tp_sharding_to_opt",
           "gpt2_tp_specs", "tp_group_size"]
