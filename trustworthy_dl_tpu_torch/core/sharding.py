"""The logical-axis sharding rules that pipeline mode reads.

Counterpart of the part of ``trustworthy_dl_tpu/core/sharding.py`` that
stage parallelism uses: the logical axis vocabulary, :func:`axis_rules`
and :class:`ShardingRules` (``rules_for("model")``: the trust node IS the
stage), with partition specs as plain tuples of mesh-axis names;
:func:`axis_size`; :func:`row_placer`, the one per-node-row placement
rule; the replicated placement; and :func:`tree_bytes_per_device`.

On the port's single-controller mesh (``core/mesh.py``) a placement is a
move onto a device: a leaf whose rows shard over an axis goes to that
axis's device, which on one card is the card every position holds.  Rows
spread over several devices would need a tensor per device, which the
port does not build yet: :func:`row_placer` raises naming ROADMAP Slice
4b for a mesh whose positions differ.  ZeRO/FSDP placement and the
serving tensor-parallel helpers wait for Slice 4b and 4c.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, EXPERT_AXIS, \
    MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, Mesh
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

# Logical axis vocabulary (the JAX package's names).
BATCH = "batch"
SEQLEN = "seqlen"
HEAD = "head"
HIDDEN = "hidden"
LAYER = "layer"
NODE = "node"
STAGE = "stage"
EXPERT = "expert"
W_TP = "w_tp"
W_FSDP = "w_fsdp"

LOGICAL_AXES = frozenset({
    BATCH, SEQLEN, HEAD, HIDDEN, LAYER, NODE, STAGE, EXPERT, W_TP, W_FSDP,
})

#: A partition spec: one mesh-axis name (or None, replicated) per dim.
PartitionSpec = Tuple[Optional[str], ...]


def axis_rules(parallelism: str, *,
               fsdp: bool = False) -> Dict[str, Optional[str]]:
    """Logical-axis -> mesh-axis table of one mode (JAX's table)."""
    base: Dict[str, Optional[str]] = {a: None for a in LOGICAL_AXES}
    base[BATCH] = DATA_AXIS
    base[NODE] = DATA_AXIS
    if parallelism == "model":
        base[NODE] = STAGE_AXIS
        base[STAGE] = STAGE_AXIS
    elif parallelism == "tensor":
        base[W_TP] = MODEL_AXIS
    elif parallelism == "sequence":
        base[SEQLEN] = SEQ_AXIS
        base[HEAD] = SEQ_AXIS
    elif parallelism == "expert":
        base[EXPERT] = EXPERT_AXIS
    elif parallelism == "hybrid":
        base[STAGE] = STAGE_AXIS
        base[W_TP] = MODEL_AXIS
        base[SEQLEN] = SEQ_AXIS
        base[HEAD] = SEQ_AXIS
        base[EXPERT] = EXPERT_AXIS
    elif parallelism != "data":
        raise ValueError(f"no sharding rules for parallelism={parallelism!r}")
    if fsdp:
        base[W_FSDP] = DATA_AXIS
    return base


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """One mode's resolved rule table: logical names in, mesh axes out;
    an unknown name raises."""

    parallelism: str
    table: Mapping[str, Optional[str]]

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        if logical is None:
            return None
        try:
            return self.table[logical]
        except KeyError:
            raise ValueError(
                f"unknown logical axis {logical!r} (known: "
                f"{sorted(LOGICAL_AXES)})") from None

    def partition_spec(self, *axes: Optional[str]) -> PartitionSpec:
        return tuple(self.mesh_axis(a) for a in axes)


def rules_for(parallelism: str, *, fsdp: bool = False) -> ShardingRules:
    return ShardingRules(parallelism, axis_rules(parallelism, fsdp=fsdp))


def axis_size(mesh: Mesh, mesh_axis: str) -> int:
    return int(mesh.shape.get(mesh_axis, 1))


def _one_device(mesh: Mesh) -> torch.device:
    devices = {str(d): d for d in mesh.devices.flat}
    if len(devices) != 1:
        raise NotImplementedError(
            f"placement over {len(devices)} devices is not ported yet "
            "(ROADMAP Slice 4b: one tensor per device); the port's mesh "
            "holds one card")
    return next(iter(devices.values()))


def replicated_placer(mesh: Mesh) -> Callable[[Any], Any]:
    """Move a leaf onto the mesh (every position holds a full copy)."""
    device = _one_device(mesh)

    def place(leaf: Any) -> Any:
        return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf

    return place


def row_placer(mesh: Mesh, mesh_axis: str, n: int) -> Callable[[Any], Any]:
    """THE per-node-row placement rule, JAX's: a leaf with leading dim
    ``n`` has its rows over ``mesh_axis``, anything else replicates.  On
    one card both land on that card."""
    del mesh_axis, n   # every position of a one-card mesh is one device
    return replicated_placer(mesh)


def tree_bytes_per_device(tree: Any) -> int:
    """Bytes of a placed tree on its busiest device: every tensor leaf
    whole (the port's placements hold each leaf on one device)."""
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))


__all__ = ["BATCH", "EXPERT", "HEAD", "HIDDEN", "LAYER", "LOGICAL_AXES",
           "NODE", "SEQLEN", "STAGE", "ShardingRules", "W_FSDP", "W_TP",
           "axis_rules", "axis_size", "replicated_placer", "row_placer",
           "rules_for", "tree_bytes_per_device"]
