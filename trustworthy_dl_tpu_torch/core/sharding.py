"""The logical-axis sharding registry: the one place partition specs are
spelled.

Counterpart of ``trustworthy_dl_tpu/core/sharding.py``: the logical axis
vocabulary, :func:`axis_rules` and :class:`ShardingRules` (one table a
mode; ``named_sharding`` resolves a mesh axis absent from the mesh to
None), :func:`resolve_tree`, the mesh-axis helpers (:func:`row_spec`,
:func:`replicated_spec`, :func:`row_placer`), the ZeRO/FSDP rule
(:func:`zero_shard_spec`, :func:`place_zero_sharded`),
:func:`tree_bytes_per_device` and :func:`mesh_spec_tree`.  A partition
spec is a plain tuple of mesh-axis names (None: that dim replicated).

A torch tensor carries no sharding, so the layout is data the port
carries beside the state: :func:`layout_specs` computes the spec trees of
the params and the optimizer state from the mode, the mesh and the trees
(JAX's "one spelling": the trainer's initialisation, checkpoint restore,
topology adoption, eviction and readmission all call it).  On one card
every position of the single-controller mesh (``core/mesh.py``) is that
card, so placement is a move onto it and a leaf with a spec stays one
dense tensor there: JAX's GSPMD computes the replicated program's values,
and the port runs the replicated step.  :func:`tree_bytes_per_device`
reads the specs, JAX's ``shard_shape`` arithmetic: it counts bytes per
*position* (on one card the device holds every leaf whole).  A mesh
whose positions are different devices would need a tensor per device in
one process and is refused: the port runs one process a card
(``core/mesh.initialize_multihost``), and a mesh that spans processes
places on this process's own position.

Serving's tensor-parallel replicas (:func:`serve_tp_mesh`,
:func:`place_serve_tp`) carry the same TP layout as training, one spec
tree for both planes; by default the positions of a replica's group all
share the engine's device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, EXPERT_AXIS, \
    MODEL_AXIS, SEQ_AXIS, STAGE_AXIS, Mesh
from trustworthy_dl_tpu_torch.utils.tree import map_tree, tree_leaves, \
    tree_unflatten

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

#: A partition spec: one mesh-axis name, a tuple of names, or None
#: (replicated) per leading dim; the dims past its end replicate.
PartitionSpec = Tuple[Union[None, str, Tuple[str, ...]], ...]


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

    def named_sharding(self, mesh: Mesh, *axes: Optional[str]
                       ) -> "NamedSharding":
        """Mesh-aware resolution: a rule whose mesh axis is absent from
        ``mesh`` resolves to None, so one logical declaration serves every
        mesh the mode can build."""
        resolved = [self.mesh_axis(a) for a in axes]
        return NamedSharding(mesh, tuple(
            a if a in mesh.axis_names else None for a in resolved))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``): metadata beside a dense
    tensor."""

    mesh: Mesh
    spec: PartitionSpec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape one position holds: each sharded dim divided by the
        product of its axes' sizes (rounded up on the busiest position)."""
        out = list(shape)
        for i, axes in enumerate(self.spec):
            if axes is None:
                continue
            names = (axes,) if isinstance(axes, str) else tuple(axes)
            ways = math.prod(axis_size(self.mesh, a) for a in names)
            out[i] = -(-out[i] // ways)
        return tuple(out)


def rules_for(parallelism: str, *, fsdp: bool = False) -> ShardingRules:
    return ShardingRules(parallelism, axis_rules(parallelism, fsdp=fsdp))


def resolve_tree(axes_tree: Any, rules: ShardingRules) -> Any:
    """Translate a logical-axis declaration tree (leaves are tuples of
    logical names, one per dim) into a spec tree."""
    return map_tree(lambda axes: rules.partition_spec(*axes), axes_tree)


# ---------------------------------------------------------------------------
# Mesh-axis helpers: the shared spellings every placement site funnels
# through.
# ---------------------------------------------------------------------------


def replicated_spec() -> PartitionSpec:
    return ()


def row_spec(mesh_axis: str, ndim: int = 1) -> PartitionSpec:
    """Leading-dim sharding for a per-node/per-stage row array."""
    return (mesh_axis,) + (None,) * (max(ndim, 1) - 1)


def axis_size(mesh: Mesh, mesh_axis: str) -> int:
    return int(mesh.shape.get(mesh_axis, 1))


def device_key(device: Any) -> Tuple[str, int]:
    """(type, index): "cuda" and "cuda:0" name one card."""
    device = torch.device(device)
    return device.type, device.index or 0


def distinct_devices(mesh: Mesh) -> int:
    """How many different devices the mesh's positions lie on (positions
    may share one: on one card every position is that card)."""
    return len({device_key(d) for d in mesh.devices.flat})


def _one_device(mesh: Mesh) -> torch.device:
    """The device this process places onto: the mesh's one device, or in
    a mesh that spans processes this process's own position."""
    positions = list(mesh.devices.flat)
    if mesh.process_index is not None:
        positions = [positions[mesh.process_index]]
    devices = {device_key(d): d for d in positions}
    if len(devices) != 1:
        raise NotImplementedError(
            f"placement over {len(devices)} devices in one process is not "
            "ported: one process a card: initialize_multihost "
            "(core/mesh.py), each process placing onto its own position")
    return next(iter(devices.values()))


def replicated_placer(mesh: Mesh) -> Callable[[Any], Any]:
    """Move a leaf onto the mesh (every position holds a full copy)."""
    device = _one_device(mesh)

    def place(leaf: Any) -> Any:
        return leaf.to(device) if isinstance(leaf, torch.Tensor) else leaf

    return place


def row_placer(mesh: Mesh, mesh_axis: str, n: int) -> Callable[[Any], Any]:
    """THE per-node-row placement rule, JAX's: a leaf with leading dim
    ``n`` has its rows over ``mesh_axis`` (where the axis divides ``n``),
    anything else replicates.  On one card both land on that card."""
    del mesh_axis, n   # every position of a one-card mesh is one device
    return replicated_placer(mesh)


# ---------------------------------------------------------------------------
# ZeRO/FSDP: the generalized ``zero1_place_opt_state``.
# ---------------------------------------------------------------------------


def zero_shard_spec(shape: Sequence[int], n_shards: int,
                    mesh_axis: str) -> PartitionSpec:
    """First evenly-divisible dim shards over ``mesh_axis``; leaves with
    no such dim (scalars, odd shapes) replicate.  The ZeRO-1 moment rule,
    which FSDP applies to the params too."""
    for i, dim in enumerate(shape):
        if dim >= n_shards and dim % n_shards == 0:
            spec: list = [None] * len(shape)
            spec[i] = mesh_axis
            return tuple(spec)
    return ()


def zero_specs(tree: Any, mesh: Mesh, mesh_axis: str = DATA_AXIS) -> Any:
    """The ZeRO/FSDP spec of every leaf of ``tree``: its first
    evenly-divisible dim over ``mesh_axis``; everything replicates where
    the axis is absent or of size 1."""
    n = axis_size(mesh, mesh_axis)

    def spec(leaf: Any) -> PartitionSpec:
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and n > 1:
            return zero_shard_spec(tuple(leaf.shape), n, mesh_axis)
        return ()

    return map_tree(spec, tree)


def place_zero_sharded(tree: Any, mesh: Mesh, mesh_axis: str = DATA_AXIS
                       ) -> Tuple[Any, Any]:
    """ZeRO/FSDP placement of a whole tree: (the tree on the mesh, its
    :func:`zero_specs`).  An n-way axis keeps ~1/n of the bytes a
    position (:func:`tree_bytes_per_device`)."""
    return map_tree(replicated_placer(mesh), tree), \
        zero_specs(tree, mesh, mesh_axis)


def follow_specs(opt_state: Any, params: Any, param_specs: Any) -> Dict:
    """The spec tree of an optimizer state (``engine/optimizer.OptState``:
    a count, and moment lists in ``utils.tree`` leaf order) whose moments
    follow their params: a moment leaf of its param's shape takes the
    param's spec, matched by leaf index; a statistic of another shape
    (Adafactor's factored row and column means) and the count
    replicate."""
    p_leaves = tree_leaves(params)
    s_leaves = tree_leaves(param_specs)

    def aligned(moments: Sequence[torch.Tensor]) -> list:
        if not moments:     # SGD's second moment, Adafactor's first
            return []
        out, j = [], 0
        for p, spec in zip(p_leaves, s_leaves):
            if j < len(moments) and tuple(moments[j].shape) == \
                    tuple(p.shape):
                out.append(spec)
                j += 1
            else:
                # Adafactor: a factored pair (v_row, v_col) stands here.
                out += [(), ()]
                j += 2
        if j != len(moments):
            raise ValueError(f"optimizer state holds {len(moments)} "
                             f"moments, the params' walk reached {j}")
        return out

    return {"count": (), "mu": aligned(opt_state.mu),
            "nu": aligned(opt_state.nu)}


def opt_state_tree(opt_state: Any) -> Dict:
    """An ``OptState`` as the tree its specs describe."""
    return {"count": opt_state.count, "mu": list(opt_state.mu),
            "nu": list(opt_state.nu)}


def tp_owns_params(parallelism: str, mesh: Mesh) -> bool:
    """Does the tensor-parallel layout cover every param leaf?  Tensor
    mode, and hybrid mode on a mesh with a ``model`` axis (JAX's
    ``_tp_placement_owns_params``)."""
    return parallelism == "tensor" or (
        parallelism == "hybrid" and MODEL_AXIS in mesh.axis_names)


def layout_specs(parallelism: str, mesh: Mesh, params: Any,
                 opt_state: Any, *, shard_params: bool = False,
                 shard_opt_state: bool = False) -> Dict[str, Any]:
    """THE layout of the state on ``mesh``: ``{"params": spec tree,
    "opt_state": {"count", "mu", "nu"}}``, JAX's placements, each rule
    through this registry.

    * data mode on a data axis of more than one position:
      ``shard_params`` (FSDP) gives the params :func:`zero_specs`, and
      ``shard_opt_state`` (ZeRO-1) or ``shard_params`` the optimizer
      state;
    * tensor mode, and hybrid with a ``model`` axis: the TP layout
      (``parallel/tensor_parallel.apply_tp_sharding``), the moments
      following their params (``apply_tp_sharding_to_opt``);
    * model (pipeline) mode: every block leaf's leading stage dim over
      ``stage`` (JAX's ``row_sharding(mesh, "stage")``), the moments
      following;
    * everything else replicates (sequence, expert, data without the
      flags).

    Leaves are moved nowhere: the caller's tensors already lie on the
    mesh's one device (:func:`replicated_placer` refuses a mesh of
    several)."""
    _one_device(mesh)
    data_sharded = parallelism == "data" and axis_size(mesh, DATA_AXIS) > 1
    if data_sharded and shard_params:
        pspecs = zero_specs(params, mesh, DATA_AXIS)
    elif tp_owns_params(parallelism, mesh):
        from trustworthy_dl_tpu_torch.parallel.tensor_parallel import \
            apply_tp_sharding

        pspecs = apply_tp_sharding(params, mesh)[1]
    elif parallelism == "model":
        pspecs = {k: map_tree(lambda _: row_spec(STAGE_AXIS), v)
                  if k == "blocks" else map_tree(lambda _: (), v)
                  for k, v in params.items()}
    else:
        pspecs = map_tree(lambda _: replicated_spec(), params)
    if data_sharded and (shard_opt_state or shard_params):
        ospecs = zero_specs(opt_state_tree(opt_state), mesh, DATA_AXIS)
    else:
        ospecs = follow_specs(opt_state, params, pspecs)
    return {"params": pspecs, "opt_state": ospecs}


def tree_bytes_per_device(tree: Any, specs: Any = None,
                          mesh: Optional[Mesh] = None) -> int:
    """Bytes of a placed tree on its busiest position: each tensor leaf's
    shard under its spec (JAX's ``shard_shape`` arithmetic), a leaf
    without a spec whole.  ``specs`` None counts every leaf whole.  This
    is per *position*: where positions share one device, that device
    holds every leaf whole."""
    leaves = tree_leaves(tree)
    spec_leaves = [None] * len(leaves) if specs is None else \
        tree_leaves(specs)
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                         "leaves")
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        if not isinstance(leaf, torch.Tensor):
            continue
        shape = tuple(leaf.shape)
        if spec and mesh is not None:
            shape = NamedSharding(mesh, spec).shard_shape(shape)
        total += math.prod(shape) * leaf.element_size()
    return total


def mesh_spec_tree(tree: Any, specs: Any) -> Any:
    """The specs of a placed tree, leaf for leaf (JAX's ``mesh_spec_tree``
    reads them off the arrays; the port's tensors carry none): each
    tensor leaf's spec, checked no longer than its rank, None where the
    tree holds no tensor.  The surface layout tests pin."""
    leaves, spec_leaves = tree_leaves(tree), tree_leaves(specs)
    if len(leaves) != len(spec_leaves):
        raise ValueError(f"{len(spec_leaves)} specs for {len(leaves)} "
                         "leaves")
    out = []
    for leaf, spec in zip(leaves, spec_leaves):
        if not isinstance(leaf, torch.Tensor):
            out.append(None)
            continue
        if len(spec) > leaf.dim():
            raise ValueError(f"spec {spec} longer than a rank-{leaf.dim()} "
                             "leaf")
        out.append(spec)
    return tree_unflatten(tree, out)


# ---------------------------------------------------------------------------
# Serving: tensor-parallel replica meshes.
# ---------------------------------------------------------------------------


def serve_tp_mesh(tp_size: int, devices: Optional[Sequence[Any]] = None,
                  device: Any = "cpu") -> Mesh:
    """A serve replica's TP mesh: ``tp_size`` positions over the ``model``
    axis.  The fleet carves per-replica device slices and passes them
    here; without ``devices`` every position is ``device`` (the engine's:
    the group's positions share the card, where JAX takes the first
    ``tp_size`` local devices)."""
    if tp_size < 1:
        raise ValueError("tp_size must be >= 1")
    devices = [torch.device(d) for d in devices] if devices is not None \
        else [torch.device(device)] * tp_size
    if len(devices) < tp_size:
        raise ValueError(
            f"serve TP mesh needs {tp_size} devices, have {len(devices)}")
    positions = np.empty(tp_size, dtype=object)
    positions[:] = devices[:tp_size]
    return Mesh(positions, (MODEL_AXIS,))


def place_serve_tp(params: Any, mesh: Mesh) -> Tuple[Any, Any]:
    """(serve params on the replica's mesh, their TP specs): the model's
    declared TP layout through the same registry rules training TP uses,
    one layout for both planes.  Every spec replicates on a mesh without
    a ``model`` axis."""
    from trustworthy_dl_tpu_torch.parallel.tensor_parallel import \
        apply_tp_sharding

    return apply_tp_sharding(params, mesh)


__all__ = ["BATCH", "EXPERT", "HEAD", "HIDDEN", "LAYER", "LOGICAL_AXES",
           "NODE", "NamedSharding", "SEQLEN", "STAGE", "ShardingRules",
           "W_FSDP", "W_TP", "axis_rules", "axis_size", "device_key",
           "distinct_devices",
           "follow_specs", "layout_specs", "mesh_spec_tree",
           "opt_state_tree", "place_serve_tp", "place_zero_sharded",
           "replicated_placer", "replicated_spec", "resolve_tree",
           "row_placer", "row_spec", "rules_for", "serve_tp_mesh",
           "tp_owns_params", "tree_bytes_per_device", "zero_shard_spec",
           "zero_specs"]
