"""The device mesh of a training run: a single-controller mesh.

Counterpart of ``trustworthy_dl_tpu/core/mesh.py``.  The JAX package's
mesh is single-controller: one process holds every device, and a
collective is an op inside the compiled step.  The port keeps that shape
without a process group: a :class:`Mesh` holds axis names and an array of
``torch.device``s, one per position, and reports ``.shape`` as a dict.
Under pipelining each stage's block slice and its activations live on its
position's device, and JAX's ``ppermute`` to the next stage is
``tensor.to(next_device)``, a no-op when both stages share a device; ring
attention's K/V rotation is the same move (``parallel/sequence.py``).
On one card every position is that card (``cuda:0``); in the tests every
position is the CPU.

``build_mesh`` ports JAX's arms over the positions given (default one,
``device``; positions may repeat a device): ``data`` a node axis after
JAX's fit rule (one position: JAX's one-device layout), ``model`` a
``(1, S)`` data x stage layout, JAX's layout off a TPU, ``tensor``,
``sequence`` and ``expert`` JAX's ``(nodes, group)`` layout under their
own axis name, and ``hybrid`` the explicit ``mesh_shape``
(:func:`build_hybrid_mesh`, by default over as many positions of
``device`` as the shape names).  A DCN extent above 1 asks for JAX's
grouping by slice across processes: it is refused by name once the
positions suffice.  JAX's ``shard_map_compat`` has no counterpart: the
per-position loops of ``parallel/`` play its part.

Several processes: :func:`initialize_multihost` /
:func:`shutdown_multihost` are JAX's, over ``torch.distributed``'s gloo
backend, one process a card (PyTorch's idiom, where one JAX process owns
several devices).  With a group initialised ``build_mesh(n, "data")``
lays the ``data`` axis over the ranks: position r is rank r's device, the
node rows split contiguously by rank, and the mesh records this
process's position (``Mesh.process_index``), which is where it places.
The gathered trusted step (``engine/step.build_train_step``'s
``process_group``) is what runs across them.  A collective stages its
tensors through host memory, so it needs no CUDA collective library.
"""

from __future__ import annotations

import datetime
import logging
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: How long a rank waits for the others at set-up and at a collective
#: before it fails: a rank that never arrives raises, it does not hang.
MULTIHOST_TIMEOUT = datetime.timedelta(seconds=60)

# Canonical axis names, the JAX package's.
DATA_AXIS = "data"     # data-parallel shards
STAGE_AXIS = "stage"   # pipeline stages (the reference's layer-split nodes)
MODEL_AXIS = "model"   # tensor parallel
SEQ_AXIS = "seq"       # sequence / context parallel
EXPERT_AXIS = "expert"  # expert parallel (MoE)

_PARALLELISM_AXIS = {
    "data": DATA_AXIS,
    "model": STAGE_AXIS,
    "tensor": MODEL_AXIS,
    "sequence": SEQ_AXIS,
    "expert": EXPERT_AXIS,
}

#: Outermost-first axis order (JAX's).
AXIS_ORDER = (DATA_AXIS, STAGE_AXIS, MODEL_AXIS, SEQ_AXIS, EXPERT_AXIS)


def node_axis_for(parallelism: str) -> str:
    """Mesh axis that plays the role of the reference's node index."""
    try:
        return _PARALLELISM_AXIS[parallelism]
    except KeyError:
        raise ValueError(
            f"no canonical node axis for parallelism={parallelism!r}")


class Mesh:
    """Axis names over an array of ``torch.device``s (one per position).
    ``process_index`` is None for the single-controller mesh; for a mesh
    that spans processes it is this process's position (its rank)."""

    def __init__(self, devices: Any, axis_names: Sequence[str],
                 process_index: Optional[int] = None):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.process_index = process_index

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def positions(self, axis: str) -> list:
        """The devices along ``axis`` at index 0 of every other axis."""
        k = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            index[k] = i
            out.append(self.devices[tuple(index)])
        return out

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devices})"


def _device_list(num: int, device: Any, devices: Optional[Sequence[Any]]
                 ) -> list:
    """``num`` positions: ``devices`` in turn (several stages may share
    one), else ``device`` at every position."""
    if devices is None:
        devices = [device]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("build_mesh: no devices")
    return [devices[i % len(devices)] for i in range(num)]


def _grid(positions: Sequence[torch.device], shape: Sequence[int]
          ) -> np.ndarray:
    """The first ``prod(shape)`` positions, row-major in ``shape``."""
    arr = np.empty(tuple(shape), dtype=object)
    for i, dev in enumerate(positions[:arr.size]):
        arr[np.unravel_index(i, arr.shape)] = dev
    return arr


def build_hybrid_mesh(ici_mesh_shape: Dict[str, int],
                      dcn_mesh_shape: Optional[Dict[str, int]] = None,
                      devices: Optional[Sequence[Any]] = None,
                      device: Any = "cpu") -> Mesh:
    """JAX's multi-slice mesh: a per-axis extent within a slice (ICI) and
    across slices (DCN), the axes in :data:`AXIS_ORDER`.  The positions
    are ``devices``, by default the product of the extents, every one
    ``device``.  With every DCN extent at 1 the layout is a reshape in
    axis order, as in JAX; a DCN extent counts against the positions
    (the shortfall raises "needs"), and above 1 it asks for JAX's grouping
    by slice across processes, which the port refuses."""
    dcn_mesh_shape = dcn_mesh_shape or {}
    extra = (set(ici_mesh_shape) | set(dcn_mesh_shape)) - set(AXIS_ORDER)
    if extra:
        raise ValueError(f"unknown mesh axes {extra}")
    order = [a for a in AXIS_ORDER
             if a in ici_mesh_shape or a in dcn_mesh_shape]
    ici = [int(ici_mesh_shape.get(a, 1)) for a in order]
    dcn = [int(dcn_mesh_shape.get(a, 1)) for a in order]
    total = int(np.prod(ici)) * int(np.prod(dcn))
    positions = [torch.device(d) for d in devices] if devices is not None \
        else [torch.device(device)] * total
    if total > len(positions):
        raise ValueError(
            f"hybrid mesh ici={ici_mesh_shape} dcn={dcn_mesh_shape} needs "
            f"{total} devices, have {len(positions)}")
    if any(d > 1 for d in dcn):
        raise NotImplementedError(
            f"dcn_mesh_shape={dcn_mesh_shape} groups positions by slice "
            "across processes, which the port does not: one process a "
            "card: initialize_multihost, whose mesh is the data axis over "
            "the ranks")
    return Mesh(_grid(positions, ici), tuple(order))


def build_mesh(num_nodes: int, parallelism: str = "data",
               mesh_shape: Optional[Dict[str, int]] = None,
               devices: Optional[Sequence[Any]] = None,
               dcn_mesh_shape: Optional[Dict[str, int]] = None,
               device: Any = "cpu") -> Mesh:
    """The mesh of a run over the positions ``devices`` (default one,
    ``device``; positions may repeat a device).  ``hybrid``: the explicit
    ``mesh_shape`` (:func:`build_hybrid_mesh`; required, as in JAX).
    ``model``: a ``(1, S)`` data x stage mesh, stage s on
    ``devices[s % len(devices)]``.  The others follow JAX's fit rule:
    with more nodes than positions the node axis takes the largest
    divisor of ``num_nodes`` that fits; then ``data`` is a node axis of
    that many positions, and ``tensor``, ``sequence`` and ``expert`` give
    each node a group of ``len(devices) // nodes`` positions, a
    ``(nodes, group)`` mesh over ``data`` and the mode's axis.  A
    ``dcn_mesh_shape`` outside hybrid mode raises, as in JAX.  With a
    process group of more than one rank initialised and no ``devices``,
    ``data`` is :func:`process_data_mesh`; the other modes are refused."""
    if devices is None and process_count() > 1:
        if parallelism != "data" or mesh_shape or dcn_mesh_shape:
            raise NotImplementedError(
                f"parallelism={parallelism!r} across {process_count()} "
                "processes: only the data axis spans processes (one "
                "process a card)")
        return process_data_mesh(num_nodes, device)
    if parallelism == "hybrid":
        if not mesh_shape:
            raise ValueError("hybrid parallelism requires mesh_shape")
        return build_hybrid_mesh(mesh_shape, dcn_mesh_shape, devices,
                                 device=device)
    if dcn_mesh_shape:
        raise ValueError(
            "dcn_mesh_shape requires parallelism='hybrid' (got "
            f"{parallelism!r}); express the within-slice layout in "
            "mesh_shape and the across-slice extents in dcn_mesh_shape")
    axis = node_axis_for(parallelism)
    if axis == STAGE_AXIS:
        arr = np.empty((1, num_nodes), dtype=object)
        for s, dev in enumerate(_device_list(num_nodes, device, devices)):
            arr[0, s] = dev
        return Mesh(arr, (DATA_AXIS, STAGE_AXIS))
    positions = [torch.device(d) for d in (devices or [device])]
    if not positions:
        raise ValueError("build_mesh: no devices")
    n_dev = len(positions)
    if num_nodes > n_dev:
        # JAX's degenerate mode: the node axis takes the largest divisor
        # of num_nodes that fits (the nodes run in turn).
        num_nodes = max(d for d in range(1, n_dev + 1)
                        if num_nodes % d == 0)
    if axis == DATA_AXIS:
        return Mesh(_grid(positions, (num_nodes,)), (DATA_AXIS,))
    group = n_dev // num_nodes
    return Mesh(_grid(positions, (num_nodes, group)), (DATA_AXIS, axis))


def bind_mode_mesh(mesh: Mesh, parallelism: str) -> None:
    """Bind the global mesh of the modes whose forwards read one, as JAX
    does: the sequence mesh of ring and Ulysses attention, MoE's expert
    mesh.  The one binding ladder, shared by trainer construction, the
    elastic mesh rebuilds and checkpoint topology adoption; a no-op for
    the other modes.  The imports are lazy to keep core/ free of
    parallel/ and models/ dependencies."""
    if parallelism == "sequence":
        from trustworthy_dl_tpu_torch.parallel.sequence import \
            set_sequence_mesh

        set_sequence_mesh(mesh)
    elif parallelism == "expert":
        from trustworthy_dl_tpu_torch.models.moe import set_expert_mesh

        set_expert_mesh(mesh)


def stage_devices(mesh: Mesh) -> list:
    """The device of every pipeline stage, in stage order."""
    return mesh.positions(STAGE_AXIS)


def local_device_count() -> int:
    """Cards this process sees (1 without CUDA: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def _group_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Join the process group of a multi-process run (JAX's
    ``jax.distributed.initialize``), over gloo.  The coordinator is
    ``tcp://<coordinator_address>`` (``host:port``) when given, else
    ``env://``, which reads ``MASTER_ADDR`` and ``MASTER_PORT`` (and
    ``WORLD_SIZE`` and ``RANK`` where the arguments leave them out), as
    ``torchrun`` sets them.  A rank that does not arrive within
    :data:`MULTIHOST_TIMEOUT` makes the others raise."""
    import torch.distributed as dist

    kwargs: Dict[str, Any] = {}
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    init_method = "env://" if coordinator_address is None \
        else f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=init_method,
                            timeout=MULTIHOST_TIMEOUT, **kwargs)
    logger.info("Initialized distributed environment: process %d/%d",
                process_index(), process_count())


def shutdown_multihost() -> None:
    """Leave the process group; a no-op when none was initialised (JAX's
    guard)."""
    if _group_ready():
        import torch.distributed as dist

        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    if not _group_ready():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def process_count() -> int:
    """Processes in the run (1 without a process group)."""
    if not _group_ready():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_data_mesh(num_nodes: int, device: Any = "cpu") -> Mesh:
    """The ``data`` axis over the ranks of the process group, one
    position a rank: position r is rank r's device (each rank names its
    own; one collective collects them).  Node rows split contiguously by
    rank (:func:`process_node_rows`), JAX's ``P("data")`` over
    process-ordered devices."""
    import torch.distributed as dist

    world = process_count()
    process_node_rows(num_nodes, process_index(), world)   # raises if uneven
    names = [None] * world
    dist.all_gather_object(names, str(torch.device(device)))
    positions = np.empty(world, dtype=object)
    positions[:] = [torch.device(n) for n in names]
    return Mesh(positions, (DATA_AXIS,), process_index=process_index())


def process_node_rows(num_nodes: int, rank: int, world: int) -> range:
    """The node rows rank ``rank`` of ``world`` runs: ``num_nodes /
    world`` contiguous rows."""
    if num_nodes % world != 0:
        raise ValueError(f"{num_nodes} nodes do not split evenly over "
                         f"{world} processes: each rank takes the same "
                         "number of contiguous node rows")
    per = num_nodes // world
    return range(rank * per, (rank + 1) * per)


__all__ = ["AXIS_ORDER", "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS",
           "MULTIHOST_TIMEOUT", "Mesh", "SEQ_AXIS", "STAGE_AXIS",
           "bind_mode_mesh", "build_hybrid_mesh", "build_mesh",
           "initialize_multihost", "local_device_count", "node_axis_for",
           "process_count", "process_data_mesh", "process_index",
           "process_node_rows", "shutdown_multihost", "stage_devices"]
