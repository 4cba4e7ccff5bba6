"""The device mesh of a training run: a single-controller mesh.

Counterpart of ``trustworthy_dl_tpu/core/mesh.py`` for the ``data``,
``model`` (pipeline) and ``sequence`` modes.  The JAX package's mesh is
single-controller: one process holds every device, and a collective is an
op inside the compiled step.  The port keeps that shape without a process
group: a :class:`Mesh` holds axis names and an array of ``torch.device``s,
one per position, and reports ``.shape`` as a dict.  Under pipelining
each stage's block slice and its activations live on its position's
device, and JAX's ``ppermute`` to the next stage is
``tensor.to(next_device)``, a no-op when both stages share a device; ring
attention's K/V rotation is the same move (``parallel/sequence.py``).
On one card every position is that card (``cuda:0``); in the tests every
position is the CPU.

``build_mesh`` gives ``data`` a one-device node axis (the logical nodes
run one after another on it, JAX's degenerate mode on one device),
``model`` a ``(1, S)`` data x stage layout, JAX's layout off a TPU, and
``sequence`` JAX's ``(nodes, group)`` data x seq layout over the
positions given (one position: ``(1, 1)``).  The tensor, expert and
hybrid modes raise naming ROADMAP Slice 4b, as does multi-host set-up
(Slice 4c).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

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

#: The ROADMAP item each mode without a mesh here waits for.
_LATER = {"tensor": "Slice 4b", "expert": "Slice 4b", "hybrid": "Slice 4b"}


def node_axis_for(parallelism: str) -> str:
    """Mesh axis that plays the role of the reference's node index."""
    try:
        return _PARALLELISM_AXIS[parallelism]
    except KeyError:
        raise ValueError(
            f"no canonical node axis for parallelism={parallelism!r}")


def not_ported(parallelism: str) -> NotImplementedError:
    """The refusal of a mode the port cannot run yet, naming its item."""
    item = _LATER.get(parallelism, "Slice 4b")
    return NotImplementedError(
        f"parallelism={parallelism!r} is not ported yet (ROADMAP {item}: "
        "its collectives span several cards); the port trains 'data', "
        "'model' and 'sequence'")


class Mesh:
    """Axis names over an array of ``torch.device``s (one per
    position)."""

    def __init__(self, devices: Any, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = tuple(axis_names)

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


def build_mesh(num_nodes: int, parallelism: str = "data",
               mesh_shape: Optional[Dict[str, int]] = None,
               devices: Optional[Sequence[Any]] = None,
               dcn_mesh_shape: Optional[Dict[str, int]] = None,
               device: Any = "cpu") -> Mesh:
    """The mesh of a run.  ``data``: a one-position data axis on
    ``device`` (the logical nodes run in turn on it).  ``model``: a
    ``(1, S)`` data x stage mesh, stage s on ``devices[s % len(devices)]``
    (default ``device``).  ``sequence``: JAX's tensor/sequence arm over
    the positions ``devices`` (default one, ``device``; positions may
    repeat a device): with more nodes than positions the node axis takes
    the largest divisor of ``num_nodes`` that fits, then each node owns a
    group of ``len(devices) // nodes`` positions, a ``(nodes, group)``
    data x seq mesh.  Other modes raise naming their ROADMAP item;
    ``mesh_shape`` and ``dcn_mesh_shape`` are refused by name (JAX's
    hybrid layouts)."""
    if parallelism in _LATER:
        raise not_ported(parallelism)
    node_axis_for(parallelism)
    if mesh_shape or dcn_mesh_shape:
        raise NotImplementedError(
            "mesh_shape and dcn_mesh_shape are not ported yet (ROADMAP "
            "Slice 4b: the hybrid mesh)")
    if parallelism == "model":
        arr = np.empty((1, num_nodes), dtype=object)
        for s, dev in enumerate(_device_list(num_nodes, device, devices)):
            arr[0, s] = dev
        return Mesh(arr, (DATA_AXIS, STAGE_AXIS))
    if parallelism == "sequence":
        positions = [torch.device(d) for d in (devices or [device])]
        if not positions:
            raise ValueError("build_mesh: no devices")
        n_dev = len(positions)
        if num_nodes > n_dev:
            # JAX's degenerate mode: the node axis takes the largest
            # divisor of num_nodes that fits (the nodes run in turn).
            num_nodes = max(d for d in range(1, n_dev + 1)
                            if num_nodes % d == 0)
        group = n_dev // num_nodes
        arr = np.empty((num_nodes, group), dtype=object)
        for i, dev in enumerate(positions[:num_nodes * group]):
            arr[i // group, i % group] = dev
        return Mesh(arr, (DATA_AXIS, SEQ_AXIS))
    arr = np.empty((1,), dtype=object)
    arr[0] = _device_list(1, device, devices)[0]
    return Mesh(arr, (DATA_AXIS,))


def bind_mode_mesh(mesh: Mesh, parallelism: str) -> None:
    """Bind the global mesh of the modes whose forwards read one, as JAX
    does: the sequence mesh of ring and Ulysses attention.  The one
    binding ladder, shared by trainer construction and checkpoint
    topology adoption; a no-op for ``data`` and ``model``.  ``expert``
    would bind MoE's expert mesh and raises naming Slice 4b.  The import
    is lazy to keep core/ free of parallel/ dependencies."""
    if parallelism == "sequence":
        from trustworthy_dl_tpu_torch.parallel.sequence import \
            set_sequence_mesh

        set_sequence_mesh(mesh)
    elif parallelism == "expert":
        raise not_ported(parallelism)


def stage_devices(mesh: Mesh) -> list:
    """The device of every pipeline stage, in stage order."""
    return mesh.positions(STAGE_AXIS)


def local_device_count() -> int:
    """Cards this process sees (1 without CUDA: the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


__all__ = ["AXIS_ORDER", "DATA_AXIS", "EXPERT_AXIS", "MODEL_AXIS", "Mesh",
           "SEQ_AXIS", "STAGE_AXIS", "bind_mode_mesh", "build_mesh",
           "local_device_count", "node_axis_for", "not_ported",
           "stage_devices"]
