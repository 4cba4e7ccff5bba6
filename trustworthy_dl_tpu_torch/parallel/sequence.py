"""Sequence (context) parallelism: ring and Ulysses attention over the
``seq`` positions of the bound mesh.

Counterpart of ``trustworthy_dl_tpu/parallel/sequence.py``.  Two
strategies, as in JAX:

* **Ring attention** (:func:`ring_attention`): the sequence splits into
  one chunk per ``seq`` position; each position keeps its Q chunk and
  meets every K/V chunk in turn, merging the chunk results by their
  logsumexp, so the result is exact.  JAX runs one body per device under
  ``shard_map`` and rotates K/V with ``ppermute``.  The port's mesh is
  single-controller (``core/mesh.py``): a loop over the positions runs
  JAX's per-device body on each Q chunk, and at rotation ``i`` position
  ``stage`` reads the K/V chunk that position ``(stage - i) % ring``
  holds, moved with ``.to(position_device)`` (a no-op where positions
  share a device, as on one card).  The outputs concatenate along T.
  Each chunk attends through :func:`ops.flash_attention.flash_chunk`
  (kernels B2/B3) where the chunk shape is the kernel's (``ops.
  flash_attention.supports_flash``, the one predicate shared with the
  public wrapper: T a multiple of 64, D in 16/32/64/128; JAX's takes D up
  to 512, so shapes in between run the einsum body here; on a CUDA tensor
  the kernels also want bf16, which the trainer checks at construction):
  under a causal mask the diagonal chunk
  takes the causal kernel, chunks below it the non-causal one, and
  chunks above it are skipped, so a causal ring of R positions makes R
  causal and R (R - 1) / 2 non-causal chunk calls (R^2 non-causal when
  not causal).  Other shapes run JAX's einsum body (running max,
  normaliser and weighted sum over every rotation).
* **Ulysses** (:func:`ulysses_attention`): JAX reshards the inputs from
  sequence- to head-sharding (an all_to_all pair under GSPMD), runs full
  attention, and reshards back.  Here each position runs full attention
  over its group of heads on its device and the groups concatenate;
  where positions share a device the reshard pair is the identity (views
  and no-op moves).

With no mesh bound (:func:`use_sequence_mesh`, or ``core.mesh.
bind_mode_mesh`` in sequence mode), or T not a multiple of the ring size,
both fall back to full attention, as in JAX.  A mesh whose positions
lie on another kind of device than the inputs is refused, not followed:
moving a card's chunks to the CPU would run attention there unseen.
Both register with the
GPT-2 attention registry as ``"ring"`` and ``"ulysses"`` on import
(``models.gpt2.get_attention`` imports this module for those names).  A
trainer's nodes each run the ring over the positions at data index 0:
on one card every position is the same device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, List, Optional, Tuple

import torch

from trustworthy_dl_tpu_torch.core.mesh import SEQ_AXIS, Mesh
from trustworthy_dl_tpu_torch.models.gpt2 import full_attention, \
    register_attention
from trustworthy_dl_tpu_torch.ops import flash_attention as fa

_SEQ_MESH: Optional[Mesh] = None

NEG_INF = -1e30


def set_sequence_mesh(mesh: Optional[Mesh]) -> None:
    global _SEQ_MESH
    _SEQ_MESH = mesh


def get_sequence_mesh() -> Optional[Mesh]:
    if _SEQ_MESH is not None and SEQ_AXIS in _SEQ_MESH.axis_names:
        return _SEQ_MESH
    return None


def _positions(mesh: Mesh, x: torch.Tensor) -> list:
    """The ``seq`` positions' devices, refused where one is another kind
    of device than ``x``'s (the inputs would leave the card unseen)."""
    positions = mesh.positions(SEQ_AXIS)
    for dev in positions:
        if torch.device(dev).type != x.device.type:
            raise ValueError(
                f"sequence mesh position on {dev} for inputs on "
                f"{x.device}: build the mesh on the inputs' device")
    return positions


@contextlib.contextmanager
def use_sequence_mesh(mesh: Mesh) -> Iterator[None]:
    prev = _SEQ_MESH
    set_sequence_mesh(mesh)
    try:
        yield
    finally:
        set_sequence_mesh(prev)


# ---------------------------------------------------------------------------
# Ulysses: heads over the positions around full attention
# ---------------------------------------------------------------------------


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """[B, H, T, D] attention, each ``seq`` position computing full
    attention for its group of heads on its device (JAX's head-sharded
    core between the all_to_all pair)."""
    mesh = get_sequence_mesh()
    if mesh is None:
        return full_attention(q, k, v, causal)
    positions = _positions(mesh, q)
    outs = []
    for dev, qh, kh, vh in zip(positions,
                               *(torch.tensor_split(a, len(positions), dim=1)
                                 for a in (q, k, v))):
        if qh.shape[1] == 0:
            continue
        out = full_attention(qh.to(dev), kh.to(dev), vh.to(dev), causal)
        outs.append(out.to(q.device))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Ring attention: K/V chunks meet every position, merged by logsumexp
# ---------------------------------------------------------------------------


def _merge_chunk(lse_run: torch.Tensor, out_run: torch.Tensor,
                 lse_i: torch.Tensor, o_i: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine a normalized chunk result (o_i, lse_i) into the running
    (lse, out) accumulator: the cross-chunk half of online softmax.

    The "no contribution" sentinel is the finite NEG_INF (-1e30), not
    -inf (which would NaN the logaddexp/exp gradients), so the guards
    test against the sentinel explicitly rather than isfinite."""
    new_lse = torch.logaddexp(lse_run, lse_i)
    w_run = torch.where(lse_run > NEG_INF / 2, torch.exp(lse_run - new_lse),
                        0.0)
    w_i = torch.where(lse_i > NEG_INF / 2, torch.exp(lse_i - new_lse), 0.0)
    out = out_run * w_run[..., None] + o_i.float() * w_i[..., None]
    return new_lse, out


def _ring_flash(q: List[torch.Tensor], k: List[torch.Tensor],
                v: List[torch.Tensor], causal: bool, devices: list,
                shape: Tuple[int, int, int, int]) -> List[torch.Tensor]:
    """JAX's flash-chunk body at every position: q, k, v are the chunks
    merged to [B * H, Tl, D]; returns each position's [B, H, Tl, D]
    output in q's dtype.  The first chunk a position attends is its own
    (rotation 0), so the accumulator starts from it: JAX's first merge
    into the empty (NEG_INF, 0) accumulator gives exactly that chunk."""
    b, h, tl, d = shape
    ring = len(devices)
    outs = []
    for stage, dev in enumerate(devices):
        q_s = q[stage].to(dev)
        lse = out = None
        for i in range(ring):
            src = (stage - i) % ring
            if causal and src > stage:
                continue        # wholly in the future: skipped
            o_i, lse_i = fa.flash_chunk(q_s, k[src].to(dev), v[src].to(dev),
                                        causal and src == stage)
            o_i, lse_i = o_i.reshape(b, h, tl, d), lse_i.reshape(b, h, tl)
            if out is None:
                lse, out = lse_i, o_i.float()
            else:
                lse, out = _merge_chunk(lse, out, lse_i, o_i)
        outs.append(out.to(q_s.dtype))
    return outs


def _ring_einsum(q: List[torch.Tensor], k: List[torch.Tensor],
                 v: List[torch.Tensor], causal: bool, devices: list
                 ) -> List[torch.Tensor]:
    """JAX's einsum body at every position, over [B, H, Tl, D] chunks:
    running max, normaliser and weighted sum in f32, every rotation."""
    ring = len(devices)
    b, h, tl, d = q[0].shape
    scale = 1.0 / math.sqrt(d)
    outs = []
    for stage, dev in enumerate(devices):
        q_s = q[stage].to(dev)
        q_pos = stage * tl + torch.arange(tl, device=dev)
        m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, tl, d), dtype=torch.float32, device=dev)
        for i in range(ring):
            # After i rotations this position holds the chunk originating
            # at stage - i (mod ring).
            src = (stage - i) % ring
            k_cur, v_cur = k[src].to(dev), v[src].to(dev)
            scores = torch.einsum("bhqd,bhkd->bhqk", q_s, k_cur).float() \
                * scale
            if causal:
                k_pos = src * tl + torch.arange(tl, device=dev)
                mask = q_pos[:, None] >= k_pos[None, :]
                scores = torch.where(mask, scores, NEG_INF)
            else:
                mask = torch.ones((tl, tl), dtype=torch.bool, device=dev)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            # Masked entries contribute exactly zero probability mass.
            p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
            correction = torch.exp(m - m_new)
            l = l * correction + p.sum(dim=-1)
            acc = acc * correction[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, v_cur.float())
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.to(q_s.dtype))
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True) -> torch.Tensor:
    """[B, H, T, D] exact blockwise ring attention over the ``seq``
    positions of the bound mesh (module docstring)."""
    mesh = get_sequence_mesh()
    if mesh is None:
        return full_attention(q, k, v, causal)
    devices = _positions(mesh, q)
    ring = len(devices)
    b, h, t, d = q.shape
    if t % ring:
        return full_attention(q, k, v, causal)
    tl = t // ring
    chunks = [a.chunk(ring, dim=2) for a in (q, k, v)]
    if fa.supports_flash(tl, d):
        merged = [[c.reshape(b * h, tl, d) for c in cs] for cs in chunks]
        outs = _ring_flash(*merged, causal, devices, (b, h, tl, d))
    else:
        outs = _ring_einsum(*chunks, causal, devices)
    return torch.cat([o.to(q.device) for o in outs], dim=2)


register_attention("ulysses", ulysses_attention)
register_attention("ring", ring_attention)


__all__ = ["NEG_INF", "get_sequence_mesh", "ring_attention",
           "set_sequence_mesh", "ulysses_attention", "use_sequence_mesh"]
