"""Live KV migration: move an in-flight request between engines as a block
copy, not a recompute.

Counterpart of ``trustworthy_dl_tpu/serve/migrate.py``.  A two-phase
hand-off of the request's physical state:

1. **export**: the source engine snapshots the decode-phase request (block
   table, committed length, emitted stream, trust signals, seed, timing).
   Read-only: the source keeps serving.  Mid-prefill requests refuse.
2. **claim**: the destination reserves a row, fresh blocks and the
   adapter page through its normal allocators (prefix-evict retry, adapter
   acquire, full unwind on any shortage).  A refusal returns None and
   leaves both engines as they were.
3. **copy**: the K/V blocks, and on the int8 tier their scales, are
   gathered from the source pool along the block axis and scattered into
   the claimed blocks of the destination pool (a library index op, in
   place, as JAX's is a jnp op).  Id vectors are padded to the
   blocks-per-sequence width with ``TRASH_BLOCK``, whose content is
   garbage by contract.
4. **commit**: the destination registers the continuation under a fresh
   local id (the next draw index is ``len(emitted)``, so the seed stream
   travels by construction), the caller's ``on_commit`` runs, and only
   then does the source release it: ``cancel(status="migrated")``, which
   impounds the source blocks instead of freeing them under
   ``quarantine_src``.

Streams equal the unmigrated stream: nothing numeric is recomputed.
:func:`can_migrate` is structural (paged pools on both ends with equal
geometry, dtype and tier, the export/adopt surface present); anything else,
stripe pools and fakes included, keeps the cancel-and-recompute path.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from trustworthy_dl_tpu_torch.serve.kv_slots import TRASH_BLOCK, PagedKV


def can_migrate(src_engine: Any, dst_engine: Any) -> bool:
    """True when a live block copy between the two engines is possible:
    both ends expose the export/adopt surface, both schedulers are paged,
    and the pools share geometry, dtype and tier (a copy between unequal
    pools would corrupt silently, between int8 and model-dtype tiers it
    would dequantize silently)."""
    if src_engine is dst_engine:
        return False
    if not (hasattr(src_engine, "export_request")
            and hasattr(dst_engine, "adopt_request")):
        return False
    ss = getattr(src_engine, "scheduler", None)
    ds = getattr(dst_engine, "scheduler", None)
    if getattr(ss, "export_migration", None) is None:
        return False
    if getattr(ds, "claim_migration", None) is None:
        return False
    skv = getattr(ss, "kv", None)
    dkv = getattr(ds, "kv", None)
    if not (isinstance(skv, PagedKV) and isinstance(dkv, PagedKV)):
        return False
    if skv.k.shape != dkv.k.shape or skv.k.dtype != dkv.k.dtype:
        return False
    if skv.quantized != dkv.quantized:
        return False
    if getattr(ss, "nbps", None) != getattr(ds, "nbps", None):
        return False
    return True


def _copy_pools(src_sched: Any, dst_sched: Any, src_ids: list,
                dst_ids: list) -> None:
    """Copy the named blocks, values and scales, from the source pool into
    the destination pool, in place."""
    width = int(dst_sched.nbps)
    ids = np.full((2, width), TRASH_BLOCK, np.int64)
    ids[0, :len(src_ids)] = src_ids
    ids[1, :len(dst_ids)] = dst_ids
    skv, dkv = src_sched.kv, dst_sched.kv
    si, di = torch.from_numpy(ids).to(dkv.k.device)
    pairs = [(dkv.k, skv.k), (dkv.v, skv.v)]
    if dkv.quantized:
        pairs += [(dkv.k_scale, skv.k_scale), (dkv.v_scale, skv.v_scale)]
    for dst, src in pairs:
        dst[:, di] = src[:, si]


def migrate_request(src_engine: Any, dst_engine: Any, local_id: int, *,
                    quarantine_src: bool = False,
                    on_token: Optional[Callable[[int, int], None]] = None,
                    src_journal: Optional[str] = None,
                    on_commit: Optional[Callable[[int], None]] = None,
                    on_refuse: Optional[Callable[[str], None]] = None,
                    ) -> Optional[Dict[str, Any]]:
    """Two-phase live migration of request ``local_id``.

    Returns ``{"local_id": <its id on the destination>, "blocks": <blocks
    copied>}``, or None with the source untouched when the request is not
    migratable (unknown, still prefilling, no token yet) or the destination
    refuses the claim.  On success the source releases the request through
    ``cancel(status="migrated", quarantine=quarantine_src)`` after the
    destination committed and after ``on_commit(new_id)`` ran, so no token
    is streamed by neither or both.  ``src_journal`` (a fleet's journal
    key) rides the destination's ``migrated_from`` record for
    ``verify_attribution``; ``on_refuse`` gets the refusal class
    (``"src_not_migratable"`` or ``"claim_refused"``) before a None."""
    snap = src_engine.export_request(local_id)
    if snap is None:
        if on_refuse is not None:
            on_refuse("src_not_migratable")
        return None
    task = snap["task"]
    src_ids = list(snap["block_ids"])
    claim = dst_engine.scheduler.claim_migration(len(src_ids), task.adapter)
    if claim is None:
        if on_refuse is not None:
            on_refuse("claim_refused")
        return None
    _copy_pools(src_engine.scheduler, dst_engine.scheduler, src_ids,
                claim["block_ids"])
    migrated_from = {"block_ids": src_ids, "replica": snap.get("replica")}
    if src_journal is not None:
        migrated_from["journal"] = src_journal
    new_local = dst_engine.adopt_request(snap, claim, on_token=on_token,
                                         migrated_from=migrated_from)
    if on_commit is not None:
        on_commit(new_local)
    src_engine.cancel(local_id, status="migrated", quarantine=quarantine_src)
    return {"local_id": new_local, "blocks": len(src_ids)}


__all__ = ["can_migrate", "migrate_request"]
