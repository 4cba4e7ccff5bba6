"""Per-request attribution ledger: which replica, slot, physical KV
blocks, weight tier and monitor verdict produced each served stream.

Counterpart of ``trustworthy_dl_tpu/obs/attribution.py``: the same names,
schemas and behaviour, in the port's own copy.

The trust claim on the serving side is only auditable if a finished
token stream can be traced back to the physical state that produced it.
At stream completion the engine appends ONE durable record per request:

.. code-block:: json

    {"request_id": 7, "status": "completed", "admitted": true,
     "slot": 2, "layout": "paged",
     "block_ids": [3, 9, 14], "prefix_block_ids": [3],
     "prefix_publishers": {"3": 1},
     "kv_dtype": "int8", "weight_dtype": "model",
     "kv_fallback_reason": null,
     "flagged": false, "monitor_z": 0.41,
     "tokens": 12, "token_hash": "a3f0c2...", "t": 1722700000.1}

appended as JSONL beside the trace (``attribution.jsonl``; the first
line is a header carrying the replica's ``run_metadata`` once, not per
record), mirrored as a compact ``attribution`` trace-bus event, and
retained in a bounded in-memory ring for :func:`verify_attribution` —
which cross-checks the recorded block ids against the
``BlockAllocator``'s lifecycle journal (every claimed block was really
allocated; references never went negative; an unreferenced block is on
the free list or quarantined, never limbo).

``token_hash`` is a sha256 over the emitted int32 token ids — cheap
evidence two replicas (or a replay) produced the same stream without
shipping the stream itself.
"""

from __future__ import annotations

import collections
import hashlib
import json
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def token_hash(tokens: Sequence[int]) -> str:
    """sha256 hex digest of the token-id stream (int32 little-endian)."""
    arr = np.asarray(list(tokens), np.int32)
    return hashlib.sha256(arr.tobytes()).hexdigest()


class AttributionLedger:
    """Durable JSONL sink + bounded in-memory ring of per-request
    attribution records.

    ``path=None`` is the in-memory mode (tests, in-process fleets); the
    ring (``keep``) bounds host memory under the million-user framing —
    the FILE is the durable record, the ring is the working set
    ``verify_attribution`` and the monitor drills read."""

    def __init__(self, path: Optional[str] = None, keep: int = 4096,
                 run_meta: Optional[Dict[str, Any]] = None):
        self.path = str(path) if path else None
        self._ring: collections.deque = collections.deque(maxlen=keep)
        self._lock = threading.Lock()
        self._file: Any = None
        self._closed = False
        self.total = 0
        if self.path is not None:
            if run_meta is None:
                from trustworthy_dl_tpu_torch.obs.meta import run_metadata

                run_meta = run_metadata()
            self._file = open(self.path, "a", buffering=1)
            self._file.write(json.dumps(
                {"header": True, "run_metadata": run_meta}
            ) + "\n")

    def append(self, record: Dict[str, Any]) -> Dict[str, Any]:
        record = dict(record)
        record.setdefault("t", time.time())
        with self._lock:
            self.total += 1
            self._ring.append(record)
            if self._file is not None and not self._closed:
                self._file.write(json.dumps(record) + "\n")
        return record

    def records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None


def read_ledger(path: str) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Load a ledger file back as ``(header, records)``."""
    header: Dict[str, Any] = {}
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if row.get("header"):
                header = row
            else:
                records.append(row)
    return header, records


def _journal_digest(allocator: Any) -> Tuple[Dict[int, int], Dict[int, int],
                                             Dict[int, int]]:
    """(allocs, refs, releases) per block from the allocator's lifecycle
    evidence — exact ``lifetime`` counters when present (bounded by pool
    size, never run length: the ring journal alone would false-positive
    "never allocated" once a long-pinned block's entry rotated out),
    the ring journal replay otherwise."""
    allocs: Dict[int, int] = {}
    refs: Dict[int, int] = {}
    releases: Dict[int, int] = {}
    lifetime = getattr(allocator, "lifetime", None)
    if lifetime is not None:
        for block, counts in lifetime.items():
            allocs[block] = counts.get("alloc", 0)
            refs[block] = counts.get("alloc", 0) + counts.get("incref", 0)
            releases[block] = counts.get("release", 0)
    else:
        for entry in getattr(allocator, "journal", ()):
            op, block = entry[0], entry[1]
            if op == "alloc":
                allocs[block] = allocs.get(block, 0) + 1
                refs[block] = refs.get(block, 0) + 1
            elif op == "incref":
                refs[block] = refs.get(block, 0) + 1
            elif op == "release":
                releases[block] = releases.get(block, 0) + 1
            # "unquarantine" re-enters the free pool without dropping a
            # reference — it does not change the accounting.
    return allocs, refs, releases


def _check_placement(rid: Any, placement: Dict[str, Any], allocator: Any,
                     digest: Tuple[Dict[int, int], Dict[int, int],
                                   Dict[int, int]],
                     problems: List[str], where: str = "") -> None:
    """The per-placement block checks (shared by single-engine records
    and each fleet attempt): unique non-trash in-pool block ids, every
    claimed block really allocated per the journal, releases never
    exceeding references, prefix ⊆ table.  Stripe placements only carry
    a slot id (no block pool); they verify as ``slot >= 0``."""
    if placement.get("layout") == "stripe":
        if placement.get("slot", -1) < 0:
            problems.append(f"request {rid}{where}: stripe record "
                            "without a slot id")
        return
    allocs, refs, releases = digest
    blocks = placement.get("block_ids") or []
    if len(set(blocks)) != len(blocks):
        problems.append(f"request {rid}{where}: duplicate block ids "
                        f"{blocks}")
    prefix = set(placement.get("prefix_block_ids") or [])
    if not prefix <= set(blocks):
        problems.append(f"request {rid}{where}: prefix blocks "
                        f"{sorted(prefix)} not a subset of its table "
                        f"{blocks}")
    num_blocks = getattr(allocator, "num_blocks", None)
    for b in blocks:
        if b == 0:
            problems.append(f"request {rid}{where}: claims the trash "
                            "block")
            continue
        if num_blocks is not None and not 1 <= b <= num_blocks:
            problems.append(f"request {rid}{where}: block {b} outside "
                            f"the pool [1, {num_blocks}]")
            continue
        if allocs.get(b, 0) < 1:
            problems.append(f"request {rid}{where}: block {b} was never "
                            "allocated per the journal")
        if releases.get(b, 0) > refs.get(b, 0):
            problems.append(f"request {rid}{where}: block {b} released "
                            f"{releases[b]}x with only "
                            f"{refs.get(b, 0)} references")


def verify_attribution(records: Iterable[Dict[str, Any]],
                       allocator: Any) -> Tuple[bool, List[str]]:
    """Cross-check ledger records against ``BlockAllocator`` lifecycle
    journals.  Returns ``(ok, problems)``.

    ``allocator`` is either one allocator (single engine) or a mapping
    of journal key → allocator (a fleet: one lifecycle journal per
    replica *generation* — a restarted replica's fresh pool must not be
    asked to vouch for blocks its predecessor handed out).  A fleet
    record carries the canonical stream once plus an ``attempts`` list;
    each attempt names its journal (``journal`` key, falling back to
    ``replica``), so ONE record's blocks can span two replicas'
    allocators and still reconcile.

    Checks per admitted record (or per attempt): block ids unique, in
    ``[1, num_blocks]`` and never the trash block; every claimed block
    has an ``alloc`` journal entry; per block, lifetime releases never
    exceed lifetime ``alloc + incref`` references; prefix blocks are a
    subset of the table.  Across records: at most ONE admitted record
    per request id (a double retire means two replicas both claimed the
    canonical stream — the dedup-at-retire invariant failed).  Per
    allocator: an unreferenced block is free or quarantined, never
    limbo.
    """
    import collections.abc as _abc

    problems: List[str] = []
    fleet = isinstance(allocator, _abc.Mapping) and not hasattr(
        allocator, "journal")
    digests: Dict[int, tuple] = {}

    def _resolve(key: Any, rid: Any, where: str):
        alloc = allocator.get(key) if fleet else allocator
        if alloc is None:
            problems.append(f"request {rid}{where}: no lifecycle journal "
                            f"for allocator key {key!r}")
            return None, None
        digest = digests.get(id(alloc))
        if digest is None:
            digest = _journal_digest(alloc)
            digests[id(alloc)] = digest
        return alloc, digest

    admitted_count: Dict[Any, int] = {}
    for rec in records:
        rid = rec.get("request_id")
        if not rec.get("admitted", True):
            continue  # never touched a slot or block (or lost a hedge)
        admitted_count[rid] = admitted_count.get(rid, 0) + 1
        attempts = rec.get("attempts")
        if attempts:
            for att in attempts:
                key = att.get("journal", att.get("replica"))
                where = f" attempt on replica {att.get('replica')}"
                alloc, digest = _resolve(key, rid, where)
                if alloc is None:
                    continue
                _check_placement(rid, att, alloc, digest, problems, where)
                src = att.get("migrated_from")
                if fleet and src and src.get("journal") is not None:
                    # A live-migrated attempt carries its SOURCE block
                    # table: those blocks were alloc'd on the source
                    # journal and released when the migration committed
                    # (or impounded, which the releases<=refs bound also
                    # admits) — reconcile them there, so a block the
                    # source never journalled, or released twice, still
                    # surfaces even though the attempt retired elsewhere.
                    swhere = (f" migration source on replica "
                              f"{src.get('replica')}")
                    salloc, sdigest = _resolve(src["journal"], rid, swhere)
                    if salloc is not None:
                        _check_placement(
                            rid,
                            {"layout": "paged",
                             "block_ids": src.get("block_ids") or []},
                            salloc, sdigest, problems, swhere)
        else:
            key = rec.get("journal", rec.get("replica"))
            alloc, digest = _resolve(key, rid, "")
            if alloc is None:
                continue
            _check_placement(rid, rec, alloc, digest, problems)
    for rid, n in admitted_count.items():
        if n > 1:
            problems.append(f"request {rid}: double retire — {n} admitted "
                            "records claim its canonical stream")

    # Allocator-side invariant: an unreferenced block must be free or
    # quarantined (never limbo).  Only checkable for real allocators.
    for alloc in (allocator.values() if fleet else (allocator,)):
        free = getattr(alloc, "_free", None)
        ref_now = getattr(alloc, "_ref", None)
        quarantined = getattr(alloc, "quarantined", set())
        num_blocks = getattr(alloc, "num_blocks", None)
        if free is None or ref_now is None or num_blocks is None:
            continue
        for b in range(1, num_blocks + 1):
            if b not in ref_now and b not in free and b not in quarantined:
                problems.append(f"block {b} is unreferenced but neither "
                                "free nor quarantined")
    return not problems, problems
