"""Committed baseline of grandfathered findings (JAX's format).

Format (``tddl_torch_lint_baseline.json`` at the repo root)::

    {"version": 1,
     "findings": [
       {"rule": "host-sync", "path": "trustworthy_dl_tpu_torch/...",
        "message": "...", "justification": "one line of WHY"}]}

Every entry MUST carry a non-empty ``justification`` — a baseline entry
without a reason is just a hidden violation, and the loader refuses it.
Entries match on (rule, path, message); stale entries (matching no
current finding) are reported by the engine so the file only shrinks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List

BASELINE_VERSION = 1


def load_baseline(path: str) -> List[Dict[str, str]]:
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: unsupported version "
            f"{payload.get('version')!r} (expected {BASELINE_VERSION})")
    entries = payload.get("findings", [])
    for entry in entries:
        missing = [k for k in ("rule", "path", "message") if not
                   entry.get(k)]
        if missing:
            raise ValueError(
                f"baseline {path}: entry {entry!r} missing {missing}")
        if not str(entry.get("justification", "")).strip():
            raise ValueError(
                f"baseline {path}: entry for {entry['rule']} at "
                f"{entry['path']} has no justification — grandfathering "
                "requires a reason")
    return entries


def write_baseline(findings: Iterable, path: str,
                   justification: str = "grandfathered at baseline "
                   "creation — burn down before extending") -> Dict:
    """Serialise current findings as a fresh baseline (atomic write)."""
    payload = {
        "version": BASELINE_VERSION,
        "findings": [
            dict(f.fingerprint(), justification=justification)
            for f in findings
        ],
    }
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return payload
