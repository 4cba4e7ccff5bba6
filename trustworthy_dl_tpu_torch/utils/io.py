"""Atomic artifact writes: a sibling ``.tmp`` file, then ``os.replace``.

Counterpart of ``trustworthy_dl_tpu/utils/io.py``.  A persistent artifact
(the runner's results, a checkpoint's manifest and topology sidecar) is
never truncated in place: a crash mid-write leaves either the old complete
file or the new one, never a torn one.  ``os.replace`` is atomic on POSIX
when source and destination share a filesystem, which the sibling path
guarantees.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional


def atomic_write_text(path: Any, text: str, encoding: str = "utf-8"
                      ) -> str:
    """Write ``text`` to ``path`` atomically; returns the path."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding=encoding) as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def atomic_write_json(path: Any, payload: Any, *,
                      indent: Optional[int] = 2,
                      sort_keys: bool = False,
                      default: Any = None) -> str:
    """``json.dump`` with the same atomicity guarantee."""
    return atomic_write_text(
        os.fspath(path),
        json.dumps(payload, indent=indent, sort_keys=sort_keys,
                   default=default) + "\n",
    )


__all__ = ["atomic_write_json", "atomic_write_text"]
