"""Lazy re-exports (PEP 562) for the package and its subpackages.

A re-exported name resolves to its module's attribute at first access, so
importing a package imports none of the modules it re-exports: ``import
trustworthy_dl_tpu_torch`` loads no torch, and the host-only modules
(``utils.compile_cache``, ``native``, ``analysis``, ...) stay torch-free
behind their packages' ``__init__``.
"""

from __future__ import annotations

import importlib
import sys
from typing import Any, Callable, Dict, List, Sequence, Tuple

ROOT = "trustworthy_dl_tpu_torch"


def lazy_exports(package: str, exports: Dict[str, Sequence[str]]
                 ) -> Tuple[List[str], Callable[[str], Any],
                            Callable[[], List[str]]]:
    """``exports`` maps a module, relative to the root package, to the
    names it serves; returns ``(__all__, __getattr__, __dir__)`` for
    ``package``."""
    where = {name: f"{ROOT}.{module}"
             for module, names in exports.items() for name in names}

    def __getattr__(name: str) -> Any:
        module = where.get(name)
        if module is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        return getattr(importlib.import_module(module), name)

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(where))

    return sorted(where), __getattr__, __dir__
