"""Import purity: host-only modules must not reach torch, and no module
may reach JAX.

Counterpart of ``trustworthy_dl_tpu/analysis/rules/purity.py``, with the
port's two contracts:

* The telemetry plane's readers (``cli obs`` diagnoses a run on a machine
  whose card is the broken thing), the control plane and the adversary,
  the data path's host tier, the kernel cache and the linter itself are
  host-only: importing torch — even transitively, even without using it —
  pulls the CUDA runtime into the process.  The rule builds the package's
  MODULE-LEVEL import graph (function-local lazy imports are the
  sanctioned escape hatch and are ignored) and walks it from each
  host-only module; any path that reaches ``torch`` is reported with the
  full chain.
* The port runs without JAX: no module imports ``jax``, ``jaxlib``,
  ``orbax`` or ``trustworthy_dl_tpu``, at module level or inside a
  function.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Tuple

from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule, match_any)

# (imported module name, lineno) edges, cached per Project.
_GRAPH_ATTR = "_tddl_import_graph"


def _resolve(name: str, project: Project, package_name: str
             ) -> Optional[str]:
    """Dotted module name -> repo-relative file, if it's ours."""
    if not (name == package_name or name.startswith(package_name + ".")):
        return None
    base = name.replace(".", "/")
    for candidate in (f"{base}.py", f"{base}/__init__.py"):
        if project.get(candidate) is not None:
            return candidate
        if os.path.exists(os.path.join(project.root, candidate)):
            return candidate
    return None


def _skip_if(test: ast.AST) -> bool:
    """Imports guarded by ``if TYPE_CHECKING:`` never execute."""
    names = {n.id for n in ast.walk(test) if isinstance(n, ast.Name)}
    attrs = {n.attr for n in ast.walk(test)
             if isinstance(n, ast.Attribute)}
    return "TYPE_CHECKING" in names | attrs


def _module_level_imports(module: ModuleInfo, package_name: str
                          ) -> List[Tuple[str, int]]:
    """(imported dotted name, lineno) for every import that executes at
    module import time — including inside top-level if/try blocks."""
    out: List[Tuple[str, int]] = []

    def visit(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Import):
                out.extend((alias.name, stmt.lineno)
                           for alias in stmt.names)
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level:
                    pkg_parts = module.rel[:-3].split("/")
                    if pkg_parts[-1] == "__init__":
                        pkg_parts = pkg_parts[:-1]
                    else:
                        pkg_parts = pkg_parts[:-1]
                    anchor = pkg_parts[:len(pkg_parts) - (stmt.level - 1)]
                    base = ".".join(anchor + ([stmt.module]
                                              if stmt.module else []))
                else:
                    base = stmt.module or ""
                if base:
                    out.append((base, stmt.lineno))
                    # ``from pkg import name`` may bind a SUBMODULE —
                    # resolving decides; a plain attribute resolves to
                    # nothing and is dropped.
                    for alias in stmt.names:
                        if alias.name != "*":
                            out.append((f"{base}.{alias.name}",
                                        stmt.lineno))
            elif isinstance(stmt, ast.If):
                if not _skip_if(stmt.test):
                    visit(stmt.body)
                visit(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                visit(stmt.body)
                for handler in stmt.handlers:
                    visit(handler.body)
                visit(stmt.orelse)
                visit(stmt.finalbody)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                visit(stmt.body)

    if module.tree is not None:
        visit(module.tree.body)
    return out


def _import_graph(project: Project, package_name: str
                  ) -> Dict[str, List[Tuple[str, int]]]:
    graph = getattr(project, _GRAPH_ATTR, None)
    if graph is None:
        graph = {rel: _module_level_imports(m, package_name)
                 for rel, m in project.modules.items()}
        setattr(project, _GRAPH_ATTR, graph)
    return graph


def _foreign(name: str, config: LintConfig) -> Optional[str]:
    """The foreign top-level package ``name`` belongs to, if any."""
    for root in config.foreign_modules:
        if name == root or name.startswith(root + "."):
            return root
    return None


class ImportPurityRule(Rule):
    """Host-only modules must not import torch transitively at module
    level (findings carry the offending chain), and no module of the
    package imports JAX or the JAX package anywhere."""

    name = "import-purity"
    description = ("host-only modules must not reach torch through "
                   "module-level imports; no module imports jax")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return rel.startswith(config.package_name + "/")

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in module.walk():
            names = []
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            for name in names:
                root = _foreign(name, config)
                if root is not None:
                    yield self.finding(
                        module, node,
                        f"imports {name!r}: the port runs without JAX "
                        f"and keeps its own copy of what it needs from "
                        f"{root}")
        if match_any(module.rel, config.host_only_modules):
            yield from self._host_only(module, project, config)

    def _host_only(self, module: ModuleInfo, project: Project,
                   config: LintConfig) -> Iterable[Finding]:
        graph = _import_graph(project, config.package_name)
        # BFS over package-internal edges from this module; the FIRST
        # hop's lineno anchors the finding (that import is the one the
        # author of this module can actually fix or defer).
        seen = {module.rel}
        queue: List[Tuple[str, Tuple[str, ...], int]] = []
        for name, lineno in graph.get(module.rel, ()):
            queue.append((name, (module.rel,), lineno))
        reported = set()
        while queue:
            name, chain, first_lineno = queue.pop(0)
            top = name.split(".", 1)[0]
            if top in config.device_runtime_modules:
                key = (chain[0], chain[1] if len(chain) > 1 else name)
                if key not in reported:
                    reported.add(key)
                    pretty = " -> ".join(chain[1:] + (top,)) or top
                    yield self.finding(
                        module, first_lineno,
                        f"host-only module reaches {top!r} at module "
                        f"level via {pretty} — defer the import into "
                        f"the function that needs it")
                continue
            target = _resolve(name, project, config.package_name)
            if target is None or target in seen:
                continue
            seen.add(target)
            edges = graph.get(target)
            if edges is None:
                # Reachable module outside the scanned path set (e.g. a
                # single-file lint run): parse it on demand and cache.
                info = project.get(target)
                if info is None:
                    try:
                        info = ModuleInfo(
                            project.root,
                            os.path.join(project.root, target))
                    except OSError:
                        continue
                edges = _module_level_imports(info, config.package_name)
                graph[target] = edges
            for nxt, _ in edges:
                queue.append((nxt, chain + (target,), first_lineno))
