"""Resource-locality rules: one-spelling contracts for shared device
resources.

Counterpart of ``trustworthy_dl_tpu/analysis/rules/locality.py``.  JAX
spells a partition spec ``PartitionSpec(...)``; the port spells it as a
plain tuple of mesh-axis names and None (``core.sharding.PartitionSpec``),
so the port's rules look for that: a tuple display holding one of
``core/mesh.py``'s axis constants (``DATA_AXIS``, ``MODEL_AXIS``, ...) and
nothing but axis constants and None.  A helpful second spelling elsewhere
(a local ``adapter_page_row`` clone, an ad-hoc spec tuple) runs — and
silently forks the layout the registry, the elastic migrations and the
engine's launch shapes key on.
"""

from __future__ import annotations

import ast
from typing import Iterable

from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule, match_any)


def _axis_name(node: ast.AST, config: LintConfig) -> bool:
    """A mesh-axis constant, bare or through a module (``mesh.DATA_AXIS``)."""
    name = node.id if isinstance(node, ast.Name) else (
        node.attr if isinstance(node, ast.Attribute) else None)
    return name in config.mesh_axis_constants


def is_spec_tuple(node: ast.AST, config: LintConfig) -> bool:
    """A tuple display spelling a partition spec: at least one mesh-axis
    constant, every element an axis constant, None or a tuple of axis
    constants."""
    if not isinstance(node, ast.Tuple) or not node.elts:
        return False
    axes = 0
    for elt in node.elts:
        if _axis_name(elt, config):
            axes += 1
        elif isinstance(elt, ast.Tuple) and elt.elts and all(
                _axis_name(e, config) for e in elt.elts):
            axes += 1
        elif not (isinstance(elt, ast.Constant) and elt.value is None):
            return False
    return axes > 0


def spec_tuples(tree: ast.AST, config: LintConfig) -> Iterable[ast.Tuple]:
    """The spec tuples under ``tree``, outermost only (the axis group of a
    nested ``((DATA_AXIS, MODEL_AXIS),)`` is part of its spec)."""
    specs = [n for n in ast.walk(tree) if is_spec_tuple(n, config)]
    inner = {id(e) for spec in specs for e in spec.elts}
    return [spec for spec in specs if id(spec) not in inner]


class AdapterLocalityRule(Rule):
    """The adapter page-table row (and JAX's adapter-pool spec helper) are
    spelled ONLY in serve/adapters.py (contracts.ADAPTER_HOME_MODULE): a
    definition of ``adapter_page_row``/``adapter_partition_specs``
    elsewhere, or a spec tuple built inside an adapter-handling function
    elsewhere, forks the layout the engine keys on.  Importing and CALLING
    the home spellings is the sanctioned path and is not flagged."""

    name = "adapter-locality"
    description = ("adapter page-table/partition-spec spellings live "
                   "only in serve/adapters.py")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return rel != config.adapter_home_module \
            and rel.startswith(config.package_name + "/")

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        reserved = set(config.adapter_locality_names)
        for node in module.walk():
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in reserved:
                yield self.finding(
                    module, node,
                    f"{node.name}() redefined outside "
                    f"{config.adapter_home_module} — the adapter page "
                    f"table/partition specs have one spelling")
                continue
            if "adapter" not in node.name.lower():
                continue
            for sub in spec_tuples(node, config):
                yield self.finding(
                    module, sub,
                    f"adapter-targeted partition spec built in "
                    f"{node.name}() — adapter sharding is spelled "
                    f"only in {config.adapter_home_module}")


class ShardingRegistryRule(Rule):
    """Every partition spec resolves through the logical-axis rule table in
    core/sharding.py (contracts.SHARDING_HOME_MODULE) — a spec tuple of
    mesh-axis names built anywhere else hard-codes an axis the registry
    can no longer retarget, and forks the layout the elastic migrations
    and checkpoint restores key on.  Calling the registry's helpers
    (``row_spec``, ``replicated_spec``, ``layout_specs``) is the sanctioned
    path and is not flagged."""

    name = "sharding-registry-only"
    description = ("partition specs (tuples of mesh-axis names) are built "
                   "only in core/sharding.py (the logical-axis registry)")

    def applies(self, rel: str, config: LintConfig) -> bool:
        if rel == config.sharding_home_module:
            return False
        if match_any(rel, config.sharding_spec_whitelist):
            return False
        return rel.startswith(config.package_name + "/")

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in spec_tuples(module.tree, config):
            yield self.finding(
                module, node,
                f"partition spec {ast.unparse(node)} built outside "
                f"{config.sharding_home_module} — shardings resolve "
                f"through the logical-axis registry (core.sharding "
                f"helpers), not ad-hoc specs")
