"""Hygiene rules: mutable defaults, bare excepts in recovery paths,
unstamped artifacts, non-atomic artifact writes (JAX's rules, as they
are: the spelling is plain Python).

Each is a bug class the JAX package shipped and fixed: a shared ``{}``
default (``StepMetrics.model_aux``), a topology sidecar that a crash
could truncate until it went tmp+``os.replace``, experiment numbers
published without the platform that produced them.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from trustworthy_dl_tpu_torch.analysis import astutil
from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule, match_any)


def _is_dataclass_decorated(cls: ast.ClassDef) -> bool:
    for dec in cls.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = astutil.dotted(target) or ""
        if name.rsplit(".", 1)[-1] == "dataclass":
            return True
    return False


class MutableDefaultRule(Rule):
    """No mutable default arguments and no mutable dataclass-field
    defaults: the default is created ONCE and shared by every call /
    instance (the ``model_aux={}`` bug)."""

    name = "mutable-default"
    description = ("function and dataclass defaults must not be "
                   "mutable containers")

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for func in module.functions():
            args = func.args
            for default in list(args.defaults) + \
                    [d for d in args.kw_defaults if d is not None]:
                if astutil.is_mutable_default(default):
                    yield self.finding(
                        module, default,
                        f"{func.name}() has a mutable default "
                        f"({ast.unparse(default)}) shared across calls "
                        f"— use None and normalise inside")
        for node in module.walk():
            if not (isinstance(node, ast.ClassDef)
                    and _is_dataclass_decorated(node)):
                continue
            for stmt in node.body:
                value: Optional[ast.AST] = None
                if isinstance(stmt, ast.AnnAssign):
                    value = stmt.value
                elif isinstance(stmt, ast.Assign):
                    value = stmt.value
                if value is None:
                    continue
                if isinstance(value, ast.Call) and (
                        astutil.dotted(value.func) or ""
                ).rsplit(".", 1)[-1] == "field":
                    for kw in value.keywords:
                        if kw.arg == "default" \
                                and astutil.is_mutable_default(kw.value):
                            yield self.finding(
                                module, kw.value,
                                f"dataclass {node.name} field default "
                                f"is mutable — use default_factory")
                elif astutil.is_mutable_default(value):
                    yield self.finding(
                        module, value,
                        f"dataclass {node.name} has a mutable class "
                        f"default ({ast.unparse(value)}) — use "
                        f"field(default_factory=...)")


class BareExceptRule(Rule):
    """No bare ``except:`` in supervisor/fleet/chaos/checkpoint
    recovery paths — it swallows KeyboardInterrupt/SystemExit and can
    wedge the very ladder that exists to recover."""

    name = "bare-except"
    description = "recovery paths must not use bare except:"

    def applies(self, rel: str, config: LintConfig) -> bool:
        return match_any(rel, config.recovery_modules)

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in module.walk():
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield self.finding(
                    module, node,
                    "bare except: catches KeyboardInterrupt/SystemExit "
                    "— name the exception class (Exception at the "
                    "broadest)")


class ArtifactMetadataRule(Rule):
    """Every experiments module that ``json.dump``s an artifact
    must reference the shared ``run_metadata`` helper (numbers without
    the platform that produced them cannot be compared)."""

    name = "artifact-metadata"
    description = ("json.dump artifact writers must stamp run_metadata")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return match_any(rel, config.stamped_artifact_modules)

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        stamped = any(
            (isinstance(n, ast.Name) and n.id == "run_metadata")
            or (isinstance(n, ast.Attribute) and n.attr == "run_metadata")
            for n in module.walk())
        if stamped:
            return
        for node in module.walk():
            if isinstance(node, ast.Call) and astutil.dotted(node.func) \
                    in ("json.dump", "atomic_write_json"):
                yield self.finding(
                    module, node,
                    "JSON artifact without a run_metadata stamp "
                    "anywhere in the module (use trustworthy_dl_tpu_torch."
                    "obs.meta.run_metadata)")
                return


class AtomicWriteRule(Rule):
    """Persistent artifacts must be written tmp-then-``os.replace`` (or
    via ``utils.io.atomic_write_*``): a direct ``open(path, "w")``
    truncates the old artifact before the new one is durable, so a
    crash mid-write destroys BOTH (the topology-sidecar class)."""

    name = "atomic-write"
    description = ("artifact writes need tmp + os.replace (or the "
                   "atomic_write_* helpers)")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return match_any(rel, config.artifact_modules)

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node, parents in astutil.walk_with_parents(module.tree):
            if not isinstance(node, ast.Call):
                continue
            mode: Optional[str] = None
            target_desc = ""
            name = astutil.dotted(node.func)
            if name == "open" and len(node.args) >= 2:
                mode = astutil.const_str(node.args[1])
                target_desc = ast.unparse(node.args[0])
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("write_text", "write_bytes"):
                mode = "w"
                target_desc = ast.unparse(node.func.value)
            if mode is None or "w" not in mode:
                continue
            scope = astutil.enclosing_function(parents) or module.tree
            replaces = any(
                isinstance(n, ast.Call)
                and astutil.dotted(n.func) in ("os.replace", "os.rename")
                for n in ast.walk(scope))
            if not replaces:
                yield self.finding(
                    module, node,
                    f"write to {target_desc} truncates in place — "
                    f"write a tmp file and os.replace it (see "
                    f"utils.io.atomic_write_json)")
