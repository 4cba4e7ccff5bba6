"""Obs-contract rules: typed emissions, metric naming, label vocabulary
(JAX's rules, as they are: the spelling is plain Python).

These replace a regex perimeter over the sources with AST-accurate
checks: a multi-line ``.emit(`` call, an
aliased registry handle, or an ``f"tddl_..."`` name all resolve the
same way the interpreter would, not the way a regex hopes they do.
"""

from __future__ import annotations

import ast
from typing import Iterable

from trustworthy_dl_tpu_torch.analysis import astutil
from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule)

_REGISTER_METHODS = frozenset({"counter", "gauge", "histogram"})


def _package_scope(rel: str, config: LintConfig) -> bool:
    """Package sources; the test tree deliberately registers invalid
    names/labels to exercise the registry's own validation."""
    return rel.startswith(config.package_name + "/")


class ObsEmitRule(Rule):
    """Every ``*.emit(...)`` call site passes an ``EventType.<NAME>``
    member — new instrumentation cannot bypass schema validation with a
    raw string or a typo'd member (the regex ancestor of this rule
    caught two real raw-string sites in checkpoint.py/injector.py)."""

    name = "obs-emit-type"
    description = ("emit() must pass an EventType member whose schema "
                   "exists in EVENT_SCHEMAS")

    def applies(self, rel: str, config: LintConfig) -> bool:
        # events.py is the bus itself (validates at runtime); the test
        # tree drives emit through EventType already and negative cases
        # go through validate_event, not emit.
        return rel != f"{config.package_name}/obs/events.py" and (
            _package_scope(rel, config) or rel.startswith("tests/"))

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        members = config.resolved_event_members()
        for node in module.walk():
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "emit"):
                continue
            if not node.args:
                yield self.finding(
                    module, node, "emit() without a positional "
                    "EventType argument")
                continue
            arg = node.args[0]
            name = astutil.dotted(arg)
            if name is None or not name.startswith("EventType."):
                got = name or ast.unparse(arg)
                yield self.finding(
                    module, arg,
                    f"emit() argument is not an EventType member: "
                    f"{got!r}")
            elif name.split(".", 1)[1] not in members:
                yield self.finding(
                    module, arg, f"emit() passes unknown member {name}")


class MetricPrefixRule(Rule):
    """Every literal metric name registered on a registry — directly
    via ``counter``/``gauge``/``histogram`` or through serve/engine.py's
    ``_metric`` degrade-on-conflict wrapper — carries the ``tddl_``
    prefix the Prometheus surface promises."""

    name = "metric-prefix"
    description = "registered metric literals must start with tddl_"

    def applies(self, rel: str, config: LintConfig) -> bool:
        return _package_scope(rel, config)

    def _name_arg(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) \
                and func.attr in _REGISTER_METHODS:
            return node.args[0] if node.args else None
        if astutil.dotted(func) == "_metric":
            # _metric(register, name, help, ...): name is the SECOND
            # positional.
            return node.args[1] if len(node.args) > 1 else None
        return None

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            arg = self._name_arg(node)
            if arg is None:
                continue
            head = astutil.literal_head(arg)
            if head is None:
                continue  # fully dynamic name: runtime validation owns it
            if not head.startswith(config.metric_prefix):
                yield self.finding(
                    module, arg,
                    f"metric name {head!r} lacks the "
                    f"{config.metric_prefix!r} prefix")


class MetricLabelRule(Rule):
    """Label names on registered metrics come from the known dashboard
    vocabulary (contracts.KNOWN_METRIC_LABELS) — a label outside it is
    a typo or an undeclared new dimension.  Dynamic label expressions
    (e.g. ``self._rlabel_names``) contribute their literal parts."""

    name = "metric-label-vocab"
    description = ("metric label names must come from the known "
                   "vocabulary")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return _package_scope(rel, config)

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            is_register = (isinstance(func, ast.Attribute)
                           and func.attr in _REGISTER_METHODS) \
                or astutil.dotted(func) == "_metric"
            if not is_register:
                continue
            for kw in node.keywords:
                if kw.arg != "labels":
                    continue
                for sub in ast.walk(kw.value):
                    label = astutil.const_str(sub)
                    if label is not None and \
                            label not in config.known_metric_labels:
                        yield self.finding(
                            module, sub,
                            f"label {label!r} is outside the known "
                            f"vocabulary (add it to contracts."
                            f"KNOWN_METRIC_LABELS deliberately)")
