"""Artifact-contract rules: the reason-string vocabulary (JAX's rule, as
it is: the spelling is plain Python).

Flight dumps and their paired incident reports correlate BY reason
string — ``flight_007_slo_breach.json`` ↔ ``incident_007_slo_breach
.json`` ↔ the trigger event the assembler searches the trace for.  A
typo'd reason ("slo_breech") still writes an artifact, still passes
every runtime check, and silently orphans the incident from its
trigger: the timeline renders empty and nobody notices until the
post-mortem that needed it.  So the vocabulary is registered once in
``analysis/contracts.py`` (``ARTIFACT_REASONS``) and every LITERAL
reason at a dump/assemble call site must come from it — exactly the
stance ``metric-label-vocab`` takes for label names.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule)

#: Callables whose FIRST argument is the reason: ``ObsSession.
#: dump_flight`` (and the bound ``dump=`` handle the watchers hold),
#: ``IncidentAssembler.assemble``, and the fleet's ``_forensic_incident``
#: wrapper that forwards to both.
_REASON_FIRST = frozenset({"dump_flight", "assemble",
                           "_forensic_incident"})


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class ArtifactReasonRule(Rule):
    """Literal reason strings at flight-dump / incident-assembly call
    sites must come from ``contracts.ARTIFACT_REASONS``.  Dynamic
    reasons (a forwarded ``reason`` variable) are the producer's
    responsibility and pass through unchecked."""

    name = "artifact-reason-vocab"
    description = ("flight-dump/incident reason literals must come "
                   "from the registered vocabulary")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return (rel.startswith(config.package_name + "/")
                or rel.startswith("tests/"))

    def _reason_args(self, node: ast.Call):
        """Candidate literal reasons this call carries, with the node
        to anchor the finding on."""
        func = node.func
        name = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        out = []
        if name in _REASON_FIRST or name == "dump":
            # Only the dump/assemble surfaces own the vocabulary; a
            # ``reason=`` kwarg on anything else (pytest marks, trace
            # emits, failover scheduling) is a different namespace.
            for kw in node.keywords:
                if kw.arg == "reason" \
                        and _const_str(kw.value) is not None:
                    out.append(kw.value)
        if name in _REASON_FIRST:
            if node.args and _const_str(node.args[0]) is not None:
                out.append(node.args[0])
        elif name == "dump":
            # ``FlightRecorder.dump(directory, reason)`` carries the
            # reason SECOND; the bound ``dump=`` handles the watchers
            # call carry it FIRST.  Either position being a string
            # literal marks it as a reason (json.dump/pickle.dump pass
            # objects and file handles there, never string literals).
            for arg in node.args[:2]:
                if _const_str(arg) is not None:
                    out.append(arg)
        return name, out

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in module.walk():
            if not isinstance(node, ast.Call):
                continue
            name, args = self._reason_args(node)
            for arg in args:
                reason = _const_str(arg)
                if reason not in config.artifact_reasons:
                    yield self.finding(
                        module, arg,
                        f"{name}() reason {reason!r} is outside the "
                        f"registered vocabulary (add it to contracts."
                        f"ARTIFACT_REASONS deliberately)")
