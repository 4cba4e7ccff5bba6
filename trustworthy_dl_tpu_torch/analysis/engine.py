"""Rule engine: parse once, visit per rule, report ``file:line``
findings with inline suppressions and a committed baseline.

Counterpart of ``trustworthy_dl_tpu/analysis/engine.py``, mechanics for
mechanics.  The engine is deliberately boring infrastructure — the
interesting content lives in the rule modules and :mod:`~.contracts`.
Contracts:

* **Host-only.**  Parsing is :mod:`ast`; nothing here imports torch or
  jax.
* **One parse per file.**  Every rule sees the same
  :class:`ModuleInfo`; a file that fails to parse yields a single
  ``parse-error`` finding instead of crashing the run.
* **Suppressions are line-anchored.**  ``# tddl-lint: disable=RULE``
  on the finding's line (or the pure-comment line directly above it)
  silences that rule there; ``# tddl-lint: disable-file=RULE`` anywhere
  silences the rule for the whole file.  Suppressing a rule that did
  not fire is harmless (the comment documents intent).
* **Baseline is for grandfathering.**  Findings matching a committed
  baseline entry (rule + path + message) are filtered out and counted
  separately; stale entries (matched nothing) are surfaced so the
  baseline shrinks monotonically.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from trustworthy_dl_tpu_torch.analysis import contracts

_SUPPRESS_RE = re.compile(
    r"#\s*tddl-lint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<rules>[\w*-]+(?:\s*,\s*[\w*-]+)*)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source location."""

    rule: str
    path: str          # repo-relative posix path
    line: int
    message: str

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def fingerprint(self) -> Dict[str, str]:
        """The baseline identity: line numbers drift under unrelated
        edits, so grandfathering matches on rule + path + message."""
        return {"rule": self.rule, "path": self.path,
                "message": self.message}

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


@dataclasses.dataclass
class LintConfig:
    """Contract tables the rules consult — defaults from
    :mod:`~.contracts`, overridable so fixture trees can exercise
    module-scoped rules without mimicking the real layout."""

    deterministic_modules: Sequence[str] = contracts.DETERMINISTIC_MODULES
    host_only_modules: Sequence[str] = contracts.HOST_ONLY_MODULES
    device_runtime_modules: frozenset = contracts.DEVICE_RUNTIME_MODULES
    foreign_modules: frozenset = contracts.FOREIGN_MODULES
    hot_loop_modules: Sequence[str] = contracts.HOT_LOOP_MODULES
    host_sync_scopes: Dict[str, Sequence[str]] = dataclasses.field(
        default_factory=lambda: dict(contracts.HOST_SYNC_SCOPES))
    device_producers: frozenset = contracts.DEVICE_PRODUCERS
    artifact_modules: Sequence[str] = contracts.ARTIFACT_MODULES
    stamped_artifact_modules: Sequence[str] = \
        contracts.STAMPED_ARTIFACT_MODULES
    recovery_modules: Sequence[str] = contracts.RECOVERY_MODULES
    predict_function_patterns: Sequence[str] = \
        contracts.PREDICT_FUNCTION_PATTERNS
    known_metric_labels: frozenset = contracts.KNOWN_METRIC_LABELS
    metric_prefix: str = contracts.METRIC_PREFIX
    artifact_reasons: frozenset = contracts.ARTIFACT_REASONS
    adapter_home_module: str = contracts.ADAPTER_HOME_MODULE
    adapter_locality_names: Sequence[str] = contracts.ADAPTER_LOCALITY_NAMES
    sharding_home_module: str = contracts.SHARDING_HOME_MODULE
    sharding_spec_whitelist: Sequence[str] = contracts.SHARDING_SPEC_WHITELIST
    mesh_axis_constants: frozenset = contracts.MESH_AXIS_CONSTANTS
    package_name: str = "trustworthy_dl_tpu_torch"
    #: EventType member names; ``None`` = resolve from the real enum.
    event_members: Optional[frozenset] = None

    def resolved_event_members(self) -> frozenset:
        if self.event_members is None:
            return contracts.event_type_members()
        return self.event_members


def match_any(rel: str, patterns: Iterable[str]) -> bool:
    return any(fnmatch.fnmatch(rel, p) for p in patterns)


class ModuleInfo:
    """One parsed source file: AST (or parse error) + suppressions."""

    def __init__(self, root: str, path: str):
        self.path = path
        self.rel = os.path.relpath(path, root).replace(os.sep, "/")
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.lines = self.source.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.source, filename=self.rel)
        except SyntaxError as exc:
            self.parse_error = f"line {exc.lineno}: {exc.msg}"
        self._file_disables: set = set()
        self._line_disables: Dict[int, set] = {}
        for lineno, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if not m:
                continue
            names = {r.strip() for r in m.group("rules").split(",")}
            if m.group("scope"):
                self._file_disables |= names
            else:
                self._line_disables.setdefault(lineno, set()).update(names)

    def suppressed(self, rule: str, line: int) -> bool:
        def hit(names: set) -> bool:
            return rule in names or "*" in names \
                or any(fnmatch.fnmatch(rule, n) for n in names)

        if hit(self._file_disables):
            return True
        if hit(self._line_disables.get(line, set())):
            return True
        # The contiguous pure-comment block directly above the finding
        # counts too: long call expressions anchor on their first line,
        # and the author writes the justification (possibly spanning
        # several comment lines) immediately above the statement.
        prev = line - 1
        while prev >= 1 and self.lines[prev - 1].lstrip().startswith("#"):
            if hit(self._line_disables.get(prev, set())):
                return True
            prev -= 1
        return False

    # -- AST conveniences ---------------------------------------------------

    def walk(self):
        return ast.walk(self.tree) if self.tree is not None else ()

    def functions(self):
        """Every (possibly nested) function/method definition."""
        for node in self.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


class Project:
    """All modules of one lint run, keyed by repo-relative path — rules
    needing whole-program context (the import-purity BFS) read this."""

    def __init__(self, root: str, modules: Sequence[ModuleInfo]):
        self.root = root
        self.modules: Dict[str, ModuleInfo] = {m.rel: m for m in modules}

    def get(self, rel: str) -> Optional[ModuleInfo]:
        return self.modules.get(rel)


class Rule:
    """Base class: subclass, set ``name``/``description``, implement
    ``check``.  ``applies`` gates which files the rule sees; the engine
    handles suppressions and the baseline."""

    name: str = ""
    description: str = ""

    def applies(self, rel: str, config: LintConfig) -> bool:
        return True

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, module: ModuleInfo, node: Any, message: str
                ) -> Finding:
        line = getattr(node, "lineno", 0) if not isinstance(node, int) \
            else node
        return Finding(rule=self.name, path=module.rel, line=line,
                       message=message)


@dataclasses.dataclass
class LintResult:
    findings: List[Finding]
    files_scanned: int
    baselined: int = 0
    stale_baseline: List[Dict[str, str]] = dataclasses.field(
        default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "checkpoints",
              "build", "dist"}


def default_scan_paths(root: str, package_name: str) -> List[str]:
    """The standing perimeter: the port's package tree."""
    return [os.path.join(root, package_name)]


def collect_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            if path.endswith(".py"):
                out.append(os.path.abspath(path))
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS
                                 and not d.startswith("."))
            for name in sorted(filenames):
                if name.endswith(".py"):
                    out.append(os.path.abspath(
                        os.path.join(dirpath, name)))
    return out


class LintEngine:
    def __init__(self, rules: Sequence[Rule],
                 config: Optional[LintConfig] = None):
        self.rules = list(rules)
        self.config = config or LintConfig()
        names = [r.name for r in self.rules]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes or "" in names:
            raise ValueError(f"rules need unique non-empty names: {names}")

    def run(self, root: str, paths: Optional[Sequence[str]] = None,
            baseline: Optional[Sequence[Dict[str, str]]] = None,
            rule_names: Optional[Sequence[str]] = None) -> LintResult:
        root = os.path.abspath(root)
        if paths is None:
            paths = default_scan_paths(root, self.config.package_name)
        files = collect_files(paths)
        modules = [ModuleInfo(root, f) for f in files]
        project = Project(root, modules)

        active = self.rules
        if rule_names is not None:
            known = {r.name for r in self.rules}
            unknown = sorted(set(rule_names) - known)
            if unknown:
                raise ValueError(f"unknown rule(s): {unknown}; "
                                 f"known: {sorted(known)}")
            active = [r for r in self.rules if r.name in rule_names]

        findings: List[Finding] = []
        for module in modules:
            if module.parse_error is not None:
                findings.append(Finding(
                    rule="parse-error", path=module.rel, line=0,
                    message=f"file does not parse: {module.parse_error}"))
                continue
            for rule in active:
                if not rule.applies(module.rel, self.config):
                    continue
                for f in rule.check(module, project, self.config):
                    if not module.suppressed(f.rule, f.line):
                        findings.append(f)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))

        baselined = 0
        stale: List[Dict[str, str]] = []
        if baseline:
            used = [False] * len(baseline)
            keyed = {}
            for i, entry in enumerate(baseline):
                key = (entry.get("rule"), entry.get("path"),
                       entry.get("message"))
                keyed.setdefault(key, []).append(i)
            kept: List[Finding] = []
            for f in findings:
                idxs = keyed.get(
                    (f.rule, f.path, f.message))
                if idxs:
                    for i in idxs:
                        used[i] = True
                    baselined += 1
                else:
                    kept.append(f)
            findings = kept
            stale = [dict(entry) for entry, u in zip(baseline, used)
                     if not u]
        return LintResult(findings=findings, files_scanned=len(files),
                          baselined=baselined, stale_baseline=stale)


def repo_root() -> str:
    """The repo checkout this installed package lives in (parent of the
    package directory)."""
    package_dir = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    return os.path.dirname(package_dir)


def run_lint(root: Optional[str] = None,
             paths: Optional[Sequence[str]] = None,
             rule_names: Optional[Sequence[str]] = None,
             baseline_path: Optional[str] = None,
             use_baseline: bool = True,
             config: Optional[LintConfig] = None) -> LintResult:
    """One-call API: default rules over the default perimeter with the
    committed baseline — what the CLI and the tier-1 test share."""
    from trustworthy_dl_tpu_torch.analysis.baseline import load_baseline
    from trustworthy_dl_tpu_torch.analysis.rules import all_rules

    root = os.path.abspath(root or repo_root())
    entries: Optional[List[Dict[str, str]]] = None
    if use_baseline:
        if baseline_path is None:
            baseline_path = os.path.join(root, contracts.DEFAULT_BASELINE)
        if os.path.exists(baseline_path):
            entries = load_baseline(baseline_path)
    engine = LintEngine(all_rules(), config=config)
    return engine.run(root, paths=paths, baseline=entries,
                      rule_names=rule_names)
