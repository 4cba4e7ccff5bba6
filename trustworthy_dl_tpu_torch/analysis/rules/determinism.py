"""Determinism rules for the tick-deterministic / prediction modules
(JAX's rules, as they are: the spelling is plain Python).

The drill architecture (``FaultPlan.predict*``, ``predict_attacker_
trajectory``, ``autoscale_pressure``) pins EXACT counts against seeded
runs — a wall clock, an unseeded RNG, or a hash-order-dependent set
iteration in those modules turns a pinned drill into a flake that only
fires in CI at 3am.
"""

from __future__ import annotations

import ast
from typing import Iterable

from trustworthy_dl_tpu_torch.analysis import astutil
from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule, match_any)

#: Wall-clock / ambient-state calls that leak real time into decisions.
_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "date.today", "datetime.date.today",
})

#: np.random attrs that are NOT the seeded-generator constructors.
_SEEDED_FACTORIES = frozenset({"default_rng", "Generator", "PCG64",
                               "SeedSequence"})


class TickDeterminismRule(Rule):
    """No wall clocks, unseeded RNGs, or set iteration in the modules
    whose decisions drills replay from (seed, tick) alone."""

    name = "tick-determinism"
    description = ("deterministic modules must not read clocks, "
                   "unseeded RNGs, or iterate sets")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return match_any(rel, config.deterministic_modules)

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node in module.walk():
            if isinstance(node, ast.Call):
                yield from self._check_call(module, node)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                yield from self._check_iter(module, node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.DictComp, ast.GeneratorExp)):
                for gen in node.generators:
                    yield from self._check_iter(module, gen.iter)

    def _check_call(self, module: ModuleInfo, node: ast.Call
                    ) -> Iterable[Finding]:
        name = astutil.dotted(node.func)
        if name is None:
            return
        if name in _CLOCK_CALLS:
            yield self.finding(
                module, node,
                f"{name}() reads the wall clock in a tick-deterministic "
                f"module — decisions must be functions of (seed, tick)")
        elif name == "random" or name.startswith("random."):
            yield self.finding(
                module, node,
                f"{name}() uses the process-global RNG — use a seeded "
                f"np.random.default_rng(seed)")
        elif name.startswith("np.random.") or \
                name.startswith("numpy.random."):
            tail = name.rsplit(".", 1)[-1]
            if tail not in _SEEDED_FACTORIES:
                yield self.finding(
                    module, node,
                    f"{name}() draws from the global numpy RNG — use a "
                    f"seeded default_rng(seed)")
            elif tail == "default_rng" and not node.args:
                yield self.finding(
                    module, node,
                    "default_rng() without a seed is entropy-seeded — "
                    "pass the plan/config seed")

    def _check_iter(self, module: ModuleInfo, it: ast.AST
                    ) -> Iterable[Finding]:
        target = it
        if isinstance(target, ast.Call) \
                and astutil.dotted(target.func) in ("set", "frozenset"):
            pass
        elif isinstance(target, (ast.Set, ast.SetComp)):
            pass
        else:
            return
        yield self.finding(
            module, it,
            "iterating a set is hash-order dependent (string hashing is "
            "per-process randomised) — sort it first")


class PredictPurityRule(Rule):
    """The pure prediction functions drills pin against
    (``predict_*``, ``autoscale_pressure``, ``diurnal_rate``,
    ``predicted_replicas``) must compute from their arguments alone: no
    ``global``/``nonlocal`` declarations and no reads of module-level
    MUTABLE bindings (lists/dicts/sets/caches), which would make the
    pinned counts silently dependent on call history."""

    name = "predict-purity"
    description = ("predict_*/autoscale_pressure-style pure functions "
                   "must not touch module-global mutable state")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return rel.startswith(config.package_name + "/")

    def _mutable_globals(self, module: ModuleInfo) -> set:
        out: set = set()
        for stmt in module.tree.body:
            targets = []
            value = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is not None and astutil.is_mutable_default(value):
                for t in targets:
                    out.update(astutil.assigned_names(t))
        return out

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        mutable = self._mutable_globals(module)
        for func in module.functions():
            if not any(astutil.match_name(func.name, p)
                       for p in config.predict_function_patterns):
                continue
            local = {a.arg for a in (
                func.args.posonlyargs + func.args.args
                + func.args.kwonlyargs)}
            if func.args.vararg:
                local.add(func.args.vararg.arg)
            if func.args.kwarg:
                local.add(func.args.kwarg.arg)
            for node in ast.walk(func):
                for name in getattr(node, "targets", []):
                    local.update(astutil.assigned_names(name))
                if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                    local.update(astutil.assigned_names(node.target))
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    local.update(astutil.assigned_names(node.target))
                elif isinstance(node, ast.comprehension):
                    local.update(astutil.assigned_names(node.target))
                elif isinstance(node, (ast.Global, ast.Nonlocal)):
                    kind = "global" if isinstance(node, ast.Global) \
                        else "nonlocal"
                    yield self.finding(
                        module, node,
                        f"{func.name}() declares {kind} "
                        f"{', '.join(node.names)} — prediction functions "
                        f"must be pure")
            for node in ast.walk(func):
                if isinstance(node, ast.Name) \
                        and isinstance(node.ctx, ast.Load) \
                        and node.id in mutable and node.id not in local:
                    yield self.finding(
                        module, node,
                        f"{func.name}() reads module-global mutable "
                        f"{node.id!r} — pass it as an argument so the "
                        f"pinned prediction stays a pure function")
