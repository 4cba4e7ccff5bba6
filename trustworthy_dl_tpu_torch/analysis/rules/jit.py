"""Recompile and host-sync hazard rules for the hot paths, in the port's
spelling.

Counterpart of ``trustworthy_dl_tpu/analysis/rules/jit.py``.  The port has
no tracing cache, so JAX's ``jax.jit`` in a loop and ``jax.jit(lambda
...)`` have no spelling here; the port's hazards of the same two kinds are:

* **recompile-hazard.**  A ``torch.tensor(...)`` / ``torch.as_tensor(...)``
  literal built inside a hot function's loop is a blocking host-to-device
  copy every iteration (use ``torch.full`` or a per-device cache, as
  ``detect/detector._family_types`` does); and a kernel library built or
  loaded inside a loop (``ops.build``, ``kernel_library``,
  ``ctypes.CDLL``) is a mid-run compile, the port's compile storm, which
  the compile watcher catches only after the fact.
* **host-sync.**  The serve hot path reads the device once a decode tick
  and once a prefill, and the trainer once a step, each through one packed
  copy.  The rule taints locals assigned from device-producing calls
  (``torch.*``, the paged programs ``*_impl``, the trainer's
  ``_dispatch``, the kernel wrappers: ``contracts.DEVICE_PRODUCERS``) and
  flags a sync spelling applied to a tainted value — ``.item()``,
  ``.tolist()``, ``.cpu()``, ``float()``/``int()``/``bool()``,
  ``np.asarray``/``np.array`` — and any ``torch.cuda.synchronize()``; a
  tensor's ``shape``, ``dtype``, ``device``, ``size()``, ``dim()`` and
  ``numel()`` are host metadata, not syncs.  The intentional single
  pulls are suppressed inline at the site with their justification.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

from trustworthy_dl_tpu_torch.analysis import astutil
from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      ModuleInfo, Project,
                                                      Rule, match_any)

#: torch constructors whose all-literal call copies a host constant to the
#: device.
_DEVICE_LITERAL_CTORS = frozenset({"torch.tensor", "torch.as_tensor"})

#: Calls that build or load a kernel library.
_LIBRARY_LOADS = frozenset({"build", "ops.build", "kernel_library",
                            "ops.kernel_library", "ctypes.CDLL",
                            "load_library", "compile_cache.load_library"})

#: Function-name shapes that mark a serving/training hot loop body.
_HOT_FUNCTION_PATTERNS = ("*tick*", "*decode*", "*prefill*", "*step*",
                          "train_epoch", "run_until_idle")

_SYNC_FUNCS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                         "numpy.array"})
_SYNC_BUILTINS = frozenset({"float", "int", "bool"})
_SYNC_METHODS = frozenset({"item", "tolist", "cpu"})
_SYNCHRONIZE = frozenset({"torch.cuda.synchronize"})

#: A tensor's host-side metadata: reading it moves no data.
_METADATA_ATTRS = frozenset({"shape", "dtype", "device", "ndim",
                             "is_cuda"})
_METADATA_METHODS = frozenset({"size", "dim", "numel", "stride",
                               "data_ptr", "element_size"})


def _is_literal(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal(e) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_literal(node.operand)
    return False


class RecompileHazardRule(Rule):
    """In the hot-loop modules: no kernel-library build or load inside a
    loop, and no ``torch.tensor`` literal built inside a hot function's
    loop."""

    name = "recompile-hazard"
    description = ("no kernel-library build/load in loops, no "
                   "torch.tensor literals inside hot loops")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return match_any(rel, config.hot_loop_modules)

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        for node, parents in astutil.walk_with_parents(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = astutil.dotted(node.func)
            if name in _LIBRARY_LOADS:
                if astutil.inside_loop(parents):
                    yield self.finding(
                        module, node,
                        f"{name}() inside a loop builds or loads a kernel "
                        f"library mid-run — load it once, before the loop")
            elif name in _DEVICE_LITERAL_CTORS \
                    and node.args and _is_literal(node.args[0]):
                func = astutil.enclosing_function(parents)
                if func is None or not any(
                        astutil.match_name(func.name, p)
                        for p in _HOT_FUNCTION_PATTERNS):
                    continue
                if astutil.inside_loop(parents, within=func):
                    yield self.finding(
                        module, node,
                        f"{name}({ast.unparse(node.args[0])}) copies a "
                        f"host constant to the device every {func.name}() "
                        f"loop iteration — hoist it or build it on the "
                        f"device (torch.full)")


def _device_producing(node: ast.Call, config: LintConfig) -> bool:
    func = node.func
    if isinstance(func, ast.Subscript):
        # programs["decode"](...)-style dispatch
        return True
    name = astutil.dotted(func)
    if name is None:
        return False
    if name.startswith("torch."):
        return name not in _SYNCHRONIZE
    tail = name.rsplit(".", 1)[-1]
    return tail.endswith("_impl") or tail in config.device_producers


def _sync_kind(node: ast.Call) -> str:
    """'' when not a sync spelling, else a short description."""
    name = astutil.dotted(node.func)
    if name in _SYNC_FUNCS or name in _SYNC_BUILTINS \
            or name in _SYNCHRONIZE:
        return name
    if isinstance(node.func, ast.Attribute) \
            and node.func.attr in _SYNC_METHODS:
        return f".{node.func.attr}()"
    return ""


def _host_metadata(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in _METADATA_ATTRS:
        return True
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _METADATA_METHODS:
            return True
        return astutil.dotted(node.func) == "len"
    return False


_COMPS = (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)


class _TaintScan:
    """Per-function device-taint propagation (flow-insensitive to a
    fixpoint, which is conservative and cheap).  Comprehension targets
    are scoped, exactly as in Python 3."""

    def __init__(self, func: ast.AST, config: LintConfig):
        self.func = func
        self.config = config
        self.tainted: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for node in ast.walk(func):
                names: Set[str] = set()
                if isinstance(node, ast.Assign) \
                        and self._expr_tainted(node.value):
                    for t in node.targets:
                        names.update(astutil.assigned_names(t))
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                        and node.value is not None \
                        and self._expr_tainted(node.value):
                    names.update(astutil.assigned_names(node.target))
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "append" \
                        and isinstance(node.func.value, ast.Name) \
                        and any(self._expr_tainted(a) for a in node.args):
                    # xs.append(device_value): the container now yields
                    # device values when iterated.
                    names.add(node.func.value.id)
                elif isinstance(node, (ast.For, ast.AsyncFor)) \
                        and self._expr_tainted(node.iter):
                    names.update(astutil.assigned_names(node.target))
                if not names <= self.tainted:
                    self.tainted |= names
                    changed = True

    def comp_scope(self, node: ast.AST,
                   extra: frozenset = frozenset()) -> frozenset:
        """Comprehension-local tainted targets (targets bound from a
        tainted iterable), given already-accumulated ``extra``."""
        out = set(extra)
        for gen in getattr(node, "generators", ()):
            if self._expr_tainted(gen.iter, frozenset(out)):
                out.update(astutil.assigned_names(gen.target))
        return frozenset(out)

    def _expr_tainted(self, expr: ast.AST,
                      extra: frozenset = frozenset()) -> bool:
        """Does the expression's VALUE live on the device?  Sync calls and
        metadata reads are boundaries (their result is host memory); a
        comprehension's value is its element expression, evaluated with
        the comprehension targets scoped in."""
        stack = [(expr, extra)]
        while stack:
            node, ctx = stack.pop()
            if _host_metadata(node):
                continue
            if isinstance(node, ast.Call):
                if _sync_kind(node):
                    continue  # result is host-side
                if _device_producing(node, self.config):
                    return True
            if isinstance(node, _COMPS):
                scope = self.comp_scope(node, ctx)
                if isinstance(node, ast.DictComp):
                    stack.append((node.key, scope))
                    stack.append((node.value, scope))
                else:
                    stack.append((node.elt, scope))
                continue
            if isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load) \
                    and (node.id in self.tainted or node.id in ctx):
                return True
            stack.extend((child, ctx)
                         for child in ast.iter_child_nodes(node))
        return False


class HostSyncRule(Rule):
    """No device-to-host pulls on device values, and no
    ``torch.cuda.synchronize()``, inside the decode tick, the prefill and
    spec paths, the trainer's epoch loop and the paged kernel wrappers,
    beyond the inline-suppressed intentional ones."""

    name = "host-sync"
    description = (".item()/.tolist()/.cpu()/float()/np.asarray on device "
                   "values, and cuda synchronize, are banned in the serve "
                   "ticks and the train loop")

    def applies(self, rel: str, config: LintConfig) -> bool:
        return rel in config.host_sync_scopes

    def check(self, module: ModuleInfo, project: Project,
              config: LintConfig) -> Iterable[Finding]:
        scoped = set(config.host_sync_scopes.get(module.rel, ()))
        for func in module.functions():
            if func.name not in scoped:
                continue
            scan = _TaintScan(func, config)
            for node, parents in astutil.walk_with_parents(func):
                if not isinstance(node, ast.Call):
                    continue
                kind = _sync_kind(node)
                if not kind:
                    continue
                if kind in _SYNCHRONIZE:
                    yield self.finding(
                        module, node,
                        f"{kind}() blocks the host on the whole card inside "
                        f"{func.name}() — read the one packed copy instead "
                        f"or suppress with justification")
                    continue
                arg: ast.AST
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_METHODS:
                    arg = node.func.value
                elif node.args:
                    arg = node.args[0]
                else:
                    continue
                extra: frozenset = frozenset()
                for ancestor in parents:
                    if isinstance(ancestor, _COMPS):
                        extra = scan.comp_scope(ancestor, extra)
                if scan._expr_tainted(arg, extra):
                    yield self.finding(
                        module, node,
                        f"{kind} forces a device->host sync on a device "
                        f"value inside {func.name}() — batch it into the "
                        f"tick's single pull or suppress with "
                        f"justification")
