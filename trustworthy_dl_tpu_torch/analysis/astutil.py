"""Small shared AST helpers for the rule modules (stdlib-only): JAX's
``analysis/astutil.py``."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

MUTABLE_DISPLAYS = (ast.List, ast.Dict, ast.Set, ast.ListComp,
                    ast.DictComp, ast.SetComp)

#: Constructor names whose call produces a fresh mutable container.
MUTABLE_FACTORIES = frozenset({
    "list", "dict", "set", "bytearray", "deque", "defaultdict",
    "OrderedDict", "Counter",
})


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None (calls/subscripts
    in the chain break it)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_with_parents(tree: ast.AST) -> Iterator[Tuple[ast.AST,
                                                       Tuple[ast.AST, ...]]]:
    """Yield (node, ancestors) pairs, ancestors outermost-first."""
    stack: List[Tuple[ast.AST, Tuple[ast.AST, ...]]] = [(tree, ())]
    while stack:
        node, parents = stack.pop()
        yield node, parents
        child_parents = parents + (node,)
        for child in ast.iter_child_nodes(node):
            stack.append((child, child_parents))


def enclosing_function(parents: Tuple[ast.AST, ...]
                       ) -> Optional[ast.AST]:
    """Innermost FunctionDef/AsyncFunctionDef ancestor, if any."""
    for node in reversed(parents):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node
    return None


def inside_loop(node_parents: Tuple[ast.AST, ...],
                within: Optional[ast.AST] = None) -> bool:
    """True when any ancestor (optionally only those inside ``within``)
    is a for/while loop."""
    seen_within = within is None
    for parent in node_parents:
        if parent is within:
            seen_within = True
            continue
        if seen_within and isinstance(parent, (ast.For, ast.AsyncFor,
                                               ast.While)):
            return True
    return False


def is_mutable_default(node: ast.AST) -> bool:
    if isinstance(node, MUTABLE_DISPLAYS):
        return True
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name is not None and \
                name.rsplit(".", 1)[-1] in MUTABLE_FACTORIES:
            return True
    return False


def match_name(name: str, pattern: str) -> bool:
    """fnmatch on a bare identifier (function-name patterns)."""
    import fnmatch

    return fnmatch.fnmatch(name, pattern)


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def literal_head(node: ast.AST) -> Optional[str]:
    """The statically-known string (or string PREFIX for f-strings) a
    name expression starts with; None when fully dynamic."""
    s = const_str(node)
    if s is not None:
        return s
    if isinstance(node, ast.JoinedStr) and node.values:
        return const_str(node.values[0])
    return None


def assigned_names(target: ast.AST) -> Iterator[str]:
    """Every plain Name bound by an assignment target (tuples/lists/
    starred unpacked recursively; attribute/subscript targets skipped)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, ast.Starred):
        yield from assigned_names(target.value)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_names(elt)
