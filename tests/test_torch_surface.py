"""The port's public surface against the JAX package's.

Every public top-level name of every module of ``trustworthy_dl_tpu``
(read with ``ast``: functions, classes, assignments and ``__all__``), and
every public method of its public classes, is served at the same module
path of ``trustworthy_dl_tpu_torch``, or it is in :data:`NOT_PORTED` with
the reason it has no counterpart on the card.  The not-ported names are
absent from the port, still present in JAX, and stand in ROADMAP.md's
Queue C.  The root package serves JAX's exports from the counterpart
modules, lazily (no torch, no jax at import); each subpackage's
``__all__`` is JAX's less the not-ported names, plus the port's own
names pinned in :data:`PORT_EXTRAS`.  The host-only modules import no
torch, and every ``trustworthy-dl-torch-*`` console script names a
callable.  No JAX import is needed: JAX's modules are only parsed.
"""

import ast
import importlib
import re
import subprocess
import sys
import tomllib
import types
from functools import lru_cache
from pathlib import Path

import pytest

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = "trustworthy_dl_tpu"
PORT_PKG = "trustworthy_dl_tpu_torch"

_GATE = "the port dispatches by device and reads its *_kernel_limit functions"
_TILE = "TPU tile geometry"
_XLA = "XLA's analysis of a lowered program"
_NAMED = "a NamedSharding / with_sharding_constraint helper; the port carries specs"
_XLA_CACHE = "a count of XLA's compiled programs; the port has no tracing cache"
_ARRAY = "the jax.Array alias"
_LOGGER = "a module logger the port's module does not need"

#: JAX public names the port does not serve, by module (relative to the
#: package; "" is the root) -> name (``Class.method`` for a method) ->
#: reason.  ROADMAP.md, Queue C, "Names not ported", lists the same.
NOT_PORTED = {
    "ops": {
        "pallas_enabled": _GATE,
        "pallas_interpret": _GATE,
        "resolve_attn_impl": _GATE,
        "resolve_attn_impls": _GATE,
        "supports_paged_attention": _GATE,
        "BLOCK_ROWS": _TILE,
        "LANES": _TILE,
        "flash_attention": "the submodule's name at this path; the wrapper "
                           "is ops.flash_attention.flash_attention",
    },
    "ops.paged_attention": {
        "resolve_attn_impl": _GATE,
        "resolve_attn_impls": _GATE,
        "supports_paged_attention": _GATE,
        "ATTN_IMPLS": "the port's paths are models.generate.ATTN_IMPLS",
        "PAGED_PROGRAMS": "the port's programs are serve.engine.PAGED_PROGRAMS",
        "paged_attention_reference": "spelled paged_attention_plain",
        "logit_trust_stats_reference": "spelled logit_trust_stats_plain",
        "kv_sublane": _TILE,
        "TRUST_TILE": _TILE,
        "MAX_HEAD_DIM": _TILE,
        "logger": _LOGGER,
    },
    "ops.flash_attention": {"MAX_HEAD_DIM": _TILE},
    "ops.fused_stats": {"BLOCK_ROWS": _TILE, "LANES": _TILE},
    "ops.fused_dequant_matmul": {"TILE_N": _TILE,
                                 "dequant_matmul_tiles": _TILE},
    "ops.fused_ce": {"Array": _ARRAY},
    "quant.int8": {"INT8_SUBLANE": _TILE},
    "obs": {"analyze_program": _XLA},
    "obs.hbm": {"analyze_program": _XLA,
                "memory_analysis_enabled": _XLA,
                "CostLedger.analyze": _XLA},
    "obs.compilewatch": {"BACKEND_COMPILE_EVENT": "a JAX monitoring event"},
    "core.mesh": {"shard_map_compat": _NAMED,
                  "node_sharding": _NAMED,
                  "replicated": _NAMED},
    "core.sharding": {"replicated_sharding": _NAMED,
                      "row_sharding": _NAMED,
                      "ShardingRules.constrain": _NAMED},
    "serve.scheduler": {
        "request_key_stream": "threefry, which the port's random numbers "
                              "rule out",
        "ContinuousBatchingScheduler.decode_cache_size": _XLA_CACHE,
        "PagedBatchingScheduler.decode_cache_size": _XLA_CACHE,
        "PagedBatchingScheduler.spec_cache_sizes": _XLA_CACHE,
    },
    "native": {"build_library": "the port builds through the shared "
                                "kernel-cache helper (native.build)",
               "logger": _LOGGER},
    "engine.step": {"Array": _ARRAY},
    "parallel.pipeline": {"Array": _ARRAY},
}

#: Names a port subpackage's ``__all__`` serves beyond JAX's: its own API.
PORT_EXTRAS = {
    "ops": {"BUILD_DIR", "CSRC", "DTYPE_CODES", "SIGNATURES", "build",
            "check_launch", "count_kernel_flops", "kernel_library",
            "kernel_wrappers", "launch_counts", "library_path",
            "note_compile", "nvcc_path", "on_cuda", "reset_launch_counts",
            "stream_handle", "tally_flops"},
    "native": {"GXX_FLAGS", "SIGNATURES", "SOURCE", "bpe_encode",
               "bpe_load", "build", "gather_rows_plain", "gxx_path",
               "library", "library_path", "permutation_plain",
               "splitmix_fill_plain", "synthetic_tokens_plain",
               "window_gather_plain"},
    "obs": {"count_flops"},
    "serve": {"can_migrate", "migrate_request"},
}

#: Modules that must import neither torch nor jax.
TORCH_FREE = ("", "utils.compile_cache", "native", "analysis",
              "chaos.adversary", "obs.forensics", "serve.control")


def _jax_modules():
    root = REPO / JAX_PKG
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


JAX_MODULES = _jax_modules()
SUBPACKAGES = sorted(m for m in JAX_MODULES
                     if (REPO / JAX_PKG / m.replace(".", "/")
                         / "__init__.py").exists() and m)


def _path(pkg: str, module: str) -> str:
    return f"{pkg}.{module}" if module else pkg


def _source(module: str) -> Path:
    base = REPO / JAX_PKG / module.replace(".", "/")
    init = base / "__init__.py"
    return init if (not module or init.exists()) else base.with_suffix(".py")


def _literal_all(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            try:
                return list(ast.literal_eval(node.value))
            except ValueError:
                return None
    return None


@lru_cache(maxsize=None)
def _jax_public(module: str):
    """(public names, {class: public methods}, literal __all__ or None)."""
    tree = ast.parse(_source(module).read_text())
    names, methods = [], {}
    for node in tree.body:
        targets = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            targets = [node.name]
        elif isinstance(node, ast.ClassDef):
            targets = [node.name]
            methods[node.name] = [
                n.name for n in node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                and not n.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            targets = [node.target.id]
        names += [t for t in targets if not t.startswith("_")]
    exported = _literal_all(tree)
    names += [n for n in exported or () if n not in names]
    return names, methods, exported


def _port(module: str) -> types.ModuleType:
    return importlib.import_module(_path(PORT_PKG, module))


def _serves(obj, name: str) -> bool:
    """True where ``obj`` has ``name`` as something other than a module
    (a package's attribute can be a submodule that shadows the name)."""
    return hasattr(obj, name) and not isinstance(getattr(obj, name),
                                                 types.ModuleType)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_jax_public_names_are_served(module):
    names, methods, _ = _jax_public(module)
    skip = NOT_PORTED.get(module, {})
    port = _port(module)
    missing = [n for n in names if n not in skip and not _serves(port, n)]
    for cls, meths in methods.items():
        if cls in skip or not _serves(port, cls):
            continue
        missing += [f"{cls}.{m}" for m in meths
                    if f"{cls}.{m}" not in skip
                    and not hasattr(getattr(port, cls), m)]
    assert not missing, f"{_path(PORT_PKG, module)} lacks {missing}"


def test_not_ported_names_are_absent_in_jax_and_recorded():
    roadmap = (REPO / "ROADMAP.md").read_text()
    for module, entries in NOT_PORTED.items():
        names, methods, _ = _jax_public(module)
        port = _port(module)
        for name, reason in entries.items():
            assert reason, name
            cls, _, meth = name.rpartition(".")
            if cls:
                assert meth in methods.get(cls, ()), (module, name)
                assert not hasattr(getattr(port, cls), meth), (module, name)
            else:
                assert name in names, (module, name)
                assert not _serves(port, name), (
                    f"{module}.{name} is served by the port: take it out "
                    "of NOT_PORTED")
            assert re.search(rf"[`.]{re.escape(meth)}`", roadmap), (
                f"ROADMAP.md (Queue C, names not ported) must list {name}")


def test_root_exports_equal_jax_and_resolve_lazily():
    tree = ast.parse((REPO / JAX_PKG / "__init__.py").read_text())
    exports = next(ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and n.targets[0].id == "_EXPORTS")
    root = _port("")
    assert root.__all__ == sorted(exports)
    assert set(exports) <= set(dir(root))
    for name, module in exports.items():
        obj = getattr(root, name)
        assert obj.__module__ == module.replace(JAX_PKG, PORT_PKG, 1), name
    with pytest.raises(AttributeError):
        root.NoSuchName  # noqa: B018


@pytest.mark.parametrize("package", SUBPACKAGES)
def test_subpackage_all_is_jaxs_less_not_ported(package):
    _, _, jax_all = _jax_public(package)
    port = _port(package)
    if jax_all is None:
        return
    want = set(jax_all) - set(NOT_PORTED.get(package, {}))
    port_all = set(getattr(port, "__all__", ()))
    assert want <= port_all, sorted(want - port_all)
    assert port_all - set(jax_all) == PORT_EXTRAS.get(package, set())
    for name in port_all:
        assert _serves(port, name), (package, name)


@pytest.mark.parametrize("module", TORCH_FREE)
def test_module_imports_no_torch_nor_jax(module):
    code = (f"import sys, {_path(PORT_PKG, module)}\n"
            "bad = sorted(m for m in ('torch', 'jax') if m in sys.modules)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_console_scripts_name_callables():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    ours = {k: v for k, v in scripts.items()
            if k.startswith("trustworthy-dl-torch-")}
    jax_names = {k.removeprefix("trustworthy-dl-") for k, v in scripts.items()
                 if v.startswith(f"{JAX_PKG}.") or v.startswith(
                     f"{JAX_PKG}:")}
    assert {k.removeprefix("trustworthy-dl-torch-") for k in ours} \
        == jax_names
    for name, target in ours.items():
        module, _, attr = target.partition(":")
        assert module.split(".")[0] == PORT_PKG, name
        assert callable(getattr(importlib.import_module(module), attr)), name
