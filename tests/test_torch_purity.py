"""The port imports neither JAX, orbax nor the JAX package: checked in a
fresh process by importing every module of ``trustworthy_dl_tpu_torch``
and reading ``sys.modules``, and statically by walking every module's
imports (``chip_smoke.py`` included).  The walk is checked to reach the
modules added since it was written (the async host pipeline,
``elastic/``, the ResNet and VGG families, the tokenizer, the profiling
hooks and the telemetry plane, ``obs/``, with its compile watcher,
forensics, verdict store and perf sentinel; the stripe pool, the chaos
injector's serve hooks and live migration, ``serve/migrate.py``; the
serving fleet, ``serve/fleet.py``; its control plane ``serve/control.py``,
the adaptive adversary ``chaos/adversary.py`` and the serve envelope;
pipeline parallelism: ``core/mesh.py``, ``core/sharding.py``,
``parallel/pipeline.py``, ``elastic/restaff.py`` and the schedule study
``experiments/pipeline_study.py``; sequence parallelism,
``parallel/sequence.py``; tensor parallelism,
``parallel/tensor_parallel.py``, with the layout registry and the group
modes of ``elastic/``; the multi-process worker
``utils/multiproc_worker.py``; the C++ host tier ``native/``, the
kernel-build cache ``utils/compile_cache.py`` and the port's own linter
``analysis/``).
``serve/control.py`` and ``chaos/adversary.py`` import no torch at all,
as their JAX counterparts import no jax; nor do ``analysis/`` (the linter
lints itself: its import-purity rule is clean over the package),
``native/`` and ``utils/compile_cache.py``.  No ``obs`` module imports
torch when it is imported: ``obs/hbm.py`` and ``obs/meta.py`` reach
``torch.cuda`` only inside functions, so importing ``obs`` never
initialises CUDA.  scikit-learn, the ML tier's optional dependency, is
imported only inside functions (behind the trainer's
``_sklearn_available`` gate, as in JAX), never when a module is imported.
Beyond torch and numpy the port imports only optional modules that the
JAX package's counterparts also import optionally (``regex``, ``yaml``,
``matplotlib``, ``sklearn``), each inside a function or a ``try`` that
catches ``ImportError``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "orbax", "trustworthy_dl_tpu")
NEW_MODULES = ("trustworthy_dl_tpu_torch.engine.async_host",
               "trustworthy_dl_tpu_torch.elastic",
               "trustworthy_dl_tpu_torch.elastic.reassignment",
               "trustworthy_dl_tpu_torch.models.resnet",
               "trustworthy_dl_tpu_torch.models.vgg",
               "trustworthy_dl_tpu_torch.data.tokenizer",
               "trustworthy_dl_tpu_torch.utils.profiling",
               *(f"trustworthy_dl_tpu_torch.obs.{m}" for m in (
                   "registry", "events", "recorder", "report", "spans",
                   "slo", "anomaly", "attribution", "hbm", "session",
                   "compilewatch", "forensics", "verdicts", "sentinel")),
               "trustworthy_dl_tpu_torch.serve.kv_slots",
               "trustworthy_dl_tpu_torch.serve.scheduler",
               "trustworthy_dl_tpu_torch.serve.migrate",
               "trustworthy_dl_tpu_torch.serve.fleet",
               "trustworthy_dl_tpu_torch.chaos.injector",
               "trustworthy_dl_tpu_torch.models.moe",
               "trustworthy_dl_tpu_torch.experiments.envelope",
               "trustworthy_dl_tpu_torch.serve.control",
               "trustworthy_dl_tpu_torch.chaos.adversary",
               "trustworthy_dl_tpu_torch.experiments.serve_envelope",
               "trustworthy_dl_tpu_torch.core.mesh",
               "trustworthy_dl_tpu_torch.core.sharding",
               "trustworthy_dl_tpu_torch.parallel",
               "trustworthy_dl_tpu_torch.parallel.pipeline",
               "trustworthy_dl_tpu_torch.elastic.restaff",
               "trustworthy_dl_tpu_torch.experiments.pipeline_study",
               "trustworthy_dl_tpu_torch.parallel.sequence",
               "trustworthy_dl_tpu_torch.parallel.tensor_parallel",
               "trustworthy_dl_tpu_torch.utils.multiproc_worker",
               "trustworthy_dl_tpu_torch.native",
               "trustworthy_dl_tpu_torch.utils.compile_cache",
               "trustworthy_dl_tpu_torch.analysis",
               "trustworthy_dl_tpu_torch.analysis.cli",
               *(f"trustworthy_dl_tpu_torch.analysis.rules.{m}" for m in (
                   "artifact", "determinism", "hygiene", "jit",
                   "locality", "obs", "purity")))
REQUIRED = ("torch", "numpy", "trustworthy_dl_tpu_torch")
OPTIONAL = ("regex", "yaml", "matplotlib", "sklearn")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        f"NEW_MODULES = {NEW_MODULES!r}\n"
        "import importlib, pkgutil, sys\n"
        "import trustworthy_dl_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "roots = ('jax', 'jaxlib', 'orbax', 'trustworthy_dl_tpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in roots]\n"
        "assert not bad, bad\n"
        "for m in NEW_MODULES:\n"
        "    assert m in sys.modules, m\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('trustworthy_dl_tpu_torch.')]))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax():
    files = sorted((REPO / "trustworthy_dl_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 16
    walked = {str(p.relative_to(REPO)) for p in files}
    for name in NEW_MODULES:
        path = name.replace(".", "/")
        assert f"{path}.py" in walked or f"{path}/__init__.py" in walked, \
            name
    bad = [(str(p.relative_to(REPO)), name) for p in files
           for name in _imports(p) if _forbidden(name)]
    assert not bad, bad


def test_scikit_learn_is_imported_only_inside_functions():
    """No module of the port imports sklearn at import time; the imports
    that exist sit in function bodies of the ML tier's two modules."""
    inside = {}
    for path in sorted((REPO / "trustworthy_dl_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = [a.name for n in top if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in top
                  if isinstance(n, ast.ImportFrom)]
        assert not any(n.split(".")[0] == "sklearn" for n in names), path
        for func in ast.walk(tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(func):
                    mods = [a.name for a in node.names] \
                        if isinstance(node, ast.Import) else \
                        [node.module or ""] \
                        if isinstance(node, ast.ImportFrom) else []
                    if any(m.split(".")[0] == "sklearn" for m in mods):
                        inside.setdefault(
                            str(path.relative_to(REPO)), set()).add(
                                func.name)
    assert inside == {
        "trustworthy_dl_tpu_torch/detect/detector.py":
            {"update_detection_models"},
        "trustworthy_dl_tpu_torch/engine/trainer.py":
            {"_sklearn_available"}}


def _catches_import_error(handler: ast.ExceptHandler) -> bool:
    types = handler.type.elts if isinstance(handler.type, ast.Tuple) \
        else [handler.type]
    return any(isinstance(t, ast.Name) and t.id in ("ImportError",
                                                    "ModuleNotFoundError")
               for t in types)


def _guarded_imports(path: Path):
    """(root module, guarded) for every third-party import of a file:
    guarded when it sits in a function or in the body of a ``try`` that
    catches ImportError."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, guarded):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            guarded = True
        if isinstance(node, ast.Try) and any(
                _catches_import_error(h) for h in node.handlers):
            for child in node.body:
                yield from walk(child, True)
            for child in node.handlers + node.orelse + node.finalbody:
                yield from walk(child, guarded)
            return
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            root = name.split(".")[0]
            if root not in sys.stdlib_module_names:
                yield root, guarded
        for child in ast.iter_child_nodes(node):
            yield from walk(child, guarded)

    return list(walk(tree, False))


def test_other_imports_are_optional_and_guarded():
    found = {}
    for path in sorted((REPO / "trustworthy_dl_tpu_torch").rglob("*.py")):
        for root, guarded in _guarded_imports(path):
            if root in REQUIRED:
                continue
            rel = str(path.relative_to(REPO))
            assert root in OPTIONAL, (rel, root)
            assert guarded, (rel, root)
            found.setdefault(root, set()).add(rel)
    assert found["regex"] == {"trustworthy_dl_tpu_torch/data/tokenizer.py"}
    assert found["yaml"] == {"trustworthy_dl_tpu_torch/core/config.py"}


def test_obs_touches_torch_only_inside_functions():
    """Every ``obs`` module imports torch, if at all, inside a function;
    ``hbm.py`` does (its live bytes and budget read ``torch.cuda``)."""
    inside = set()
    for path in sorted((REPO / "trustworthy_dl_tpu_torch" / "obs")
                       .glob("*.py")):
        for root, guarded in _guarded_imports(path):
            if root == "torch":
                assert guarded, path.name
                inside.add(path.name)
    assert {"hbm.py", "meta.py"} <= inside
    code = ("import torch, trustworthy_dl_tpu_torch.obs as obs\n"
            "obs.ObsSession(None).enable_hbm().sweep()\n"
            "assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


HOST_ONLY = ["serve/control.py", "chaos/adversary.py",
             "utils/compile_cache.py", "native/__init__.py",
             *sorted(str(p.relative_to(REPO / "trustworthy_dl_tpu_torch"))
                     for p in (REPO / "trustworthy_dl_tpu_torch"
                               / "analysis").rglob("*.py"))]


@pytest.mark.parametrize("module", HOST_ONLY)
def test_host_only_modules_import_no_torch(module):
    """The control plane, the adversary, the kernel cache, the native
    tier's bindings and the linter are host code: no import of torch
    anywhere in them, inside functions included (the control plane reads
    ``obs/slo.py``, which imports no torch either; the cache's ``warm``
    reaches torch only through ``ops``, inside the function)."""
    path = REPO / "trustworthy_dl_tpu_torch" / module
    roots = {root for root, _ in _guarded_imports(path)}
    assert roots <= {"numpy", "trustworthy_dl_tpu_torch"}, roots
    slo = REPO / "trustworthy_dl_tpu_torch" / "obs" / "slo.py"
    assert "torch" not in {root for root, _ in _guarded_imports(slo)}


def test_the_ports_lint_holds_its_own_import_purity():
    """The port's import-purity rule over the whole package: no module
    imports jax, jaxlib, orbax or the JAX package, and no host-only module
    (``analysis/`` included) reaches torch through module-level imports."""
    from trustworthy_dl_tpu_torch.analysis import run_lint

    result = run_lint(root=str(REPO), rule_names=["import-purity"],
                      use_baseline=False)
    assert result.clean, [f.as_dict() for f in result.findings]
    assert result.files_scanned > 100
