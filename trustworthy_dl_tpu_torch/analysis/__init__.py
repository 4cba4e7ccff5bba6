"""tddl-lint for the port — the AST invariant linter over
``trustworthy_dl_tpu_torch/``.

Counterpart of ``trustworthy_dl_tpu/analysis``: the same engine
(one parse a file, line-anchored ``# tddl-lint: disable=RULE``
suppressions, a committed baseline of justified findings), the same rule
names, and contract tables (``contracts.py``) that name the port's
modules.  The rules whose JAX spelling is plain Python (the obs, hygiene,
determinism and artifact rules) check what JAX's check; the others check
the port's spelling of the same hazard:

* **import purity** — host-only modules must not reach ``torch``
  through any module-level import chain, and no module may import
  ``jax``, ``jaxlib``, ``orbax`` or ``trustworthy_dl_tpu`` at all.
* **recompile hazards** — in the hot-loop modules, no
  ``torch.tensor``/``torch.as_tensor`` literal built inside a hot
  function's loop (a blocking host-to-device copy each iteration) and no
  kernel-library build or load (``ops.build``, ``kernel_library``,
  ``ctypes.CDLL``) inside a loop (a mid-run load is the port's compile
  storm).
* **host-sync hazards** — no ``.item()``/``.tolist()``/``.cpu()``/
  ``float()``/``int()``/``bool()``/``np.asarray`` on a value that came
  from a device program or kernel wrapper, and no
  ``torch.cuda.synchronize()``, inside the decode tick, the prefill and
  spec paths, the trainer's epoch loop and the paged kernel wrappers,
  beyond each tick's one intended pull (suppressed inline at its site).
* **sharding registry** — a partition spec (a tuple of mesh-axis names)
  is spelled only in ``core/sharding.py``.

Host-only by contract: nothing in this package (or anything it imports
at module level) imports torch or jax — the ``import-purity`` rule lints
the linter itself.

Entry points: ``python -m trustworthy_dl_tpu_torch.analysis``, the
``trustworthy-dl-torch-lint`` console script
(:mod:`trustworthy_dl_tpu_torch.analysis.cli`) and the tier-1 test
perimeter (``tests/test_torch_lint.py``); the committed baseline is
``tddl_torch_lint_baseline.json`` at the repo root.
"""

from trustworthy_dl_tpu_torch.analysis.baseline import (load_baseline,
                                                        write_baseline)
from trustworthy_dl_tpu_torch.analysis.engine import (Finding, LintConfig,
                                                      LintEngine, LintResult,
                                                      ModuleInfo, Project,
                                                      Rule, run_lint)
from trustworthy_dl_tpu_torch.analysis.rules import all_rules

__all__ = [
    "Finding", "LintConfig", "LintEngine", "LintResult", "ModuleInfo",
    "Project", "Rule", "all_rules", "load_baseline", "run_lint",
    "write_baseline",
]
