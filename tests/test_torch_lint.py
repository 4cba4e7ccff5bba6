"""tddl-lint for the port (``trustworthy_dl_tpu_torch/analysis``) on the
CPU, held against the JAX package's linter (``tests/test_lint.py``).

* **Shared rules** — the rules whose spelling is plain Python (obs,
  artifact, determinism, hygiene, and the adapter page-table
  redefinition) give the same findings, rule for rule and line for line,
  from JAX's ``LintEngine`` and the port's over the same fixture tree
  (written once under each package's name).
* **The port's spellings** — import purity (``torch`` reached from a
  host-only module at module level; ``jax`` or the JAX package imported
  anywhere), recompile hazards (a kernel-library load in a loop, a
  ``torch.tensor`` literal in a hot loop), host syncs (``.cpu()``,
  ``.item()``, ``float()`` on device values, ``torch.cuda.synchronize``)
  and the sharding registry (a spec tuple of mesh-axis constants): a
  positive, a negative and a suppression each.
* **Engine mechanics** — suppressions, the baseline round trip, parse
  errors, the CLI's exit codes and formats.
* **The gate** — the full rule set over the port with the committed
  ``tddl_torch_lint_baseline.json`` is clean, every baseline entry is
  justified, the linter's process imports neither torch nor jax, and its
  own import-purity rule passes over it.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from trustworthy_dl_tpu import analysis as janalysis
from trustworthy_dl_tpu_torch.analysis import (LintConfig, LintEngine,
                                               all_rules, contracts,
                                               load_baseline, run_lint,
                                               write_baseline)
from trustworthy_dl_tpu_torch.analysis.cli import main as lint_main

pytestmark = [pytest.mark.torchport, pytest.mark.lint]

REPO = Path(__file__).resolve().parent.parent
PKG = "trustworthy_dl_tpu_torch"

#: Synthetic event vocabulary so fixtures don't depend on the real enum.
EVENTS = frozenset({"TRAIN_STEP", "SERVE_RETIRE"})


def _write_tree(root, files, pkg=PKG):
    for rel, src in files.items():
        p = root / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def _run(tmp_path, files, config=None, rules=None, baseline=None):
    _write_tree(tmp_path, files)
    engine = LintEngine(all_rules(),
                        config=config or LintConfig(event_members=EVENTS))
    return engine.run(str(tmp_path), paths=[str(tmp_path)],
                      rule_names=rules, baseline=baseline)


def _lines(result):
    return sorted(f.line for f in result.findings)


# ---------------------------------------------------------------------------
# the shared rules: JAX's findings, line for line
# ---------------------------------------------------------------------------

SHARED_RULES = ("obs-emit-type", "metric-prefix", "metric-label-vocab",
                "artifact-reason-vocab", "tick-determinism",
                "predict-purity", "mutable-default", "bare-except",
                "artifact-metadata", "atomic-write", "adapter-locality")

SHARED_TREE = {
    "{pkg}/obs/mod.py": '''\
        import json

        def f(bus, reg, path, payload, name, EventType):
            bus.emit("train_step", step=1)
            bus.emit(EventType.NOPE, step=1)
            bus.emit(EventType.TRAIN_STEP, step=1)
            bus.emit(
                "serve_retire", request_id=1)
            reg.counter("bad_total", labels=("tenent",))
            reg.gauge(f"bad_{name}_depth")
            reg.histogram("tddl_ok_seconds", labels=("tenant",))
            with open(path, "w") as f:
                json.dump(payload, f)
        ''',
    "{pkg}/obs/good.py": '''\
        import json, os

        def good(path, payload):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)

        def append_log(path, line):
            with open(path, "a") as f:
                f.write(line)
        ''',
    "{pkg}/serve/episodes.py": '''\
        def episode(session, recorder, fleet, why, obs_dir):
            session.dump_flight("slo_breech", step=3)
            fleet._forensic_incident(reason="preemption ")
            recorder.dump(obs_dir, "guard_tripp")
            session.dump_flight("guard_trip", step=3)
            session.dump_flight(why, step=3)
            fleet.schedule(reason="retry_budget")
            # tddl-lint: disable=artifact-reason-vocab — a fixture's reason
            recorder.dump("smoke_drill")
        ''',
    "{pkg}/serve/control.py": '''\
        import random, time
        import numpy as np

        _CACHE = {}

        def decide(seed, ticks):
            t = time.time()
            r = random.random()
            x = np.random.rand()
            bad = np.random.default_rng()
            rng = np.random.default_rng(seed)
            for k in {1, 2}:
                pass
            for k in sorted({1, 2}):
                pass
            return t + r + x

        def autoscale_pressure(cfg, sig):
            return _CACHE.get(sig)

        def predict_fleet(plan, horizon):
            global _CACHE
            return horizon
        ''',
    "{pkg}/serve/adapters_clone.py": '''\
        def adapter_page_row(slots, n):
            return [0] * n

        def admit(task, n, adapter_page_row):
            return adapter_page_row({}, n)
        ''',
    "{pkg}/engine/supervisor.py": '''\
        def recover(xs=[], m={}, ok=None):
            try:
                pass
            except:
                pass
            try:
                pass
            except Exception:
                pass
        ''',
    "{pkg}/experiments/writer.py": '''\
        import json, os

        def save(path, payload):
            with open(path + ".tmp", "w") as f:
                json.dump(payload, f)
            os.replace(path + ".tmp", path)
        ''',
    "{pkg}/models/cfg.py": '''\
        import dataclasses
        from dataclasses import field

        @dataclasses.dataclass
        class Cfg:
            aux: dict = field(default={})
            tags: list = []
            names: list = field(default_factory=list)
        ''',
}


def _shared_findings(root, pkg, engine):
    _write_tree(root, SHARED_TREE, pkg=pkg)
    result = engine.run(str(root), paths=[str(root)],
                        rule_names=list(SHARED_RULES))
    return sorted((f.rule, f.path.replace(pkg + "/", "{pkg}/", 1), f.line)
                  for f in result.findings)


def test_shared_rules_find_what_jax_finds(tmp_path):
    jax_side = _shared_findings(
        tmp_path / "jax", "trustworthy_dl_tpu",
        janalysis.LintEngine(janalysis.all_rules(), config=janalysis.
                             LintConfig(event_members=EVENTS)))
    port = _shared_findings(
        tmp_path / "port", PKG,
        LintEngine(all_rules(), config=LintConfig(event_members=EVENTS)))
    assert port == jax_side
    # Every shared rule fired at least once on the tree.
    assert {rule for rule, _, _ in port} == set(SHARED_RULES)


def test_every_jax_rule_has_a_port_counterpart():
    assert [r.name for r in all_rules()] == \
        [r.name for r in janalysis.all_rules()]
    assert all(r.description for r in all_rules())


def test_contract_tables_name_port_modules():
    tables = (contracts.DETERMINISTIC_MODULES, contracts.HOT_LOOP_MODULES,
              tuple(contracts.HOST_SYNC_SCOPES), contracts.RECOVERY_MODULES,
              (contracts.ADAPTER_HOME_MODULE,
               contracts.SHARDING_HOME_MODULE))
    for table in tables:
        for rel in table:
            assert rel.startswith(PKG + "/"), rel
            if "*" not in rel:
                assert (REPO / rel).is_file(), rel
    for rel, names in contracts.HOST_SYNC_SCOPES.items():
        source = (REPO / rel).read_text()
        for name in names:
            assert f"def {name}(" in source, (rel, name)


# ---------------------------------------------------------------------------
# import purity: torch from host-only modules, jax from anywhere
# ---------------------------------------------------------------------------


def test_import_purity_host_only_chain_reaching_torch(tmp_path):
    config = LintConfig(event_members=EVENTS,
                        host_only_modules=(f"{PKG}/hostonly.py",))
    result = _run(tmp_path, {
        "{pkg}/__init__.py": "",
        "{pkg}/hostonly.py": '''\
            from typing import TYPE_CHECKING

            from trustworthy_dl_tpu_torch import middle

            if TYPE_CHECKING:
                import torch  # annotation-only: never executes

            def lazy():
                import torch  # sanctioned escape hatch
                return torch
            ''',
        "{pkg}/middle.py": "import torch.nn as nn\n",
    }, config=config, rules=["import-purity"])
    assert [(f.path, f.line) for f in result.findings] == \
        [(f"{PKG}/hostonly.py", 3)]
    assert f"{PKG}/middle.py -> torch" in result.findings[0].message
    clean = _run(tmp_path, {"{pkg}/middle.py": "import numpy as np\n"},
                 config=config, rules=["import-purity"])
    assert clean.clean


def test_import_purity_refuses_jax_anywhere(tmp_path):
    result = _run(tmp_path, {
        "{pkg}/serve/engine.py": '''\
            import torch
            import jaxlib

            def convert(tree):
                import jax.numpy as jnp
                from trustworthy_dl_tpu.models import gpt2
                from trustworthy_dl_tpu_torch.models import convert
                import orbax.checkpoint  # tddl-lint: disable=import-purity
                return jnp, gpt2, convert
            ''',
    }, rules=["import-purity"])
    assert _lines(result) == [2, 5, 6]
    assert "'jax.numpy'" in result.findings[1].message


# ---------------------------------------------------------------------------
# recompile and host-sync hazards, the port's spellings
# ---------------------------------------------------------------------------


def test_recompile_hazard_library_loads_and_literals(tmp_path):
    hot = '''\
        import ctypes
        import torch
        from trustworthy_dl_tpu_torch import ops

        def warm(names):
            for name in names:
                ops.kernel_library(name)          # load in a loop
            ops.build()                           # fine: once

        def decode_tick(self, xs):
            for x in xs:
                pad = torch.tensor([0, 0])        # literal per iteration
                y = torch.as_tensor(x)            # fine: real data
                lib = ctypes.CDLL("lib.so")       # load in a loop
            return pad, y, lib

        def _decode_impl(tokens):
            for _ in range(2):
                z = torch.tensor([1.0])           # eager: still a copy
            return z

        def cold_setup():
            for _ in range(2):
                w = torch.tensor([1.0])           # fine: not a hot fn
            return w

        def reload(names):
            for name in names:
                # tddl-lint: disable=recompile-hazard — fixture
                ops.kernel_library(name)
        '''
    result = _run(tmp_path, {"{pkg}/serve/scheduler.py": hot,
                             "{pkg}/serve/other.py": hot},
                  rules=["recompile-hazard"])
    assert [(f.path, f.line) for f in result.findings] == [
        (f"{PKG}/serve/scheduler.py", n) for n in (7, 12, 14, 19)]
    assert "mid-run" in result.findings[0].message
    assert "torch.full" in result.findings[1].message


def test_host_sync_rule_on_device_values(tmp_path):
    result = _run(tmp_path, {
        "{pkg}/serve/scheduler.py": '''\
            import numpy as np
            import torch

            def decode_tick(self, tokens):
                packed = _decode_impl(self.cfg, torch.as_tensor(tokens))
                host = packed.cpu().numpy()          # a pull
                ent = float(host[1])                 # fine: host value
                loss = float(packed[0])              # a pull
                rows = int(packed.shape[0])          # fine: metadata
                drafts = [d.item() for d in packed]  # pull in a comp
                n = len(packed) + packed.numel()     # fine: metadata
                torch.cuda.synchronize()             # a stall
                return ent, loss, rows, drafts, n

            def _spec_tick(self, xs):
                out = paged_attention(xs)
                # tddl-lint: disable=host-sync — the one deliberate pull
                host = out.tolist()
                return host

            def admit(self, task):
                tok = np.asarray(task.prompt)        # fine: host input
                return int(tok[0])

            def cold_path(xs):
                return _decode_impl(xs).cpu()        # out of scope
            ''',
    }, rules=["host-sync"])
    assert _lines(result) == [6, 8, 10, 12]
    assert all("decode_tick" in f.message for f in result.findings)


# ---------------------------------------------------------------------------
# resource locality, the port's spec spelling
# ---------------------------------------------------------------------------


def test_sharding_registry_rule_flags_spec_tuples_outside_home(tmp_path):
    result = _run(tmp_path, {
        "{pkg}/engine/trainer.py": '''\
            from trustworthy_dl_tpu_torch.core import mesh
            from trustworthy_dl_tpu_torch.core import sharding as shreg
            from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, \\
                MODEL_AXIS

            def place(tree):
                a = (DATA_AXIS, None)                 # a spec tuple
                b = (None, mesh.MODEL_AXIS)           # attribute spelling
                c = ((DATA_AXIS, MODEL_AXIS),)        # nested
                d = shreg.row_spec(DATA_AXIS)         # registry: fine
                e = ("data", None)                    # not an axis const
                f = (DATA_AXIS, 3)                    # not a spec
                # tddl-lint: disable=sharding-registry-only — fixture
                g = (None, DATA_AXIS)
                return a, b, c, d, e, f, g
            ''',
        "{pkg}/core/sharding.py": '''\
            from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS

            def row_spec(axis):
                return (axis,) if axis else (DATA_AXIS,)
            ''',
        "{pkg}/core/mesh.py": '''\
            DATA_AXIS, MODEL_AXIS = "data", "model"
            AXIS_ORDER = (DATA_AXIS, MODEL_AXIS)
            ''',
        "tests/test_something.py": "x = (DATA_AXIS, None)\n",
    }, rules=["sharding-registry-only"])
    assert [(f.path, f.line) for f in result.findings] == [
        (f"{PKG}/engine/trainer.py", n) for n in (7, 8, 9)]
    assert "logical-axis registry" in result.findings[0].message


def test_adapter_locality_rule_flags_spec_tuples_in_adapter_code(tmp_path):
    result = _run(tmp_path, {
        "{pkg}/serve/scheduler.py": '''\
            from trustworthy_dl_tpu_torch.core.mesh import MODEL_AXIS

            def _shard_adapter_pool(arrs):
                return (None, MODEL_AXIS)

            def _shard_kv_pool(arrs):
                return (None, MODEL_AXIS)
            ''',
        "{pkg}/serve/adapters.py": '''\
            from trustworthy_dl_tpu_torch.core.mesh import MODEL_AXIS

            def adapter_page_row(slots, n):
                return (None, MODEL_AXIS)
            ''',
    }, rules=["adapter-locality"])
    assert [(f.path, f.line) for f in result.findings] == \
        [(f"{PKG}/serve/scheduler.py", 4)]


# ---------------------------------------------------------------------------
# engine mechanics
# ---------------------------------------------------------------------------


def test_suppressions_line_block_and_file(tmp_path):
    result = _run(tmp_path, {
        "{pkg}/a.py":
            'def f(reg):\n'
            '    reg.counter("bad_total")  '
            '# tddl-lint: disable=metric-prefix — legacy export\n',
        "{pkg}/b.py":
            'def f(reg):\n'
            '    # tddl-lint: disable=metric-prefix — kept for the\n'
            '    # external dashboard that predates the convention\n'
            '    reg.counter("bad_total")\n',
        "{pkg}/c.py":
            '# tddl-lint: disable-file=metric-prefix\n'
            'def f(reg):\n'
            '    reg.counter("bad_total")\n',
        "{pkg}/d.py":
            'def f(reg):\n'
            '    reg.counter("bad_total")  '
            '# tddl-lint: disable=host-sync\n',
    }, rules=["metric-prefix"])
    assert [f.path for f in result.findings] == [f"{PKG}/d.py"]


def test_baseline_round_trip_and_stale_detection(tmp_path):
    files = {"{pkg}/mod.py": 'def f(reg):\n    reg.counter("bad_total")\n'}
    dirty = _run(tmp_path, files, rules=["metric-prefix"])
    assert len(dirty.findings) == 1
    path = tmp_path / "baseline.json"
    write_baseline(dirty.findings, str(path),
                   justification="pre-lint metric kept for dashboards")
    entries = load_baseline(str(path))
    assert entries[0]["justification"].startswith("pre-lint")
    kept = _run(tmp_path, files, rules=["metric-prefix"], baseline=entries)
    assert kept.clean and kept.baselined == 1 and kept.stale_baseline == []
    (tmp_path / PKG / "mod.py").write_text(
        'def f(reg):\n    reg.counter("tddl_good_total")\n')
    fixed = _run(tmp_path, {}, rules=["metric-prefix"], baseline=entries)
    assert fixed.clean and fixed.baselined == 0
    assert len(fixed.stale_baseline) == 1
    bad = {"version": 1, "findings": [
        {"rule": "metric-prefix", "path": "x.py", "message": "m"}]}
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(tmp_path / "bad.json"))


def test_parse_error_is_a_finding_not_a_crash(tmp_path):
    result = _run(tmp_path, {"{pkg}/broken.py": "def f(:\n",
                             "{pkg}/fine.py": "x = 1\n"})
    assert [f.rule for f in result.findings] == ["parse-error"]
    assert result.files_scanned == 2


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


SEEDED = {
    "{pkg}/obs/mod.py": '''\
        import json

        def f(bus, reg, path, payload):
            bus.emit("train_step", step=1)
            reg.counter("bad_total", labels=("tenent",))
            with open(path, "w") as f:
                json.dump(payload, f)
        ''',
    "{pkg}/obs/sentinel.py": "import torch\n",
    "{pkg}/serve/scheduler.py": '''\
        import torch
        from trustworthy_dl_tpu_torch import ops
        from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS

        def decode_tick(self, xs):
            for x in xs:
                pad = torch.tensor([0])
                ops.kernel_library("paged_attention")
            out = _decode_impl(xs)
            return out.cpu(), pad, (DATA_AXIS, None)

        def f(xs=[]):
            return xs
        ''',
}


def test_cli_seeded_violations_exit_nonzero_with_locations(tmp_path,
                                                           capsys):
    _write_tree(tmp_path, SEEDED)
    rc = lint_main(["--root", str(tmp_path), str(tmp_path),
                    "--no-baseline"])
    out = capsys.readouterr().out
    assert rc == 1
    expected = {
        "obs-emit-type": f"{PKG}/obs/mod.py:4",
        "metric-prefix": f"{PKG}/obs/mod.py:5",
        "metric-label-vocab": f"{PKG}/obs/mod.py:5",
        "atomic-write": f"{PKG}/obs/mod.py:6",
        "import-purity": f"{PKG}/obs/sentinel.py:1",
        "recompile-hazard": f"{PKG}/serve/scheduler.py:7",
        "host-sync": f"{PKG}/serve/scheduler.py:10",
        "sharding-registry-only": f"{PKG}/serve/scheduler.py:10",
        "mutable-default": f"{PKG}/serve/scheduler.py:12",
    }
    for rule, location in expected.items():
        assert f"{location}: [{rule}]" in out, (rule, out)
    assert f"{PKG}/serve/scheduler.py:8: [recompile-hazard]" in out


def test_cli_formats_filters_and_exit_codes(tmp_path, capsys):
    _write_tree(tmp_path, {
        "{pkg}/mod.py": 'def f(reg):\n    reg.counter("bad_total")\n'})
    assert lint_main(["--root", str(tmp_path), str(tmp_path),
                      "--no-baseline", "--rules", "obs-emit-type"]) == 0
    capsys.readouterr()
    rc = lint_main(["--root", str(tmp_path), str(tmp_path),
                    "--no-baseline", "--format", "json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and payload["clean"] is False
    assert payload["by_rule"] == {"metric-prefix": 1}
    assert payload["findings"][0]["line"] == 2
    assert lint_main(["--root", str(tmp_path), str(tmp_path),
                      "--rules", "nonsense"]) == 2
    assert "unknown rule" in capsys.readouterr().err
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in all_rules():
        assert rule.name in out
    baseline = tmp_path / "base.json"
    assert lint_main(["--root", str(tmp_path), str(tmp_path),
                      "--write-baseline", "--baseline", str(baseline)]) == 2
    assert not baseline.exists()
    assert "--write-baseline" in capsys.readouterr().err
    assert lint_main(["--root", str(tmp_path), "--write-baseline",
                      "--baseline", str(baseline)]) == 0
    capsys.readouterr()
    assert lint_main(["--root", str(tmp_path), str(tmp_path),
                      "--baseline", str(baseline)]) == 0


# ---------------------------------------------------------------------------
# the port itself: the gate, the baseline, the linter's own purity
# ---------------------------------------------------------------------------


def test_port_is_clean_under_the_committed_baseline():
    """The gate: every rule over ``trustworthy_dl_tpu_torch/`` with the
    committed baseline — no finding, no stale entry."""
    result = run_lint(root=str(REPO))
    assert result.clean, "\n".join(
        f"{f.location}: [{f.rule}] {f.message}" for f in result.findings)
    assert result.stale_baseline == [], result.stale_baseline
    assert result.files_scanned > 100


def test_committed_baseline_is_justified():
    entries = load_baseline(str(REPO / contracts.DEFAULT_BASELINE))
    assert all(len(e["justification"].split()) >= 8 for e in entries)
    assert len(entries) <= 5


def test_the_linter_passes_its_own_import_purity_rule():
    result = run_lint(root=str(REPO), rule_names=["import-purity"],
                      use_baseline=False)
    assert result.clean, [f.as_dict() for f in result.findings]


def test_lint_process_imports_neither_torch_nor_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['lint', '-q']\n"
        "try:\n"
        "    runpy.run_module('trustworthy_dl_tpu_torch.analysis',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert exc.code == 0, exc.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'jaxlib', 'trustworthy_dl_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
