"""The port's example scripts (``examples/torch_*.py``) run to their end
on the CPU, each in a fresh process with ``--device cpu`` and a time
limit of its own, and end on the line that says they did what they show:
the drill's predicted recovery counts, the two decodes, the validation
metrics after the attacked run, the full fleet training again after an
eviction and a readmission."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]

#: script -> (a line the output must hold, the start of its last line).
EXAMPLES = {
    "torch_train_under_attack.py": ("* nodes [1, 3] are compromised",
                                    "validation: {'loss': "),
    "torch_generate_text.py": ("greedy:    [1, 2, 3, 4, ", "top-k/p:   [1, "),
    "torch_recovery_lifecycle.py": ("node 5 readmitted at coordinate 7",
                                    "full fleet training again: epoch "),
    "torch_chaos_drill.py": ("rollback restored from step(s): [5]",
                             "drill survived with the plan-predicted "
                             "recovery counts"),
}


@pytest.mark.parametrize("script", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(script, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), TMPDIR=str(tmp_path))
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), "--device", "cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    holds, last = EXAMPLES[script]
    assert any(line.startswith(holds) for line in lines), proc.stdout[-4000:]
    assert lines[-1].startswith(last), lines[-1]
