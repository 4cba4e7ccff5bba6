"""The port's pipeline schedule study (``experiments/pipeline_study.py``)
against the JAX package's, on the CPU, over a 2 x 2 grid (S in {2, 4},
M in {2, 4}, batch 8, one timed step a cell): the cells' keys, S, M,
batch and bubble fraction equal; each package's ``render_study`` gives
the same rows for the same results.  Step times are not compared, nor
``temp_bytes``: JAX's is XLA's temporary allocation of the compiled step
(this CPU backend reports one), the port's the step's peak allocation
above its state on a card, 0 on the CPU.
"""

import json

import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.experiments import pipeline_study as jstudy
from trustworthy_dl_tpu_torch.experiments import pipeline_study as study

pytestmark = pytest.mark.torchport

GRID = dict(stage_counts=(2, 4), microbatches=(2, 4), batch=8, steps=1)
# vocab 263 and 16 positions keep these programs apart from other files'.
NARROW = dict(vocab_size=263, n_positions=16, seq_len=16)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("study")
    torch.set_num_threads(1)
    jres = jstudy.run_pipeline_study(output_dir=str(root / "j"),
                                     model_overrides=NARROW, **GRID)
    res = study.run_pipeline_study(output_dir=str(root / "t"),
                                   model_overrides=dict(
                                       NARROW, dtype=torch.float32),
                                   device="cpu", **GRID)
    return jres, res, root


def test_cells_match_jax(results):
    jres, res, _ = results
    assert len(res["cells"]) == len(jres["cells"]) == 4
    for cell, jcell in zip(res["cells"], jres["cells"]):
        assert sorted(cell) == sorted(jcell)
        for key in ("num_stages", "num_microbatches", "batch",
                    "bubble_fraction"):
            assert cell[key] == jcell[key], key
        assert cell["temp_bytes"] == 0 and jcell["temp_bytes"] >= 0
        assert np.isfinite(cell["step_time_s"]) and cell["step_time_s"] > 0
    assert sorted(res) == sorted(jres)
    assert res["config"]["stage_counts"] == list(GRID["stage_counts"])


def test_render_study_matches_jax(results):
    jres, res, root = results
    for r in (jres, res):
        assert study.render_study(r) == jstudy.render_study(r)
    table = (root / "t" / "pipeline_schedule_study.md").read_text()
    assert table == study.render_study(res)
    assert table.splitlines()[0] == jstudy.render_study(
        jres).splitlines()[0]
    saved = json.loads((root / "t" / "pipeline_schedule_study.json")
                       .read_text())
    assert [c["num_microbatches"] for c in saved["cells"]] == [2, 4, 2, 4]
