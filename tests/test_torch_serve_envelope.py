"""The port's serve-side detection envelope
(``experiments/serve_envelope.py``) against the JAX package's on the CPU
in f32.

Parity: one reduced sweep of each package (strengths 0.15 and 0.9,
threshold 12.0, vote K 0 and 2; 3 replicas, 24 requests, 4 slots, max_seq
48; JAX's tiny GPT-2 of ``TINY_GPT``), the port given JAX's initial weights
(``models/convert``).  Every cell is equal key for key, ``wall_time_s``
aside; the config is JAX's plus the port's ``dtype``; ``render_table`` is
byte-equal to JAX's on the same results.  The sweep shows the floor (0.15:
undetected, no suspicion) and the ladder's tier (0.9), with no clean
replica quarantined, and one cell run twice gives the same record.

Then the entry points: ``runner --serve-envelope --device cpu`` and ``cli
experiment --serve-envelope --device cpu`` write the JSON and the table,
and without CUDA the sweep and both commands raise unless given the CPU.
"""

import json

import jax
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.experiments import serve_envelope as jenv
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.experiments import serve_envelope as env
from trustworthy_dl_tpu_torch.experiments.runner import main
from trustworthy_dl_tpu_torch.models import convert

pytestmark = pytest.mark.torchport

GRID = dict(strengths=(0.15, 0.9), thresholds=(12.0,), vote_ks=(0, 2),
            make_figure=False)


def _jax_params(cfg, seed, device):
    """JAX's ``run_serve_envelope`` weights: ``gpt2.init_params`` at
    ``PRNGKey(seed)`` in f32, carried across."""
    import jax.numpy as jnp

    jcfg = jgpt2.GPT2Config(dtype=jnp.float32, **jenv.TINY_GPT)
    return convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jgpt2.init_params(jax.random.PRNGKey(seed), jcfg)))


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("serve_envelope")
    jres = jenv.run_serve_envelope(output_dir=str(root / "jax"), **GRID)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(env, "_init_params", _jax_params)
        res = env.run_serve_envelope(output_dir=str(root / "port"),
                                     device="cpu", **GRID)
        again = env._run_cell(
            env._init_params(None, 0, "cpu"), _tiny_cfg(), seed=0,
            strength=0.9, threshold=12.0, vote_k=2, num_replicas=3,
            num_requests=24, max_slots=4, max_seq=48, fleet_overrides=None,
            adversary_overrides=None, device=torch.device("cpu"))
    return root, jres, res, again


def _tiny_cfg():
    from trustworthy_dl_tpu_torch.models import gpt2

    return gpt2.GPT2Config(dtype=torch.float32, **env.TINY_GPT)


def _strip(cell):
    return {k: v for k, v in cell.items() if k != "wall_time_s"}


def test_sweep_cells_equal_jax(sweeps):
    _, jres, res, _ = sweeps
    assert list(res) == list(jres)
    assert [_strip(c) for c in res["cells"]] == \
        [_strip(c) for c in jres["cells"]]
    config = dict(res["config"])
    assert config.pop("dtype") == "float32"
    assert config == jres["config"]
    assert res["run_metadata"]["platform"] == "cpu"
    by_key = {(c["vote_k"], c["strength"]): c for c in res["cells"]}
    assert by_key[(0, 0.15)]["detected_by"] == "none"
    assert by_key[(0, 0.15)]["suspicions"] == 0
    assert by_key[(0, 0.9)]["detected_by"] == "ladder"
    assert by_key[(2, 0.9)]["detected_by"] == "ladder"
    assert all(c["completed"] == c["requests"] == 24
               and c["clean_replica_quarantines"] == 0
               for c in res["cells"])
    assert all(c["detected_by"] != "vote" for c in res["cells"]
               if c["vote_k"] == 0)


def test_render_table_and_artifacts_equal_jax(sweeps):
    root, jres, res, _ = sweeps
    assert env.render_table(res) == jenv.render_table(jres)
    assert env.render_table(jres) == jenv.render_table(jres)
    table = (root / "port" / "serve_envelope.md").read_text()
    assert table == (root / "jax" / "serve_envelope.md").read_text()
    blob = json.loads((root / "port" / "serve_envelope.json").read_text())
    assert blob["config"]["vote_ks"] == [0, 2] and len(blob["cells"]) == 4


def test_a_cell_run_twice_gives_the_same_record(sweeps):
    _, _, res, again = sweeps
    cell = next(c for c in res["cells"]
                if (c["vote_k"], c["strength"]) == (2, 0.9))
    assert _strip(again) == _strip(cell)


@pytest.mark.parametrize("entry", ["runner", "cli"])
def test_serve_envelope_command_writes_json_and_table(entry, tmp_path,
                                                      monkeypatch, capsys):
    """Both commands hand the sweep ``--device`` and ``--output-dir`` and
    write its artifacts (a one-cell grid here)."""
    torch.set_num_threads(1)
    seen = {}
    real = env.run_serve_envelope

    def one_cell(**kwargs):
        seen.update(kwargs)
        return real(strengths=(0.9,), thresholds=(12.0,), vote_ks=(2,),
                    make_figure=False, **kwargs)

    monkeypatch.setattr(env, "run_serve_envelope", one_cell)
    argv = ["--serve-envelope", "--device", "cpu", "--output-dir",
            str(tmp_path)]
    if entry == "runner":
        assert main(argv) == 0
    else:
        assert cli.main(["experiment", *argv]) == 0
    assert seen == {"device": "cpu", "output_dir": str(tmp_path)}
    assert "Serve envelope: 1 cells (1 detected) in" in \
        capsys.readouterr().out
    blob = json.loads((tmp_path / "serve_envelope.json").read_text())
    assert blob["cells"][0]["detected_by"] == "ladder"
    assert "LADDER" in (tmp_path / "serve_envelope.md").read_text()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host "
                    "without CUDA")
def test_envelope_defaults_to_cuda_and_raises_without_it(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        env.run_serve_envelope(output_dir=str(tmp_path), **GRID)
    for run in (lambda: main(["--serve-envelope", "--output-dir",
                              str(tmp_path)]),
                lambda: cli.main(["experiment", "--serve-envelope",
                                  "--output-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run()
