"""The port's detection envelope (``experiments/envelope.py``) against the
JAX package's on the CPU, then JAX's own floors
(``tests/test_envelope.py``) on the port alone.

Parity: one sweep of each package at 4 nodes for each of two target
sets, the default (1, 3) and node 2 alone (gradient poisoning at
intensity 1.0, 8 warm-up and 10 attacked steps, the tiny GPT-2 of
``TINY_GPT`` in the default bf16 compute), the port's trainer given JAX's
initial params for each cell's seed (``models/convert``).  The config,
the clean run and every cell are equal key for key, floats within 1e-5
(every one of them is a count ratio); ``wall_time_s`` and
``run_metadata`` (the platform stamp) are left out.  ``render_table`` is
byte-equal to JAX's.  The attacked node's gradient noise is each
package's own draw: intensity 1.0 gates it from its first attacked step
in both.

Floors, as JAX's: at 8 nodes, gradient poisoning at intensity 0.5 and 1.0
detected at rate 1.0 within 3 steps with family attribution 1.0 and no
false positive, a clean run with none, every run finite, the artifacts
written; ``reset_for_run`` isolates cells.  Then the runner's
``--envelope``: the flags it refuses, against JAX's parser, and what it
hands the sweep, and what ``--serve-envelope`` hands its own.
"""

import json

import jax
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.experiments import envelope as jenv
from trustworthy_dl_tpu.experiments.runner import main as jmain
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.experiments import envelope, \
    render_table, run_detection_envelope
from trustworthy_dl_tpu_torch.experiments.runner import main
from trustworthy_dl_tpu_torch.models import convert

pytestmark = pytest.mark.torchport

PARITY = dict(num_nodes=4, attack_types=["gradient_poisoning"],
              intensities=[1.0], attack_steps=10, make_figure=False)
ATOL = 1e-5
UNSTAMPED = ("wall_time_s", "run_metadata")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


# The default targets, where neither package attributes a node, and node
# 2 alone, where both detect and attribute it: the second holds the
# first-incident choice, latency, attribution and the pre-attack split
# against JAX's on non-empty lists.
TARGET_SETS = {"default": None, "node2": (2,)}


@pytest.fixture(scope="module", params=list(TARGET_SETS))
def parity(request, tmp_path_factory):
    root = tmp_path_factory.mktemp("envelope")
    kw = dict(PARITY, targets=TARGET_SETS[request.param])
    jres = jenv.run_detection_envelope(output_dir=str(root / "jax"), **kw)
    jbundle = jcreate_model("gpt2", **jenv.TINY_GPT)
    initialize = DistributedTrainer.initialize

    def jax_initialize(self, seed=None, params=None):
        # JAX's DistributedTrainer.initialize: the params key is the first
        # half of PRNGKey(seed).
        seed = self.config.seed if seed is None else seed
        key, _ = jax.random.split(jax.random.PRNGKey(seed))
        params = convert.params_from_jax(jax.tree_util.tree_map(
            np.asarray, jbundle.init(key)))
        return initialize(self, seed=seed, params=params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DistributedTrainer, "initialize", jax_initialize)
        res = run_detection_envelope(output_dir=str(root / "port"),
                                     device="cpu", **kw)
    return root, jres, res


def _equal(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _equal(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= ATOL, path
    else:
        assert got == want and type(got) is type(want), path


def test_sweep_matches_jax(parity):
    _, jres, res = parity
    assert list(res) == list(jres)
    for key in jres:
        if key not in UNSTAMPED:
            _equal(res[key], jres[key], key)
    cell = res["cells"][0]
    if cell["targets"] == [1, 3]:
        # The default targets attack 2 of the 4 nodes: the cross-node
        # median then sits between a clean and a poisoned node, the
        # per-node gate attributes neither and the fleet-level surge alarm
        # fires instead, in both packages.
        assert cell["detection_rate"] == 0.0 and cell["latencies"] == []
    else:
        assert cell["targets"] == [2]
        assert cell["detection_rate"] == 1.0 and cell["latencies"]
        assert cell["attributed_types"]
    assert res["clean"]["false_positive_incidents"] == []
    assert res["run_metadata"]["platform"] == "cpu"


def test_table_and_artifacts_match_jax(parity):
    root, jres, res = parity
    assert render_table(res) == jenv.render_table(jres)
    assert render_table(jres) == jenv.render_table(jres)
    assert (root / "port" / "detection_envelope.md").read_bytes() == \
        (root / "jax" / "detection_envelope.md").read_bytes()
    data = json.loads((root / "port" / "detection_envelope.json"
                       ).read_text())
    assert data["cells"] == res["cells"]
    assert not (root / "port" / "detection_envelope.png").exists()


def test_out_of_range_targets_refused(tmp_path):
    for fn in (run_detection_envelope, jenv.run_detection_envelope):
        with pytest.raises(ValueError, match="out of range for num_nodes"):
            fn(output_dir=str(tmp_path / "x"), num_nodes=4, targets=(1, 4))
    assert not (tmp_path / "x").exists()


def test_the_sweep_needs_an_explicit_cpu_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError):
        run_detection_envelope(output_dir=str(tmp_path), num_nodes=4)


# --------------------------------------------------------------------------
# JAX's floors, on the port
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def envelope_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("floors")
    return out, run_detection_envelope(
        output_dir=str(out), attack_types=["gradient_poisoning"],
        intensities=[0.5, 1.0], attack_steps=12, device="cpu")


def test_high_intensity_gradient_poisoning_floor(envelope_results):
    _, results = envelope_results
    assert len(results["cells"]) == 2
    for cell in results["cells"]:
        assert cell["detection_rate"] == 1.0, cell
        assert cell["median_latency_steps"] <= 3, cell
        assert cell["fp_rate"] == 0.0, cell
        assert cell["attribution_accuracy"] == 1.0, cell
        assert cell["finite"], cell


def test_clean_run_has_zero_false_positives(envelope_results):
    _, results = envelope_results
    clean = results["clean"]
    assert clean["fp_rate"] == 0.0, clean
    assert clean["false_positive_incidents"] == []
    assert clean["finite"]


def test_envelope_artifacts_written(envelope_results):
    out, results = envelope_results
    data = json.loads((out / "detection_envelope.json").read_text())
    assert len(data["cells"]) == len(results["cells"])
    table = (out / "detection_envelope.md").read_text()
    assert "gradient poisoning" in table and "100%" in table
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not (out / "detection_envelope.png").exists()
    else:
        assert (out / "detection_envelope.png").exists()


def test_reset_for_run_isolates_cells(tmp_path):
    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker, \
        AttackConfig
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.data import get_dataloader

    config = TrainingConfig(
        model_name="gpt2", dataset_name="openwebtext", batch_size=16,
        num_nodes=8, optimizer="adamw", learning_rate=1e-3,
        checkpoint_interval=10_000, detector_warmup=4, parallelism="data",
        checkpoint_dir=str(tmp_path / "ck"))
    trainer = DistributedTrainer(config, model_overrides=dict(
        envelope.TINY_GPT), device="cpu")
    dl = get_dataloader("openwebtext", batch_size=16, seq_len=16,
                        vocab_size=128, num_examples=16 * 12)
    trainer.reset_for_run(seed=0)
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=1.0, start_step=6))
    attacker.activate_attacks()
    trainer.set_attack_plan(attacker.plan(8))
    trainer.train_epoch(dl, 0)
    assert trainer.attack_history, "attack was not detected"
    assert 2 in trainer.trust_manager.get_compromised_nodes()

    trainer.reset_for_run(seed=1)
    assert trainer.attack_history == []
    assert trainer.global_step == 0
    assert trainer.trust_manager.get_compromised_nodes() == []
    assert trainer.metrics_collector.batch_metrics == []
    trainer.train_epoch(dl, 0)
    losses = [m["loss"] for m in trainer.metrics_collector.batch_metrics]
    assert losses and all(np.isfinite(x) for x in losses)
    assert trainer.attack_history == []


# --------------------------------------------------------------------------
# The runner's --envelope
# --------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--model", "gpt2"], ["--epochs", "3"], ["--attack"],
    ["--name", "x", "--batch-size", "8"], ["--preset", "resnet32_cifar10_clean"],
    ["--config", "c.json", "--dataset", "wikitext", "--parallelism", "data",
     "--steps-per-epoch", "4", "--sweep-thresholds", "0.5"]])
def test_runner_refuses_what_the_sweep_ignores(flags, capsys):
    """Both parsers exit 2 with the same error line (argparse prints the
    usage before it)."""
    errors = []
    for fn in (jmain, main):
        with pytest.raises(SystemExit) as exc:
            fn(["--envelope", *flags])
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[1] == errors[0]
    assert "--envelope does not take" in errors[1]


def test_runner_hands_the_sweep_its_flags(monkeypatch, tmp_path, capsys):
    seen = {}

    def fake(**kwargs):
        seen.update(kwargs)
        return {"cells": [{}, {}], "wall_time_s": 1.5}

    monkeypatch.setattr(envelope, "run_detection_envelope", fake)
    assert main(["--envelope", "--device", "cpu", "--nodes", "4",
                 "--output-dir", str(tmp_path)]) == 0
    assert seen == {"device": "cpu", "output_dir": str(tmp_path),
                    "num_nodes": 4}
    assert "Detection envelope: 2 cells in 1.5s" in capsys.readouterr().out
    # --serve-envelope hands its sweep the device and the directory.
    from trustworthy_dl_tpu_torch.experiments import serve_envelope

    seen.clear()

    def fake_serve(**kwargs):
        seen.update(kwargs)
        return {"cells": [{"detected_by": "vote"}, {"detected_by": "none"}],
                "wall_time_s": 2.5}

    monkeypatch.setattr(serve_envelope, "run_serve_envelope", fake_serve)
    assert main(["--serve-envelope", "--device", "cpu", "--output-dir",
                 str(tmp_path)]) == 0
    assert seen == {"device": "cpu", "output_dir": str(tmp_path)}
    assert "Serve envelope: 2 cells (1 detected) in 2.5s" in \
        capsys.readouterr().out
