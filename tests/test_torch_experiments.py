"""The port's experiment runner against the JAX package's on the CPU.

One module-scoped run of each runner on ``tests/test_experiments.py``'s
configuration (tiny GPT-2: 2 layers, 32 wide, 4 heads, vocab 128, T 16;
4 nodes, 5 epochs of 8 steps, gradient poisoning of node 2 from epoch 2),
the port's trainer given the JAX trainer's initial params
(``models/convert``); the two loaders are the same bit for bit.  Both
models compute in f32, where the training contract's tolerances are
defined (bf16 products on the CPU round differently in XLA and in torch:
the first epoch's loss already differs by 2.2e-5 there).

Equal: the incidents (node, step, type), the reassignments' source and
target, ``detection_quality``, each epoch's node statuses, the step count,
the CSV header, ``PRESETS``, the ``obs_report`` keys (less JAX's
analyzed-FLOPs blocks) and the ``obs/`` artifacts (less JAX's perf
ledger).  Within the training contract's 1e-5:
epoch and validation losses, each epoch's trust scores, each step's CSV
loss and trust, the final system trust and the predicted reliability.
The attacked node's gradient noise is each package's own draw (JAX's
``jax.random``, the port's ``torch.Generator``), but node 2 is gated from
its first attacked step and its poisoned leaf norms clamp its gradient
consistency at 1, so its trust holds the same 1e-5.  Then the runner's
own contract: the artifacts, the refusal of an unported preset and the
set-up of the vision presets, ``main`` with ``--device cpu``, and the
``MetricsCollector`` and ``predict_reliability`` against the JAX
package's on the same inputs.
"""

import copy
import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.core.config import ExperimentConfig as JConfig
from trustworthy_dl_tpu.experiments.runner import PRESETS as JPRESETS
from trustworthy_dl_tpu.experiments.runner import \
    ExperimentRunner as JRunner
from trustworthy_dl_tpu_torch.core.config import ExperimentConfig
from trustworthy_dl_tpu_torch.experiments import PRESETS, \
    ExperimentRunner, preset_config
from trustworthy_dl_tpu_torch.models import convert

pytestmark = pytest.mark.torchport

TINY_GPT = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128,
                n_positions=32, seq_len=16)
TINY_DATA = dict(seq_len=16, vocab_size=128, num_examples=64)
CONFIG = dict(
    experiment_name="tiny_gpt_attack", model_name="gpt2",
    dataset_name="openwebtext", num_nodes=4, num_epochs=5, batch_size=8,
    learning_rate=3e-3, attack_enabled=True, attack_start_epoch=2,
    attack_intensity=0.5, target_nodes=[2],
    attack_types=["gradient_poisoning"], steps_per_epoch=8,
)
ATOL = 1e-5
ATTACKED = 2


def _first_batch(loader):
    return next(iter(copy.deepcopy(loader)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp")
    jrunner = JRunner(JConfig(output_dir=str(root / "jax"), **CONFIG),
                      model_overrides=dict(TINY_GPT, dtype=jnp.float32),
                      data_overrides=dict(TINY_DATA))
    jrunner.setup_experiment()
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jax.device_get(jrunner.trainer.state
                                                    .params))
    jfirst = _first_batch(jrunner.train_loader)
    jresults = jrunner.run_experiment()

    runner = ExperimentRunner(
        ExperimentConfig(output_dir=str(root / "port"), **CONFIG),
        model_overrides=dict(TINY_GPT, dtype=torch.float32),
        data_overrides=dict(TINY_DATA),
        device="cpu")
    runner.setup_experiment()
    runner.trainer.initialize(params=convert.params_from_jax(jparams))
    first = _first_batch(runner.train_loader)
    results = runner.run_experiment()
    return dict(jrunner=jrunner, jresults=jresults, jfirst=jfirst,
                runner=runner, results=results, first=first)


def _csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_same_data_and_decisions_as_jax(runs):
    for key in ("input", "target"):
        np.testing.assert_array_equal(runs["first"][key],
                                      runs["jfirst"][key])
    res, jres = runs["results"], runs["jresults"]

    def incidents(history):
        return [(r["node_id"], r["step"], r["attack_type"])
                for r in history]

    assert incidents(res["attack_history"]) == \
        incidents(jres["attack_history"])
    assert [r["node_id"] for r in res["attack_history"]] == [ATTACKED]
    assert [(r["from_node"], r["to_node"])
            for r in res["reassignment_history"]] == \
        [(r["from_node"], r["to_node"]) for r in jres["reassignment_history"]]
    summary, jsummary = res["experiment_summary"], jres["experiment_summary"]
    assert summary["detection_quality"] == jsummary["detection_quality"]
    assert summary["detection_quality"]["recall"] == 1.0
    for key in ("total_steps", "total_epochs", "compromised_nodes",
                "total_attacks_detected", "total_reassignments",
                "total_evictions", "total_readmissions", "final_live_nodes",
                "recovered_nodes"):
        assert summary[key] == jsummary[key], key
    assert summary["total_steps"] == 5 * 8
    assert [r["node_statuses"] for r in res["epoch_records"]] == \
        [r["node_statuses"] for r in jres["epoch_records"]]
    # Both runners carry a telemetry session with a cost ledger: the
    # same report blocks, the analyzed-FLOPs MFU from the counted step.
    report, jreport = res["obs_report"], jres["obs_report"]
    assert report["num_steps"] == jreport["num_steps"] == 5 * 8
    assert set(report) == set(jreport)
    assert report["mfu_analyzed"]["flops_per_step"] == \
        report["cost_ledger"]["train_step"]["flops"] > 0
    assert set(report["phases"]) == set(jreport["phases"])
    assert report["mfu"].keys() == jreport["mfu"].keys()


def test_losses_and_trust_within_the_training_contract(runs):
    res, jres = runs["results"], runs["jresults"]
    recs, jrecs = res["epoch_records"], jres["epoch_records"]
    assert len(recs) == len(jrecs) == 5
    for rec, jrec in zip(recs, jrecs):
        for key in ("training_loss", "validation_loss", "system_trust"):
            assert abs(rec[key] - jrec[key]) <= ATOL, (key, rec["epoch"])
        for node in range(4):
            assert abs(rec["trust_scores"][node]
                       - jrec["trust_scores"][node]) <= ATOL, (
                node, rec["epoch"])
    summary, jsummary = res["experiment_summary"], jres["experiment_summary"]
    for key in ("final_system_trust", "average_loss", "final_loss"):
        assert abs(summary[key] - jsummary[key]) <= ATOL, key
    pred = res["training_stats"]["predicted_reliability"]
    jpred = jres["training_stats"]["predicted_reliability"]
    for node in range(4):
        assert abs(pred[node] - jpred[node]) <= ATOL, node


def test_csv_matches_jax_step_by_step(runs):
    header, rows = _csv(runs["runner"].output_dir / "training_metrics.csv")
    jheader, jrows = _csv(runs["jrunner"].output_dir /
                          "training_metrics.csv")
    assert header == jheader
    assert [f"trust_node_{i}" for i in range(4)] == header[4:]
    assert len(rows) == len(jrows) == 40
    for row, jrow in zip(rows, jrows):
        assert row[:2] == jrow[:2]                     # step, epoch
        assert abs(float(row[2]) - float(jrow[2])) <= ATOL, row[0]
        for node in range(4):
            assert abs(float(row[4 + node]) - float(jrow[4 + node])) <= \
                ATOL, (row[0], node)
    assert float(rows[-1][4 + ATTACKED]) < 0.3


def test_artifact_contract(runs):
    runner = runs["runner"]
    expected = ["experiment_results.json", "training_metrics.csv",
                "experiment_report.md", "intermediate_epoch_4.json"]
    try:
        import matplotlib  # noqa: F401
        expected += ["training_loss.png", "trust_evolution.png",
                     "attack_impact.png", "system_metrics.png"]
    except ImportError:
        pass
    for name in expected:
        path = runner.output_dir / name
        assert path.exists() and path.stat().st_size > 0, name
    obs = sorted(p.name for p in (runner.output_dir / "obs").iterdir())
    jobs = sorted(p.name for p in (runs["jrunner"].output_dir /
                                   "obs").iterdir())
    assert obs == jobs
    assert {"trace.jsonl", "metrics_snapshot.json", "metrics.prom",
            "obs_report.json"} <= set(obs)
    with open(runner.output_dir / "experiment_results.json") as f:
        loaded = json.load(f)
    assert loaded["experiment_config"]["experiment_name"] == \
        "tiny_gpt_attack"
    from trustworthy_dl_tpu_torch.obs.meta import RUN_METADATA_KEYS, \
        run_metadata

    assert set(RUN_METADATA_KEYS) <= set(loaded["run_metadata"])
    assert loaded["run_metadata"]["torch_version"] == torch.__version__
    assert loaded["run_metadata"]["platform"] == "cpu"
    assert run_metadata(host_only=True)["platform"] == "unprobed"
    assert loaded["experiment_summary"]["total_attacks_detected"] == 1
    text = (runner.output_dir / "experiment_report.md").read_text()
    assert "detection precision: 1.00 / recall: 1.00" in text
    assert "tiny_gpt_attack" in text
    # The CPU has no device memory to report; the card does.
    assert "device_memory_utilization" not in \
        runs["results"]["epoch_records"][-1]["system_metrics"]


def test_presets_equal_jax_and_unported_ones_refuse(tmp_path):
    assert PRESETS == JPRESETS
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExperimentRunner(preset_config("gpt2_medium_reassignment",
                                       output_dir=str(tmp_path)))
    # The vision presets set up (they run in tests/test_torch_vision.py).
    for name, model in (("resnet32_cifar10_clean", "resnet32"),
                        ("vgg16_cifar10_poisoning", "vgg16"),
                        ("resnet101_byzantine", "resnet101")):
        runner = ExperimentRunner(preset_config(
            name, num_epochs=1, batch_size=8, output_dir=str(tmp_path)),
            model_overrides=dict(image_shape=(8, 8, 3)),
            data_overrides=dict(image_size=8, num_examples=8),
            device="cpu")
        if model == "resnet101":
            runner.model_overrides.update(stage_sizes=(1, 1, 1, 1),
                                          widths=(4, 4, 4, 4), stem_width=8)
        runner.setup_experiment()
        assert runner.trainer.model.kind == "vision"
        assert runner.trainer.model.name == model
        assert runner.trainer.config.num_nodes == 8
        batch = next(iter(runner.train_loader))
        assert batch["input"].shape == (8, 8, 8, 3)
    # gpt2_transient_recovery runs (test_transient_recovery_preset_...).
    # The pipeline preset's 8 stages do not divide GPT-2 small's 12
    # layers: refused at initialisation, as in JAX (narrow widths here).
    runner = ExperimentRunner(preset_config(
        "gpt2_small_pipeline_clean", output_dir=str(tmp_path)),
        model_overrides=dict(n_embd=32, n_head=4, vocab_size=128,
                             n_positions=32),
        data_overrides=dict(seq_len=16, num_examples=32), device="cpu")
    with pytest.raises(ValueError, match="12 layers not divisible by 8"):
        runner.setup_experiment()
    cfg = preset_config("gpt2_medium_reassignment", num_epochs=1)
    assert cfg.model_name == "gpt2-medium" and cfg.attack_enabled


def test_transient_recovery_preset_matches_jax(tmp_path):
    """``gpt2_transient_recovery`` at tiny width, as JAX's
    ``tests/test_experiments.py`` runs it (8 nodes x 2 sequences, 5 epochs
    of 6 steps, node 5 poisoned in epoch 1, readmission after 8 steps,
    detector warm-up 4), both packages in f32 from the same params and
    without the prefetch thread (the re-sized loader's step count
    otherwise follows the thread's timing): the eviction, the readmission
    and every decision equal, losses and trust within the contract."""
    from trustworthy_dl_tpu.experiments.runner import \
        preset_config as jpreset_config

    kw = dict(experiment_name="tiny_recovery", num_epochs=5, batch_size=16,
              learning_rate=3e-3, steps_per_epoch=6, attack_start_epoch=1,
              attack_end_epoch=2, readmit_after_steps=8)
    data = dict(seq_len=16, vocab_size=128, num_examples=96)
    knobs = dict(detector_warmup=4, prefetch_depth=0)
    jrunner = JRunner(jpreset_config("gpt2_transient_recovery",
                                     output_dir=str(tmp_path / "jax"), **kw),
                      model_overrides=dict(TINY_GPT, dtype=jnp.float32),
                      data_overrides=dict(data))
    jrunner.training_config = dataclasses.replace(jrunner.training_config,
                                                  **knobs)
    jrunner.setup_experiment()
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jrunner.trainer.state.params))
    jres = jrunner.run_experiment()

    runner = ExperimentRunner(
        preset_config("gpt2_transient_recovery",
                      output_dir=str(tmp_path / "port"), **kw),
        model_overrides=dict(TINY_GPT, dtype=torch.float32),
        data_overrides=dict(data), device="cpu")
    runner.training_config = dataclasses.replace(runner.training_config,
                                                 **knobs)
    runner.setup_experiment()
    runner.trainer.initialize(params=convert.params_from_jax(jparams))
    res = runner.run_experiment()

    summary, jsummary = res["experiment_summary"], jres["experiment_summary"]
    for key in ("total_steps", "total_evictions", "total_readmissions",
                "final_live_nodes", "recovered_nodes", "compromised_nodes",
                "total_attacks_detected", "detection_quality"):
        assert summary[key] == jsummary[key], key
    assert summary["total_evictions"] >= 1
    assert summary["total_readmissions"] >= 1
    assert summary["final_live_nodes"] == 8
    assert summary["recovered_nodes"] == [5]
    live = [r["live_nodes"] for r in res["epoch_records"]]
    assert live == [r["live_nodes"] for r in jres["epoch_records"]]
    assert min(live) == 7 and live[-1] == 8

    def decisions(history):
        return [{k: v for k, v in r.items()
                 if k in ("evicted_nodes", "surviving_nodes",
                          "readmitted_nodes", "all_nodes", "step")}
                for r in history]

    assert decisions(res["reassignment_history"]) == \
        decisions(jres["reassignment_history"])
    assert [(r["node_id"], r["step"]) for r in res["attack_history"]] == \
        [(r["node_id"], r["step"]) for r in jres["attack_history"]]
    for rec, jrec in zip(res["epoch_records"], jres["epoch_records"],
                         strict=True):
        for key in ("training_loss", "validation_loss", "system_trust"):
            assert abs(rec[key] - jrec[key]) <= ATOL, (key, rec["epoch"])
    assert (runner.output_dir / "topology_timeline.png").exists() == \
        (jrunner.output_dir / "topology_timeline.png").exists()


def test_main_runs_on_the_cpu(tmp_path, capsys):
    from trustworthy_dl_tpu_torch.cli import main as cli_main
    from trustworthy_dl_tpu_torch.experiments.runner import main

    rc = main(["--name", "cli_smoke", "--nodes", "4", "--epochs", "1",
               "--batch-size", "8", "--steps-per-epoch", "4", "--attack",
               "--output-dir", str(tmp_path), "--device", "cpu"],
              model_overrides=dict(TINY_GPT), data_overrides=dict(
                  seq_len=16, vocab_size=128))
    assert rc == 0
    out = tmp_path / "cli_smoke"
    assert (out / "experiment_results.json").exists()
    assert (out / "experiment_report.md").exists()
    assert "Experiment completed: cli_smoke" in capsys.readouterr().out
    # --envelope runs (tests/test_torch_envelope.py); --serve-envelope
    # writes its JSON and table (one cell of the grid here).
    from trustworthy_dl_tpu_torch.experiments import serve_envelope

    real = serve_envelope.run_serve_envelope
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve_envelope, "run_serve_envelope",
                   lambda **kw: real(strengths=(0.15,), thresholds=(24.0,),
                                     vote_ks=(0,), make_figure=False, **kw))
        assert cli_main(["experiment", "--serve-envelope", "--device",
                         "cpu", "--output-dir", str(tmp_path / "se")]) == 0
    assert "Serve envelope: 1 cells (0 detected)" in capsys.readouterr().out
    assert (tmp_path / "se" / "serve_envelope.json").exists()
    assert (tmp_path / "se" / "serve_envelope.md").exists()


def test_load_experiment_config_reads_the_readme_schema(tmp_path):
    from trustworthy_dl_tpu.core.config import \
        load_experiment_config as jload
    from trustworthy_dl_tpu_torch.core.config import load_experiment_config

    path = tmp_path / "exp.json"
    path.write_text(json.dumps({
        "model": {"name": "gpt2", "size": "medium"},
        "training": {"batch_size": 16, "num_epochs": 3},
        "distributed": {"num_nodes": 8},
        "security": {"trust_threshold": 0.6},
        "attack_intensity": 0.9, "unknown_key": 1}))
    mine = load_experiment_config(str(path), steps_per_epoch=7,
                                  experiment_name=None)
    ref = jload(str(path), steps_per_epoch=7, experiment_name=None)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.model_name == "gpt2-medium" and mine.num_nodes == 8
    assert dataclasses.asdict(mine.to_training_config()).items() >= {
        "num_nodes": 8, "trust_threshold": 0.6, "batch_size": 16}.items()


def test_metrics_collector_matches_jax():
    from trustworthy_dl_tpu.obs.registry import MetricsRegistry
    from trustworthy_dl_tpu.utils.metrics import \
        MetricsCollector as JCollector
    from trustworthy_dl_tpu_torch.utils.metrics import MetricsCollector

    rng = np.random.default_rng(0)
    mine, ref = MetricsCollector(max_records=5), JCollector(
        max_records=5, registry=MetricsRegistry())
    for c in (mine, ref):
        assert c.get_summary() == {"num_batches": 0, "num_epochs": 0}
        assert c.step_time_stats() == {}
    for step in range(8):
        record = {"loss": float(rng.random()), "step": step, "epoch": 0,
                  "timestamp": float(step),
                  "trust_scores": {i: float(rng.random()) for i in range(4)}}
        mine.collect_batch_metrics(record)
        ref.collect_batch_metrics(record)
    mine.collect_epoch_metrics({"epoch": 0, "avg_loss": 1.0,
                                "timestamp": 1.0})
    ref.collect_epoch_metrics({"epoch": 0, "avg_loss": 1.0,
                               "timestamp": 1.0})
    assert mine.batch_metrics == ref.batch_metrics
    assert len(mine.batch_metrics) == 5
    assert mine.epoch_metrics == ref.epoch_metrics
    assert mine.get_summary() == ref.get_summary()
    times = [0.5, 0.25, 1.0, 0.125]
    for c in (mine, ref):
        c._step_times.extend(times)
    assert mine.step_time_stats() == ref.step_time_stats()
    assert mine.get_summary() == ref.get_summary()
    for c in (mine, ref):
        c.tick()
        c.tick()
        c.flush()
        c.close()
        c.reset()
        assert c.get_summary() == {"num_batches": 0, "num_epochs": 0}


@pytest.mark.parametrize("seed", range(4))
def test_predict_reliability_matches_jax(seed):
    from trustworthy_dl_tpu.trust.state import \
        predict_reliability as jpredict
    from trustworthy_dl_tpu_torch.trust.state import predict_reliability

    rng = np.random.default_rng(seed)
    n, window = 7, 10
    counts = rng.integers(1, window + 1, n)
    counts[0], counts[1] = 4, 5           # either side of the trend floor
    hist = np.zeros((n, window), np.float32)
    for i, c in enumerate(counts):
        hist[i, window - c:] = np.clip(
            rng.random() + np.cumsum(rng.normal(0, 0.1, c)), 0, 1)
    for horizon in (1, 10):
        want = np.asarray(jpredict(jnp.asarray(hist), jnp.asarray(counts),
                                   horizon=horizon))
        got = predict_reliability(torch.from_numpy(hist),
                                  torch.from_numpy(counts),
                                  horizon=horizon).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
