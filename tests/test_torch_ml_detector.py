"""The host detector and the ML tier against the JAX package on the CPU.

* The statistic batteries (``detect/stats.py``): ``tensor_statistics``
  (exact and Gaussian order statistics; even and odd lengths, where an
  even count's median is the mean of the two middle values),
  ``tensor_statistics_sampled`` (past its sort cap) and
  ``gradient_statistics`` (past ``max_cosine_pairs_tensors``) within
  1e-6 relative (plus 1e-6 of the tensor's scale for stats that sit near
  zero) of JAX's in f32, skewness and kurtosis within 1e-5 absolute
  (ratios of f32 moment sums that two summation orders round apart by
  up to 9e-6 on 132 values).
* The host :class:`AttackDetector`, every public method beside JAX's on
  the same inputs (``tests/test_detector.py``'s drives): verdicts, counts,
  attack types and the exported record equal, baselines within 1e-6
  relative; the ML tier on identical histories: the same fitted nodes,
  verdicts and ``decision_function`` values, bit for bit (the same
  scikit-learn on the same f64 matrices).
* One trainer-level run of both packages: a narrow ResNet-32 structure,
  4 nodes, 2 epochs of 26 steps (52 samples a node, past the tier's 50),
  gradient poisoning of node 2 from step 8, f32 compute, the port on the
  JAX trainer's converted weights, SGD at 3e-2 (Adam at 3e-3 turns the
  packages' 1e-6 relative gradient differences into 1e-2 loss
  differences within 50 steps on this model: its update amplifies
  near-zero gradients, and GroupNorm over 2x2 maps amplifies again;
  one step's gradients agree within 2e-6 relative).  Incidents,
  statuses and ``ml_flags`` equal; every step's loss and trust within
  1e-5.  The attacked node's
  gradient noise is each package's own draw; it is gated from its first
  attacked step, so the clean nodes' histories stay within float noise
  of JAX's.  With ``ml_detectors=False``, and with scikit-learn made
  unimportable, the tier is off in both packages.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.data.loader import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.detect import detector as jdet
from trustworthy_dl_tpu.detect import stats as jst
from trustworthy_dl_tpu.engine import trainer as jtrainer_mod
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data.loader import get_dataloader
from trustworthy_dl_tpu_torch.detect import detector as det
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.engine import trainer as trainer_mod
from trustworthy_dl_tpu_torch.models import convert

pytestmark = pytest.mark.torchport

RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


#: The dimensionless shape columns, each a ratio of f32 moment sums: a
#: few ulps of m4 and std move kurtosis + 3 by ~20 ulps.
SHAPE = [st.STAT_INDEX["skewness"], st.STAT_INDEX["kurtosis"]]
SHAPE_ATOL = 1e-5


def _stats_close(got, want, scale):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rest = [i for i in range(len(got)) if i not in SHAPE]
    np.testing.assert_allclose(got[rest], want[rest], rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(got[SHAPE], want[SHAPE], rtol=0,
                               atol=SHAPE_ATOL)


# ---------------------------------------------------------------------------
# (a) The batteries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1000, 1001, 2])
@pytest.mark.parametrize("exact", [True, False])
def test_tensor_statistics_match_jax(n, exact):
    x = np.random.default_rng(n).normal(0.5, 2.0, n).astype(np.float32)
    got = st.tensor_statistics(torch.from_numpy(x), exact)
    want = jst.tensor_statistics(jnp.asarray(x), exact)
    _stats_close(got, want, float(np.abs(x).max()))
    if exact:
        # jnp.median: an even count averages the two middle values.
        assert float(got[st.STAT_INDEX["median"]]) == pytest.approx(
            float(np.median(x)), rel=RTOL)
        assert float(got[st.STAT_INDEX["percentile_75"]]) == pytest.approx(
            float(np.percentile(x, 75)), rel=RTOL)
    # Constant input: std 0, skew 0, kurtosis -3.
    const = st.tensor_statistics(torch.full((8,), 3.0), exact)
    _stats_close(const, jst.tensor_statistics(jnp.full((8,), 3.0), exact),
                 3.0)


@pytest.mark.parametrize("n", [5000, 70001])
def test_sampled_statistics_match_jax(n):
    x = np.random.default_rng(n).normal(-0.2, 1.5, n).astype(np.float32)
    got = st.tensor_statistics_sampled(torch.from_numpy(x), max_sort=4096)
    want = jst.tensor_statistics_sampled(jnp.asarray(x), max_sort=4096)
    _stats_close(got, want, float(np.abs(x).max()))


@pytest.mark.parametrize("k", [1, 3, 11])
def test_gradient_statistics_match_jax(k):
    rng = np.random.default_rng(k)
    # Equal sizes: the pairwise cosine multiplies tensors elementwise.
    grads = [rng.normal(0.01 * i, 0.1, (4, 3)).astype(np.float32)
             for i in range(k)]
    got = st.gradient_statistics([torch.from_numpy(g) for g in grads])
    want = jst.gradient_statistics([jnp.asarray(g) for g in grads])
    assert got.shape == (st.NUM_GRADIENT_STATS,)
    _stats_close(got, want, max(float(np.abs(g).max()) for g in grads))
    assert float(got[st.STAT_INDEX["num_gradients"]]) == k
    # Past max_cosine_pairs_tensors the pairwise set is the first few.
    capped = st.gradient_statistics([torch.from_numpy(g) for g in grads],
                                    max_cosine_pairs_tensors=2)
    _stats_close(capped, jst.gradient_statistics(
        [jnp.asarray(g) for g in grads], max_cosine_pairs_tensors=2), 1.0)
    # A parameter tree flattens in sorted-key order, as jax.tree_util's.
    tree = {"b": torch.from_numpy(grads[0]),
            "a": [torch.from_numpy(g) for g in grads[1:]]}
    jtree = {"b": jnp.asarray(grads[0]),
             "a": [jnp.asarray(g) for g in grads[1:]]}
    _stats_close(st.gradient_statistics(tree),
                 jst.gradient_statistics(jtree), 1.0)
    assert not st.gradient_statistics([]).any()


def test_padded_statistics_and_backdoor_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 0.5, (4, 9)).astype(np.float32)
    _stats_close(st.padded_tensor_statistics(torch.from_numpy(x)),
                 jst.padded_tensor_statistics(jnp.asarray(x)), 2.0)
    for shift in (0.0, 8.0):
        m = rng.normal(0, 1, (6, 5)).astype(np.float32)
        e = (m + shift * rng.normal(0, 1, (6, 5))).astype(np.float32)
        assert bool(st.detect_backdoor(torch.from_numpy(m),
                                       torch.from_numpy(e))) == \
            bool(jst.detect_backdoor(jnp.asarray(m), jnp.asarray(e)))


# ---------------------------------------------------------------------------
# (b) The host API
# ---------------------------------------------------------------------------


def _pair(**kw):
    return det.AttackDetector(device="cpu", **kw), jdet.AttackDetector(**kw)


def test_host_detector_end_to_end_matches_jax():
    ours, theirs = _pair()
    rng = np.random.default_rng(7)
    for step in range(15):
        grads = [rng.normal(0, 0.1, size=(16,)).astype(np.float32)
                 for _ in range(3)]
        assert ours.detect_gradient_poisoning(grads, 0, step) is False
        assert theirs.detect_gradient_poisoning(grads, 0, step) is False
        out = rng.normal(size=(32,)).astype(np.float32)
        assert ours.detect_output_anomaly(out, 1, step) == \
            theirs.detect_output_anomaly(out, 1, step)
    poisoned = [rng.normal(0, 0.1, size=(16,)).astype(np.float32) * 1000
                for _ in range(3)]
    assert ours.detect_gradient_poisoning(poisoned, 0, 99) is True
    assert theirs.detect_gradient_poisoning(poisoned, 0, 99) is True
    wild = (rng.normal(size=(32,)) * 50 + 9).astype(np.float32)
    assert ours.detect_output_anomaly(wild, 1, 99) is True
    assert theirs.detect_output_anomaly(wild, 1, 99) is True
    assert ours.get_detection_statistics() == \
        theirs.get_detection_statistics()
    assert ours.get_detection_statistics()["total_detections"] == 2
    for mine, jax_side in ((ours.gradient_baselines[0],
                            theirs.gradient_baselines[0]),
                           (ours.output_baselines[1],
                            theirs.output_baselines[1])):
        assert sorted(mine) == sorted(jax_side)
        for name in mine:
            for key, value in mine[name].items():
                assert value == pytest.approx(jax_side[name][key],
                                              rel=1e-5, abs=1e-6), (name, key)
    # The statistic dicts themselves, with a torch tensor as the input.
    x = rng.normal(size=(5, 7)).astype(np.float32)
    got = ours.calculate_tensor_statistics(torch.from_numpy(x))
    want = theirs.calculate_tensor_statistics(x)
    assert list(got) == list(want)
    _stats_close(list(got.values()), list(want.values()), 3.0)
    got = ours.calculate_gradient_statistics([x, 2 * x - 1])
    want = theirs.calculate_gradient_statistics([x, 2 * x - 1])
    assert list(got) == list(want)
    _stats_close(list(got.values()), list(want.values()), 10.0)
    assert ours.calculate_gradient_statistics([]) == {}
    assert ours.detect_gradient_poisoning([], 0, 0) is False
    assert ours.detect_output_anomaly(None, 0, 0) is True
    assert theirs.detect_output_anomaly(None, 0, 0) is True


def test_host_threshold_reset_export_and_cleanup_match_jax(tmp_path):
    ours, theirs = _pair()
    rng = np.random.default_rng(9)
    for step in range(12):
        out = rng.normal(size=(32,)).astype(np.float32)
        ours.detect_output_anomaly(out, 1, step)
        theirs.detect_output_anomaly(out, 1, step)
    for d in (ours, theirs):
        d.set_detection_threshold(1.7)
        assert d.detection_threshold == 1.0
        d.export_detection_data(str(tmp_path / f"{id(d)}.json"))
    got = json.loads((tmp_path / f"{id(ours)}.json").read_text())
    want = json.loads((tmp_path / f"{id(theirs)}.json").read_text())
    assert got["history_lengths"] == want["history_lengths"] == {"1": 12}
    assert got["detection_stats"] == want["detection_stats"]
    assert sorted(got["baselines"]["output"]["1"]) == \
        sorted(want["baselines"]["output"]["1"])
    for d in (ours, theirs):
        d.reset_node_history(1)
        assert len(d.output_history[1]) == 0 and 1 not in d.output_baselines
        d.cleanup()
        assert not d.output_history and not d.anomaly_detectors


def test_host_byzantine_and_backdoor_match_jax():
    """``tests/test_detector.py``'s ragged drive on both detectors, plus the
    equal-length device path and the backdoor check."""
    ours, theirs = _pair()
    rng = np.random.default_rng(3)
    base = rng.standard_normal(256).astype(np.float32)
    honest = {i: base + 0.01 * rng.standard_normal(256).astype(np.float32)
              for i in range(3)}
    cases = [
        np.concatenate([base, 0.3 * rng.standard_normal(32)
                        .astype(np.float32)]),
        rng.standard_normal(256).astype(np.float32),
        np.concatenate([base, 10.0 * rng.standard_normal(768)
                        .astype(np.float32)]),
        base[:2].copy(),
        np.zeros(0, np.float32),
    ]
    expected = [[], [3], [3], [3], [3]]
    for third, want in zip(cases, expected):
        outputs = {**honest, 3: third}
        assert ours.detect_byzantine_behavior(outputs, 0) == \
            theirs.detect_byzantine_behavior(outputs, 0) == want
    tensors = {i: torch.from_numpy(v) for i, v in honest.items()}
    assert ours.detect_byzantine_behavior(tensors, 0) == []
    assert ours.detect_byzantine_behavior({0: base, 1: base}, 0) == []
    m = rng.normal(0, 1, (4, 6)).astype(np.float32)
    for e in (m, -8 * m):
        assert ours.detect_backdoor_attack(m, e, 0) == \
            theirs.detect_backdoor_attack(m, e, 0)
    assert ours.detect_backdoor_attack(m, -8 * m, 0) is True
    assert ours.detect_backdoor_attack(None, m, 0) is False


def test_ml_tier_on_identical_histories_matches_jax():
    """Identical joined histories (output and gradient batteries, one
    node short of the 50-sample floor, one with only an output stream):
    the same fitted nodes, feature keys, verdicts and decision values."""
    ours, theirs = _pair()
    rng = np.random.default_rng(0)
    out_names, grad_names = st.TENSOR_STAT_NAMES, st.GRADIENT_STAT_NAMES
    for node, steps in ((0, 60), (1, 49), (2, 55)):
        for _ in range(steps):
            out = dict(zip(out_names, rng.normal(0, 1, len(out_names))))
            grad = dict(zip(grad_names, rng.normal(0, 1, len(grad_names))))
            for d in (ours, theirs):
                d.output_history[node].append({"stats": dict(out)})
                if node != 2:
                    d.gradient_history[node].append({"stats": dict(grad)})
    for d in (ours, theirs):
        d.update_detection_models(fit_clustering=True)
    assert sorted(ours.anomaly_detectors) == sorted(theirs.anomaly_detectors)
    assert sorted(ours.anomaly_detectors) == [0, 2]
    assert sorted(ours.clustering_models) == [0, 2]
    assert ours._model_keys == theirs._model_keys
    for node in (0, 1, 2):
        assert ours.latest_features(node) == theirs.latest_features(node)
    probes = [dict(zip(out_names, np.full(12, 50.0))),
              dict(zip(out_names, np.zeros(12))),
              ours.latest_features(0), ours.latest_features(2)]
    for node in (0, 1, 2):
        for probe in probes:
            assert ours.detect_with_ml_models(probe, node) == \
                theirs.detect_with_ml_models(probe, node)
    assert ours.detect_with_ml_models(probes[0], 0) is True
    assert ours.detect_with_ml_models(probes[1], 0) is False
    assert ours.detect_with_ml_models(probes[0], 1) is False   # no model
    for node in (0, 2):
        keys = ours._model_keys[node]
        for probe in probes:
            if not any(":" in k for k in probe):
                probe = {f"out:{k}": v for k, v in probe.items()}
            vec = np.asarray([[probe.get(k, 0.0) for k in keys]])
            assert ours.anomaly_detectors[node].decision_function(vec) == \
                theirs.anomaly_detectors[node].decision_function(vec)
    assert ours.latest_features(7) is None


def test_standalone_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        det.AttackDetector()


# ---------------------------------------------------------------------------
# (g) One trainer-level parity run
# ---------------------------------------------------------------------------

TINY_RESNET = dict(stage_sizes=(1, 1, 1), widths=(16, 16, 16), stem_width=16,
                   image_shape=(8, 8, 3))
STEPS = 26
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
              intensity=0.5, start_step=8)


def _config(cls, **kw):
    return cls(model_name="resnet32", dataset_name="cifar10", batch_size=8,
               num_nodes=4, optimizer="sgd", learning_rate=3e-2,
               detector_warmup=4, async_host_depth=0, prefetch_depth=0, **kw)


def _loader(fn):
    return fn("cifar10", batch_size=8, image_size=8, num_examples=8 * STEPS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    jtr = jtrainer_mod.DistributedTrainer(
        _config(JTrainingConfig, checkpoint_dir=ck),
        model_overrides=dict(TINY_RESNET, dtype=jnp.float32))
    jtr.initialize()
    tr = trainer_mod.DistributedTrainer(
        _config(TrainingConfig, checkpoint_dir=ck),
        model_overrides=dict(TINY_RESNET, dtype=torch.float32), device="cpu")
    tr.initialize(params=convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.state.params)))
    for trainer, attacker in ((jtr, JAttacker(JAttackConfig(**ATTACK))),
                              (tr, AdversarialAttacker(
                                  AttackConfig(**ATTACK)))):
        attacker.activate_attacks()
        trainer.set_attack_plan(attacker.plan(4))
    jres = jtr.train(_loader(jget_dataloader), num_epochs=2)
    res = tr.train(_loader(get_dataloader), num_epochs=2)
    return dict(jtr=jtr, tr=tr, jres=jres, res=res)


def test_trainer_ml_tier_matches_jax(runs):
    jtr, tr = runs["jtr"], runs["tr"]
    assert tr._ml_enabled and jtr._ml_enabled
    assert tr.global_step == jtr.global_step == 2 * STEPS

    def incidents(history):
        return [(r["node_id"], r["step"], r["attack_type"])
                for r in history]

    assert incidents(tr.attack_history) == incidents(jtr.attack_history)
    assert [r["node_id"] for r in tr.attack_history] == [2]
    assert [tr.trust_manager.get_node_status(i) .value for i in range(4)] == \
        [jtr.trust_manager.get_node_status(i).value for i in range(4)]
    flags = tr.get_training_stats()["ml_flags"]
    assert flags == jtr.get_training_stats()["ml_flags"]
    assert sorted(flags) == [0, 1, 2, 3]
    assert sorted(tr.attack_detector.anomaly_detectors) == [0, 1, 2, 3]
    for node in range(4):
        assert len(tr.attack_detector.output_history[node]) == 2 * STEPS
        assert sorted(tr.attack_detector.latest_features(node)) == \
            sorted(jtr.attack_detector.latest_features(node))
    ds, jds = (tr.attack_detector.detection_stats,
               jtr.attack_detector.detection_stats)
    assert (ds["true_positives"], ds["false_positives"]) == \
        (jds["true_positives"], jds["false_positives"]) == (1, 0)


def test_trainer_losses_and_trust_within_the_contract(runs):
    jtr, tr = runs["jtr"], runs["tr"]
    jrecs = jtr.metrics_collector.batch_metrics
    recs = tr.batch_history
    assert len(recs) == len(jrecs) == 2 * STEPS
    np.testing.assert_allclose([r["loss"] for r in recs],
                               [r["loss"] for r in jrecs], rtol=0, atol=1e-5)
    for r, j in zip(recs, jrecs):
        assert sorted(r["trust_scores"]) == sorted(j["trust_scores"])
        for node, score in r["trust_scores"].items():
            assert score == pytest.approx(j["trust_scores"][node], abs=1e-5)
    assert [e["train_loss"] for e in runs["res"]["epochs"]] == \
        pytest.approx([e["train_loss"] for e in runs["jres"]["epochs"]],
                      abs=1e-5)


def test_ml_tier_off_without_the_flag_or_scikit_learn(monkeypatch, tmp_path):
    """``ml_detectors=False``: no tier in either package.  scikit-learn
    unimportable: both gates say no, no battery is fed and no flag is
    reported, while the in-step detection still runs."""
    kw = dict(checkpoint_dir=str(tmp_path))
    jtr = jtrainer_mod.DistributedTrainer(
        _config(JTrainingConfig, ml_detectors=False, **kw),
        model_overrides=dict(TINY_RESNET, dtype=jnp.float32))
    tr = trainer_mod.DistributedTrainer(
        _config(TrainingConfig, ml_detectors=False, **kw),
        model_overrides=dict(TINY_RESNET, dtype=torch.float32), device="cpu")
    assert not tr._ml_enabled and not jtr._ml_enabled
    assert TrainingConfig().ml_detectors is True
    assert TrainingConfig().exact_order_stats is True
    assert TrainingConfig().dtype == "bfloat16" == JTrainingConfig().dtype
    for name in ("sklearn", "sklearn.cluster", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, name, None)
    assert not trainer_mod._sklearn_available()
    assert not jtrainer_mod._sklearn_available()
    tr = trainer_mod.DistributedTrainer(
        _config(TrainingConfig, **kw),
        model_overrides=dict(TINY_RESNET, dtype=torch.float32), device="cpu")
    assert not tr._ml_enabled
    tr.train(_loader(get_dataloader), num_epochs=1)
    assert tr.global_step == STEPS
    assert not tr.attack_detector.output_history
    assert tr.get_training_stats()["ml_flags"] == {}
    # The detector's own refit is a no-op without scikit-learn.
    d = det.AttackDetector(device="cpu")
    for _ in range(60):
        d.output_history[0].append({"stats": {"mean": 0.0}})
    d.update_detection_models()
    assert not d.anomaly_detectors
