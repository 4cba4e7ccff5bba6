"""Evaluation and the trainer's host bookkeeping: the port against the
JAX package on the CPU.

Validation runs both trainers on the same converted weights (a 2-layer,
32-wide, 4-head GPT-2, vocab 100, T = 16, f32 compute) over the same
numpy batches, a ragged tail included, through the materialised head and
the fused one (32 columns): loss within 1e-5, accuracy exactly equal,
perplexity within 1e-5 relative.  The bookkeeping (detection counts
against the attack plan, incident and reassignment records with their
migration times, shard relabelling, the host trust mirror, NodeMonitor,
the attack plan's per-id bits, the attacker's host API) is driven by the
same scripted calls on both packages and compared exactly (floats within
1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.engine.state import MonitorState as JMonitorState
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu.utils.monitor import NodeMonitor as JNodeMonitor
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.state import MonitorState
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.ops import fused_ce
from trustworthy_dl_tpu_torch.utils.monitor import NodeMonitor
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=100, n_positions=32,
            seq_len=16)
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
              intensity=0.5, start_step=3, seed=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _pair(tmp_path, **kw):
    """A JAX trainer and a port trainer on the JAX trainer's weights."""
    kw = dict(model_name="gpt2", batch_size=8, num_nodes=4, **kw)
    jtrainer = JTrainer(JTrainingConfig(checkpoint_dir=str(tmp_path / "ck"),
                                        **kw),
                        model_overrides=dict(TINY, dtype=jnp.float32))
    jtrainer.initialize()
    trainer = DistributedTrainer(TrainingConfig(**kw), model_overrides=dict(
        TINY, dtype=torch.float32), device="cpu")
    trainer.initialize(params=convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params)))
    return jtrainer, trainer


def _val_batches():
    rng = np.random.default_rng(11)
    out = []
    for size in (8, 8, 6):       # 6 does not split over 4 nodes: one row
        toks = rng.integers(0, 100, (size, 17)).astype(np.int32)
        out.append({"input": toks[:, :-1], "target": toks[:, 1:]})
    return out


@pytest.mark.parametrize("chunk", [0, 32])
def test_validate_metrics_match_jax(tmp_path, chunk):
    jtrainer, trainer = _pair(tmp_path, lm_head_chunk=chunk)
    fused_ce.reset_calls()
    got = trainer.validate_metrics(_val_batches())
    want = jtrainer.validate_metrics(_val_batches())
    # Fused: 4 node rows in each full batch, one row for the tail.
    assert fused_ce.CALLS["eval"] == (9 if chunk else 0)
    assert set(got) == set(want) == {"loss", "accuracy", "perplexity"}
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["perplexity"] / want["perplexity"] - 1) <= 1e-5
    assert trainer.validate(_val_batches()) == got["loss"]
    tail = trainer._node_batch(_val_batches()[-1], for_eval=True)
    assert tuple(tail["input"].shape) == (1, 6, 16)
    assert trainer._node_batch({"input": np.zeros((0, 16)),
                                "target": np.zeros((0, 16))},
                               for_eval=True) is None


def test_train_records_the_validation_loss():
    trainer = DistributedTrainer(
        TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4),
        model_overrides=dict(TINY), device="cpu")
    kw = dict(batch_size=8, seq_len=16, vocab_size=100, num_examples=16)
    val = get_dataloader("openwebtext", split="validation", **kw)
    result = trainer.train(get_dataloader("openwebtext", **kw), val,
                           num_epochs=2)
    assert [sorted(r) for r in result["epochs"]] == \
        [["epoch", "train_loss", "val_loss"]] * 2
    last = result["epochs"][-1]["val_loss"]
    assert np.isfinite(last)
    assert abs(trainer.validate(val) - last) <= 1e-5
    assert "val_loss" not in trainer.train(
        get_dataloader("openwebtext", **kw), num_epochs=1)["epochs"][0]


def _without_time(records):
    return [{k: v for k, v in r.items() if k != "timestamp"}
            for r in records]


def test_detection_bookkeeping_matches_jax(tmp_path):
    """The same scripted detections on both trainers: a true positive
    (node 2 while the plan is live), a false positive (node 1), and a
    detection before the plan's start (false): counts, incident and
    reassignment records (``migration_time`` included), shard labels and
    the host trust mirror equal JAX's."""
    jtrainer, trainer = _pair(tmp_path, migration_gbps=2.5)
    jatt, att = JAttacker(JAttackConfig(**ATTACK)), AdversarialAttacker(
        AttackConfig(**ATTACK))
    jatt.activate_attacks()
    att.activate_attacks()
    jtrainer.set_attack_plan(jatt.plan(4))
    trainer.set_attack_plan(att.plan(4))
    scores = np.array([0.5, 1.5, 2.5, 3.5], np.float32)

    class JMetrics:
        out_score, grad_score = scores, scores * 2

    host = {"out_score": scores, "grad_score": scores * 2}
    for step, node in ((6, 2), (6, 1), (2, 3)):
        jtrainer.global_step = trainer.global_step = step
        jtrainer._handle_detected_attack(node, "gradient_poisoning",
                                         JMetrics, node, {node})
        trainer._handle_detected_attack(node, "gradient_poisoning", host,
                                        node, {node})
    ds = trainer.attack_detector.detection_stats
    jds = jtrainer.attack_detector.detection_stats
    assert (ds["true_positives"], ds["false_positives"],
            ds["total_detections"]) == (jds["true_positives"],
                                        jds["false_positives"],
                                        jds["total_detections"]) == (1, 2, 3)
    assert dict(ds["attack_types"]) == dict(jds["attack_types"])
    assert _without_time(trainer.attack_history) == \
        _without_time(jtrainer.attack_history)
    got = _without_time(trainer.reassignment_history)
    want = _without_time(jtrainer.reassignment_history)
    assert [(r["from_node"], r["to_node"], r["step"]) for r in got] == \
        [(r["from_node"], r["to_node"], r["step"]) for r in want]
    n_params = sum(p.numel() for p in tree_leaves(trainer.state.params))
    for g, w in zip(got, want):
        assert g["migration_time"] == pytest.approx(
            w["migration_time"], rel=1e-12)
        assert g["migration_time"] == pytest.approx(
            n_params / 4 * 4 / (2.5 * 1024 ** 3) + 2.0, rel=1e-12)
    assert {i: c.model_partition for i, c in trainer.node_configs.items()} \
        == {i: c.model_partition for i, c in jtrainer.node_configs.items()}
    for i in range(4):
        assert trainer.trust_manager.get_trust_score(i) == pytest.approx(
            jtrainer.trust_manager.get_trust_score(i), abs=1e-6)
        assert int(trainer.trust_manager.get_node_status(i)) == int(
            jtrainer.trust_manager.get_node_status(i))


def test_set_attack_plan_bits_match_jax(tmp_path):
    jtrainer, trainer = _pair(tmp_path)
    jatt, att = JAttacker(JAttackConfig(**ATTACK)), AdversarialAttacker(
        AttackConfig(**ATTACK))
    for target_ids in (None, [2, 5]):
        jtrainer.set_attack_plan(jatt.plan(4), target_ids=target_ids)
        trainer.set_attack_plan(att.plan(4), target_ids=target_ids)
        assert trainer._plan_bits == jtrainer._plan_bits
    assert trainer._plan_bits == {0: False, 1: False, 2: True, 3: False,
                                  5: True}


def test_node_monitor_matches_jax():
    """Scripted observations, then a device MonitorState absorbed through
    a node map: every expectation equal to JAX's NodeMonitor."""
    mon, jmon = NodeMonitor(warmup=2), JNodeMonitor(warmup=2)
    for m in (mon, jmon):
        for k in range(3):
            m.observe_output(7, 0.1 * k, 1.0 + k)
            m.observe_gradient_norms(7, [1.0 + k, 2.0 * k])
        m.observe_output(8, 0.5, 0.25)
    for node in (7, 8, 9):
        assert mon.get_expected_mean(node) == jmon.get_expected_mean(node)
        assert mon.get_expected_std(node) == jmon.get_expected_std(node)
        assert mon.get_expected_gradient_norms(node) == \
            jmon.get_expected_gradient_norms(node)
    rng = np.random.default_rng(1)
    count = np.array([1, 6, 9], np.int32)
    mean, std = (rng.random(3).astype(np.float32) for _ in range(2))
    norms = rng.random((3, 5)).astype(np.float32)
    mon.sync_from_device(MonitorState(*(torch.from_numpy(a) for a in (
        count, mean, std, norms))), node_ids=[2, 0, 1])
    jmon.sync_from_device(JMonitorState(*(jnp.asarray(a) for a in (
        count, mean, std, norms))), node_ids=[2, 0, 1])
    for node in (0, 1, 2, 7):
        assert mon.get_expected_mean(node) == jmon.get_expected_mean(node)
        assert mon.get_expected_std(node) == jmon.get_expected_std(node)
        assert mon.get_expected_gradient_norms(node) == \
            jmon.get_expected_gradient_norms(node)


def test_attacker_host_api_matches_jax():
    """plan_for a permuted node map, host-side poisoning of three batches
    (numpy draws from the config's seed) and the final statistics."""
    kinds = dict(ATTACK, attack_types=["data_poisoning", "backdoor"],
                 target_nodes=[1, 2])
    jatt, att = JAttacker(JAttackConfig(**kinds)), AdversarialAttacker(
        AttackConfig(**kinds))
    assert att.get_final_statistics() == jatt.get_final_statistics()
    batches = _val_batches()
    assert att.apply_attacks(batches[0], 0) is batches[0]    # inactive
    jatt.activate_attacks()
    att.activate_attacks()
    node_map = [3, 2, 1, 0]
    np.testing.assert_array_equal(att.plan_for(node_map).target_mask,
                                  np.asarray(jatt.plan_for(node_map)
                                             .target_mask))
    for i, b in enumerate(batches):
        got, want = att.apply_attacks(b, i + 4), jatt.apply_attacks(b, i + 4)
        for key in ("input", "target"):
            np.testing.assert_array_equal(got[key], want[key])
    stats = att.get_final_statistics()
    assert stats == jatt.get_final_statistics()
    assert stats["total_attack_steps"] == stats["batches_poisoned"] == 3


def test_reset_for_run_starts_over():
    """After an attacked epoch: a reset gives the host world-view and the
    device state of a fresh trainer initialised from the same seed."""
    kw = dict(model_name="gpt2", batch_size=8, num_nodes=4,
              detector_warmup=2, learning_rate=3e-3)
    trainer = DistributedTrainer(TrainingConfig(**kw),
                                 model_overrides=dict(TINY), device="cpu")
    att = AdversarialAttacker(AttackConfig(**dict(ATTACK, intensity=5.0)))
    att.activate_attacks()
    trainer.initialize()
    trainer.set_attack_plan(att.plan(4))
    trainer.train_epoch(get_dataloader("openwebtext", batch_size=8,
                                       seq_len=16, vocab_size=100,
                                       num_examples=64), 0)
    assert trainer.global_step == 8 and trainer.attack_history
    assert trainer.attack_detector.detection_stats["true_positives"] >= 1
    state = trainer.reset_for_run(seed=3)
    fresh = DistributedTrainer(TrainingConfig(**kw),
                               model_overrides=dict(TINY), device="cpu")
    fresh.initialize(seed=3)
    assert trainer.global_step == 0 and trainer.state is state
    assert not (trainer.attack_history or trainer.reassignment_history
                or trainer.batch_history)
    assert trainer.attack_detector.detection_stats["total_detections"] == 0
    assert not bool(trainer.attack_plan.active) and not trainer._plan_bits
    assert all(trainer.trust_manager.get_trust_score(i) == 1.0
               for i in range(4))
    for a, b in zip(tree_leaves(state.params), tree_leaves(
            fresh.state.params)):
        assert torch.equal(a, b)
    assert int(state.opt_state.count) == 0
