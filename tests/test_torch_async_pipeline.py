"""The port's async host pipeline (``engine/async_host.py``) against the
JAX package's, on the CPU; mirrors ``tests/test_async_pipeline.py``.

Tiny GPT-2 (2 layers, 32 wide, 4 heads, vocab 128, T 16), 4 nodes x 2
sequences, f32 compute in both packages, the port given the JAX trainer's
initial params (``models/convert``), gradient poisoning of node 1 at
intensity 1.5 from step 4 (JAX's test's plan), 2 epochs of 8 steps.

* The packer round-trips every field bit for bit, dtypes restored, and
  notices a node-count change.
* Depth 0 and depth 2 give bit-equal losses, per-node losses, trust,
  weights, verdicts and statuses at every step, and equal incidents and
  final stats: the lag changes when the host reads a step, never what.
* The port at depth 2 against JAX at depth 2: losses and trust within
  1e-5 (the training contract), verdicts and incidents equal.
* The lagged guard: NaN losses from step 6 at depth 2 with checkpoints
  every 4 steps and ``rollback_after=1`` roll back to step 4 with no
  in-place retry, the two steps in flight discarded; the report equals
  JAX's on the same drive.
* The deferred evictions of a window never empty the fleet; the config
  and ``cli train --async-host-depth``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.data import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.engine.checkpoint import \
    CheckpointManager as JCheckpointManager
from trustworthy_dl_tpu.engine.supervisor import \
    TrainingSupervisor as JSupervisor
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.async_host import AsyncHostPipeline
from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager
from trustworthy_dl_tpu_torch.engine.step import HostMetricsPacker
from trustworthy_dl_tpu_torch.engine.supervisor import TrainingSupervisor
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32,
            seq_len=16)
NODES, BATCH, SEQ, STEPS_PER_EPOCH = 4, 8, 16, 8
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[1],
              intensity=1.5, start_step=4)
CONFIG = dict(model_name="gpt2", batch_size=BATCH, num_nodes=NODES,
              learning_rate=3e-3, detector_warmup=2, checkpoint_interval=4)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _loader(fn):
    return fn("openwebtext", batch_size=BATCH, seq_len=SEQ,
              vocab_size=TINY["vocab_size"],
              num_examples=BATCH * STEPS_PER_EPOCH)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """One JAX trainer (compiled once, ``reset_for_run`` between runs) and
    the port's on its initial params."""
    root = tmp_path_factory.mktemp("asyncpipe")
    jtrainer = JTrainer(JTrainingConfig(checkpoint_dir=str(root / "j"),
                                        **CONFIG),
                        model_overrides=dict(TINY, dtype=jnp.float32))
    jtrainer.initialize()
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jtrainer.state.params))
    trainer = DistributedTrainer(
        TrainingConfig(checkpoint_dir=str(root / "t"), **CONFIG),
        model_overrides=dict(TINY, dtype=torch.float32), device="cpu")
    return dict(jtrainer=jtrainer, trainer=trainer, root=root,
                tparams=convert.params_from_jax(jparams))


def _statuses(trainer):
    """Every recorded step's node statuses (the records do not keep
    them)."""
    out = []
    record = trainer._record_batch

    def wrapped(host, epoch, step_s=None):
        out.append(host["status"].tolist())
        return record(host, epoch, step_s)

    trainer._record_batch = wrapped
    return out


def _port_run(sides, depth, epochs=2):
    trainer = sides["trainer"]
    trainer.config = dataclasses.replace(trainer.config,
                                         async_host_depth=depth)
    trainer.checkpointer = CheckpointManager(
        str(sides["root"] / f"port_depth{depth}"))
    trainer.reset_for_run()
    trainer.initialize(params=sides["tparams"])
    attacker = AdversarialAttacker(AttackConfig(**ATTACK))
    attacker.activate_attacks()
    trainer.set_attack_plan(attacker.plan(NODES))
    statuses = _statuses(trainer)
    dl = _loader(get_dataloader)
    try:
        for epoch in range(epochs):
            trainer.train_epoch(dl, epoch)
    finally:
        del trainer._record_batch
    return _summary(trainer, statuses)


def _summary(trainer, statuses=None):
    hist = trainer.metrics_collector.batch_metrics
    stats = trainer.get_training_stats()
    return {
        "steps": [h["step"] for h in hist],
        "loss": [h["loss"] for h in hist],
        "per_node_loss": [h.get("per_node_loss") for h in hist],
        "trust": [h["trust_scores"] for h in hist],
        "weights": [h.get("weights") for h in hist],
        "attacked": [h.get("attacked") for h in hist],
        "status": statuses,
        "incidents": [(r["node_id"], r["step"], r["attack_type"])
                      for r in trainer.attack_history],
        "reassignments": [(r["from_node"], r["to_node"], r["step"])
                          for r in trainer.reassignment_history],
        "stats": {k: stats[k] for k in ("trust_scores", "attack_count",
                                        "global_step", "training_state")},
    }


@pytest.fixture(scope="module")
def port_runs(sides):
    return {depth: _port_run(sides, depth) for depth in (0, 2)}


@pytest.fixture(scope="module")
def jax_run(sides):
    jtrainer = sides["jtrainer"]
    jtrainer.config = dataclasses.replace(
        jtrainer.config, async_host_depth=2,
        checkpoint_dir=str(sides["root"] / "jax_depth2"))
    jtrainer.checkpointer = JCheckpointManager(jtrainer.config.checkpoint_dir)
    jtrainer.reset_for_run()
    attacker = JAttacker(JAttackConfig(**ATTACK))
    attacker.activate_attacks()
    jtrainer.set_attack_plan(attacker.plan(NODES))
    dl = _loader(jget_dataloader)
    for epoch in range(2):
        jtrainer.train_epoch(dl, epoch)
    return _summary(jtrainer)


def test_host_metrics_packer_roundtrip(sides):
    trainer = sides["trainer"]
    trainer.config = dataclasses.replace(trainer.config, async_host_depth=2)
    trainer.reset_for_run()
    batch = trainer._node_batch(next(iter(_loader(get_dataloader))))
    state, metrics = trainer._train_step(trainer.state, batch,
                                         trainer.attack_plan)
    trainer.state = state
    packer = HostMetricsPacker(metrics, state.fleet_raw_streak)
    assert packer.matches(metrics, state.fleet_raw_streak)
    packed = packer.pack(metrics, state.fleet_raw_streak)
    assert packed.device.dtype == torch.float32 and packed.device.dim() == 1
    assert packed.event is None and packed.device.numel() == packer.total
    host, streak = packer.unpack(packed)
    for name in type(metrics)._fields:
        want = getattr(metrics, name)
        if want is None or name == "model_aux":
            continue
        want = want.numpy()
        got = getattr(host, name)
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(streak, state.fleet_raw_streak.numpy())
    # A node-count change (an elastic transition) is noticed.
    shrunk = metrics._replace(trust_scores=metrics.trust_scores[:-1])
    assert not packer.matches(shrunk, state.fleet_raw_streak)


def test_depth_0_and_depth_2_are_bit_equal(port_runs):
    sync, lagged = port_runs[0], port_runs[2]
    assert sync["incidents"], "the attack produced no incident"
    assert {node for node, _, _ in sync["incidents"]} == {1}
    assert len(sync["steps"]) == 2 * STEPS_PER_EPOCH
    assert sync["steps"] == sorted(sync["steps"])
    for key in sync:
        assert sync[key] == lagged[key], key


def test_depth_2_matches_jax_depth_2(port_runs, jax_run):
    port = port_runs[2]
    assert port["steps"] == jax_run["steps"]
    assert port["incidents"] == jax_run["incidents"]
    assert [(a, b) for a, b, _ in port["reassignments"]] == \
        [(a, b) for a, b, _ in jax_run["reassignments"]]
    np.testing.assert_allclose(port["loss"], jax_run["loss"], atol=ATOL,
                               rtol=0)
    for got, want in zip(port["trust"], jax_run["trust"], strict=True):
        assert got.keys() == want.keys()
        for node in got:
            assert abs(got[node] - want[node]) <= ATOL, node
    for key in ("attack_count", "global_step", "training_state"):
        assert port["stats"][key] == jax_run["stats"][key], key


def _lagged_guard_run(trainer, make_supervisor, loader_fn, ckpt_dir,
                      checkpointer_cls, poison):
    trainer.config = dataclasses.replace(
        trainer.config, async_host_depth=2, checkpoint_dir=str(ckpt_dir))
    trainer.checkpointer = checkpointer_cls(str(ckpt_dir))
    trainer.reset_for_run()
    real_step = trainer._train_step
    calls = {"n": 0}

    def poisoned(state, batch, plan):
        calls["n"] += 1
        state, m = real_step(state, batch, plan)
        if calls["n"] >= 6:      # steps 6 on report a non-finite loss
            m = m._replace(loss=poison())
        return state, m

    trainer._train_step = poisoned
    try:
        supervisor = make_supervisor(trainer)
        supervisor.run(loader_fn(), num_epochs=1)
    finally:
        trainer._train_step = real_step
        trainer.step_guard = None
    return supervisor


def test_lagged_guard_rolls_back_to_prewindow_checkpoint(sides, tmp_path):
    """A bad step surfacing 2 steps late is not retried in place and rolls
    back to the checkpoint before the window: the last full drain
    accepted through step 4, the bad step is 6, and steps 7-8 were in
    flight when its verdict landed."""
    trainer = sides["trainer"]
    sup = _lagged_guard_run(
        trainer, lambda t: TrainingSupervisor(t, max_retries=2,
                                              rollback_after=1),
        lambda: _loader(get_dataloader), tmp_path / "port",
        CheckpointManager, lambda: torch.tensor(float("nan")))
    assert sup.rollbacks == 1
    assert sup.retries == 0
    assert sup.bad_steps == 1
    assert sup.rollback_steps == [4]
    assert trainer.global_step == 4
    assert [h["step"] for h in trainer.batch_history] == [1, 2, 3, 4, 5]

    jtrainer = sides["jtrainer"]
    jsup = _lagged_guard_run(
        jtrainer, lambda t: JSupervisor(t, max_retries=2, rollback_after=1,
                                        backoff_base_s=0),
        lambda: _loader(jget_dataloader), tmp_path / "jax",
        JCheckpointManager, lambda: jnp.asarray(jnp.nan, jnp.float32))
    assert sup.report() == jsup.report()
    assert trainer.global_step == jtrainer.global_step


def test_deferred_evictions_never_empty_the_fleet():
    """Evictions gathered over a window that would take every node keep
    the highest coordinate in service (JAX's cap)."""
    applied = []

    class Stub:
        config = TrainingConfig(num_nodes=4)
        step_guard = None

        def _readmit_due(self):
            return False

        def _apply_evictions(self, coords):
            applied.append(list(coords))

        def _maybe_readmit(self):
            applied.append("readmit checked")

    pipe = AsyncHostPipeline(Stub(), depth=2)
    pipe.pending_evicts = {0, 1, 2, 3}
    pipe.drain()
    assert applied == [[0, 1, 2], "readmit checked"]
    assert not pipe.pending_evicts


def test_config_and_cli_take_the_depth(capsys, tmp_path):
    from trustworthy_dl_tpu_torch.cli import build_train_parser, train_main

    assert TrainingConfig().async_host_depth == \
        JTrainingConfig().async_host_depth == 2
    assert TrainingConfig().prefetch_depth == \
        JTrainingConfig().prefetch_depth == 2
    for cls in (TrainingConfig, JTrainingConfig):
        with pytest.raises(ValueError, match="async_host_depth"):
            cls(async_host_depth=-1)
    assert build_train_parser().parse_args([]).async_host_depth is None
    tiny = {k: v for k, v in TINY.items() if k != "seq_len"}
    for depth in ("0", "3"):
        assert train_main(["--device", "cpu", "--nodes", "4",
                           "--batch-size", "8", "--seq-len", "16",
                           "--steps-per-epoch", "5", "--epochs", "1",
                           "--checkpoint-dir", str(tmp_path / depth),
                           "--async-host-depth", depth],
                          model_overrides=tiny) == 0
        assert "Training completed: 5 steps" in capsys.readouterr().out
