"""The port's survival drill on the CPU: the JAX package's scripted plan
(``tests/test_survival.py``: a lost batch, a stall, a corrupted
checkpoint, NaN state, a preemption) through ``TrainingSupervisor`` on
the tiny GPT-2 (2 layers, 32 wide, 4 heads, vocab 128, T 16) over 4
nodes.  The report must equal ``FaultPlan.predict`` exactly, the rollback
must walk past the corrupted step-10 checkpoint to step 5, and the final
loss must sit within the JAX test's bounds of the fault-free run on the
same data.  Then: a corrupted latest checkpoint falls back on load, NaN
params are never saved, a resume is bit-exact (params, optimizer state,
trust state, incidents, step), and ``cli train`` runs supervised, under a
seeded chaos plan, and resumed.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.chaos import FaultPlan as JFaultPlan
from trustworthy_dl_tpu.chaos import FaultEvent as JFaultEvent
from trustworthy_dl_tpu.chaos import FaultKind as JFaultKind
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
    FaultKind, FaultPlan, corrupt_file
from trustworthy_dl_tpu_torch.chaos.injector import _corrupt_largest_leaf, \
    _largest_file
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.supervisor import TrainingSupervisor
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32,
            seq_len=16)
EPOCHS = 4  # 8 steps an epoch (64 examples / batch 8)
SCRIPT = [(3, "data_loss", 1.0), (7, "stall", 0.01), (10, "ckpt_corrupt", 1.0),
          (12, "grad_nan", 1.0), (18, "preempt", 1.0)]
PLAN = FaultPlan.scripted([FaultEvent(step=s, kind=FaultKind(k), severity=v)
                           for s, k, v in SCRIPT])
MAX_RETRIES, ROLLBACK_AFTER = 2, 2


def _config(ckpt_dir, **kw):
    # Depth 0, as JAX's tests/test_survival.py pins it: FaultPlan.predict's
    # exact retry counts are the synchronous guard's (the lagged guard
    # runs no in-place retry).
    kw.setdefault("async_host_depth", 0)
    return TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                          learning_rate=3e-3, detector_warmup=4,
                          checkpoint_interval=5, checkpoint_dir=ckpt_dir,
                          num_epochs=EPOCHS, **kw)


def _loader():
    return get_dataloader("openwebtext", batch_size=8, seq_len=16,
                          vocab_size=128, num_examples=64)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("drill") / "ckpt")
    trainer = DistributedTrainer(_config(ckpt_dir),
                                 model_overrides=dict(TINY), device="cpu")
    dl = _loader()
    trainer.initialize()
    baseline = trainer.train(dl, num_epochs=EPOCHS)
    base_loss = baseline["epochs"][-1]["train_loss"]

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    trainer.reset_for_run()
    supervisor = TrainingSupervisor(
        trainer, max_retries=MAX_RETRIES, rollback_after=ROLLBACK_AFTER,
        max_restarts=2, chaos=FaultInjector(PLAN))
    result = supervisor.run(dl, num_epochs=EPOCHS)
    return dict(trainer=trainer, result=result, base_loss=base_loss,
                ckpt_dir=ckpt_dir)


def test_drill_recovers_with_plan_predicted_counts(drill):
    report = drill["result"]["supervisor"]
    predicted = PLAN.predict(max_retries=MAX_RETRIES,
                             rollback_after=ROLLBACK_AFTER)
    jplan = JFaultPlan.scripted([JFaultEvent(step=s, kind=JFaultKind(k),
                                             severity=v)
                                 for s, k, v in SCRIPT])
    assert predicted == jplan.predict(MAX_RETRIES, ROLLBACK_AFTER)
    assert {k: report[k] for k in predicted} == predicted
    assert sum(report["faults_fired"].values()) == len(PLAN.events)
    assert report["bad_steps"] == ROLLBACK_AFTER
    assert drill["result"]["stats"]["training_state"] == "completed"


def test_drill_rollback_skipped_the_corrupt_checkpoint(drill):
    """GRAD_NAN after step 12 forces a rollback at step 14; the step-10
    checkpoint is bit-rotten, so the verified walk lands on step 5."""
    assert drill["result"]["supervisor"]["rollback_steps"] == [5]


def test_drill_final_loss_within_tolerance_of_fault_free(drill):
    final = drill["result"]["epochs"][-1]["train_loss"]
    base = drill["base_loss"]
    assert np.isfinite(final)
    assert final < base + 0.75, (final, base)
    assert final < 4.2, final


def test_corrupted_latest_checkpoint_restore_falls_back(drill):
    """A plain ``load_checkpoint()`` after bit-rot of the latest
    checkpoint lands on the prior verified step, with the params of that
    step's files, and the restored state trains."""
    trainer = drill["trainer"]
    mgr = trainer.checkpointer
    latest = mgr.latest_step()
    assert latest is not None and latest >= 15
    corrupt_file(_largest_file(mgr.path_for(latest)))
    trainer.load_checkpoint()
    prior = mgr.latest_step()
    assert trainer.global_step == prior < latest
    saved = torch.load(os.path.join(mgr.path_for(prior), "params.pt"),
                       weights_only=True)
    assert torch.equal(saved["params/wte"], trainer.state.params["wte"])
    record = trainer.train_step(next(iter(_loader())), 0)
    assert np.isfinite(record["loss"])


def test_save_checkpoint_refuses_non_finite_params(tmp_path):
    config = _config(str(tmp_path / "ckpt"))
    trainer = DistributedTrainer(config, model_overrides=dict(TINY),
                                 device="cpu")
    trainer.initialize()
    trainer.global_step = 1
    assert trainer.save_checkpoint() is not None
    assert trainer.checkpointer.load_metadata(1) == {
        "num_nodes": 4, "node_map": [0, 1, 2, 3], "parallelism": "data",
        "mesh_devices": ["cpu"], "compromised_nodes": [], "evicted_at": {},
        "evicted_devices": {}, "idle_pool": {}}
    trainer.state = trainer.state._replace(
        params=_corrupt_largest_leaf(trainer.state.params))
    trainer.global_step = 2
    assert trainer.save_checkpoint() is None
    assert trainer.checkpointer.latest_step() == 1


def test_resume_onto_another_node_count_waits_for_elastic(tmp_path):
    """Elastic data mode is ported: a trainer built for 2 nodes resumes a
    4-node checkpoint onto its saved topology, and the elastic knobs
    construct.  Tensor mode, not ported when this was written, now
    constructs on its one-position mesh."""
    ckpt = str(tmp_path / "ckpt")
    trainer = DistributedTrainer(_config(ckpt), model_overrides=dict(TINY),
                                 device="cpu")
    trainer.initialize()
    trainer.save_checkpoint()
    other = DistributedTrainer(
        TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=2,
                       checkpoint_dir=ckpt),
        model_overrides=dict(TINY), device="cpu")
    other.load_checkpoint()
    assert other.config.num_nodes == 4 and other.node_map == [0, 1, 2, 3]
    assert other.state.trust.scores.shape == (4,)
    assert other.trust_manager.num_nodes == 4
    assert np.isfinite(other.train_step(next(iter(_loader())), 0)["loss"])
    for kw in (dict(elastic_resharding=True), dict(readmit_after_steps=5)):
        DistributedTrainer(_config(ckpt, **kw), model_overrides=dict(TINY),
                           device="cpu")
    tensor = DistributedTrainer(_config(ckpt, parallelism="tensor"),
                                model_overrides=dict(TINY), device="cpu")
    assert tensor.mesh.shape == {"data": 1, "model": 1}


def _attacked_trainer(ckpt_dir):
    trainer = DistributedTrainer(_config(ckpt_dir),
                                 model_overrides=dict(TINY), device="cpu")
    trainer.initialize()
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=0.5, start_step=8))
    attacker.activate_attacks()
    trainer.set_attack_plan(attacker.plan(4))
    return trainer


def _incidents(trainer):
    return [{k: v for k, v in r.items() if k != "timestamp"}
            for r in trainer.attack_history]


def test_resume_is_bit_exact(tmp_path):
    """Train k steps, save, train m more; a fresh trainer loads step k and
    trains the same m batches: params, optimizer state, trust state,
    every other state tensor, the generator's next draw, the incidents
    and the step counter are bitwise equal.  The attack's noise is drawn
    from the state's generator: step 9, the save's, is the first attacked
    step (a suspect, confirmed only at step 10), so the saved generator
    has moved and no incident is open at the save."""
    k, m = 9, 7
    batches = list(_loader()) * 2
    ckpt = str(tmp_path / "ckpt")
    a = _attacked_trainer(ckpt)
    for b in batches[:k]:
        a.train_step(b, 0)
    assert a.save_checkpoint() is not None
    for b in batches[k:k + m]:
        a.train_step(b, 0)
    assert a.attack_history, "the attack must be confirmed after the save"

    b_tr = _attacked_trainer(ckpt)
    b_tr.load_checkpoint()
    assert b_tr.global_step == k
    for b in batches[k:k + m]:
        b_tr.train_step(b, 0)

    assert b_tr.global_step == a.global_step == k + m
    assert b_tr.state.step == a.state.step
    assert _incidents(b_tr) == _incidents(a)
    assert (b_tr.state.step, b_tr.state.epoch) == (a.state.step,
                                                   a.state.epoch)
    for field in a.state._fields:
        if field in ("step", "epoch", "rng"):
            continue
        got = tree_leaves(_as_tree(getattr(b_tr.state, field)))
        want = tree_leaves(_as_tree(getattr(a.state, field)))
        # ``canary`` (pipeline mode's) is None in data mode, in both.
        assert len(got) == len(want) and all(
            (x is None and y is None) or torch.equal(x, y)
            for x, y in zip(got, want)), field
    assert torch.equal(torch.rand(4, generator=a.state.rng),
                       torch.rand(4, generator=b_tr.state.rng))


def _as_tree(node):
    """NamedTuples and lists as dicts, for ``tree_leaves``."""
    if hasattr(node, "_fields"):
        return {f: _as_tree(getattr(node, f)) for f in node._fields}
    if isinstance(node, dict):
        return {k: _as_tree(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return {f"{i:04d}": _as_tree(v) for i, v in enumerate(node)}
    return node


def test_cli_train_supervised_chaos_and_resume(tmp_path, capsys):
    from trustworthy_dl_tpu_torch.cli import main

    tiny = {k: v for k, v in TINY.items() if k != "seq_len"}
    ckpt = str(tmp_path / "ckpt")
    common = ["--device", "cpu", "--nodes", "4", "--batch-size", "8",
              "--seq-len", "16", "--steps-per-epoch", "8",
              "--checkpoint-dir", ckpt]
    from trustworthy_dl_tpu_torch import cli

    assert cli.train_main(common + ["--epochs", "2", "--supervise",
                                    "--chaos-seed", "3", "--chaos-rate",
                                    "0.1", "--rollback-after", "2"],
                          model_overrides=tiny) == 0
    out = capsys.readouterr().out
    assert "chaos drill: seed 3" in out and "supervisor report:" in out
    latest = DistributedTrainer(
        TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                       checkpoint_dir=ckpt),
        model_overrides=dict(TINY), device="cpu").checkpointer.latest_step()
    assert latest is not None
    assert cli.train_main(common + ["--epochs", "1", "--resume"],
                          model_overrides=tiny) == 0
    out = capsys.readouterr().out
    assert f"resumed from checkpoint step {latest}" in out
    assert f"Training completed: {latest + 8} steps" in out
    assert main(["nope"]) == 2
