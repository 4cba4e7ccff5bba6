"""The port's elastic eviction and readmission (``elastic/reassignment.py``
and the trainer's hooks) against the JAX package's, on the CPU; mirrors
``tests/test_elastic.py`` and ``tests/test_recovery.py`` in data mode.

One module-scoped run of each package: tiny GPT-2 (2 layers, 32 wide, 4
heads, vocab 128, T 16) in f32, 4 nodes x 2 sequences, the async host
pipeline at its default depth 2 (no prefetch thread: ``CONFIG``),
``elastic_resharding`` with
``readmit_after_steps=4``, the port given the JAX trainer's initial
params; node 2 poisoned from step 6 and never cleared while the run
evicts it, readmits it on probation and evicts it again (a still-hostile
node is not whitewashed); then the attack is cleared, node 2 comes back a
second time and training goes on at 4 nodes.  A checkpoint taken after
the first eviction resumes, in a fresh port trainer built for 4 nodes,
onto the saved 3-node topology and readmits on schedule.

Equal to JAX's: every step's node count, the incidents (node, step,
type), each eviction's and readmission's step, ids and record keys, the
node map, the loader's batch size after each change, the readmitted
row's probation (recovery rate 0.02, empty baselines).  Within the
training contract's 1e-5: every step's loss and trust.  The attacked
node's gradient noise is each package's own draw; node 2 is gated from
its first attacked step, so its trust holds the same tolerance.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.data import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.elastic import reassignment as jel
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.elastic import reassignment as el
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.trust.state import NodeStatus

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32,
            seq_len=16)
NODES, BATCH = 4, 8
# No prefetch thread: how many old-size batches it has queued when the
# loader is re-sized depends on the thread's timing (in both packages),
# and with it the epoch's step count.
CONFIG = dict(model_name="gpt2", batch_size=BATCH, num_nodes=NODES,
              learning_rate=3e-3, detector_warmup=4,
              checkpoint_interval=10_000, elastic_resharding=True,
              readmit_after_steps=4, prefetch_depth=0)
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
              intensity=0.5, start_step=6)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _drive(trainer, attacker_plan, loader_fn, null_fn, save=None):
    """The module's schedule; returns what both packages are held to."""
    trainer.set_attack_plan(attacker_plan)
    dl = loader_fn("openwebtext", batch_size=BATCH, seq_len=16,
                   vocab_size=128, num_examples=48)
    out = {"batch_sizes": [], "saved": None}

    def evictions():
        return [r for r in trainer.reassignment_history
                if "evicted_nodes" in r]

    epoch = 0
    while len(evictions()) < 2 and epoch < 8:
        trainer.train_epoch(dl, epoch)
        out["batch_sizes"].append((trainer.config.num_nodes, dl.batch_size,
                                   trainer.config.batch_size))
        if save is not None and out["saved"] is None and \
                trainer.config.num_nodes == 3:
            out["saved"] = save(trainer)
        epoch += 1
    trainer.set_attack_plan(null_fn(trainer.config.num_nodes))
    while trainer.config.num_nodes < NODES and epoch < 14:
        trainer.train_epoch(dl, epoch)
        out["batch_sizes"].append((trainer.config.num_nodes, dl.batch_size,
                                   trainer.config.batch_size))
        epoch += 1
    out["final_loss"] = trainer.train_epoch(dl, epoch)
    out["batch_sizes"].append((trainer.config.num_nodes, dl.batch_size,
                               trainer.config.batch_size))
    hist = trainer.metrics_collector.batch_metrics
    out.update(
        steps=[h["step"] for h in hist],
        loss=[h["loss"] for h in hist],
        trust=[h["trust_scores"] for h in hist],
        nodes=[len(h["trust_scores"]) for h in hist],
        incidents=[(r["node_id"], r["step"], r["attack_type"])
                   for r in trainer.attack_history],
        records=[{k: v for k, v in r.items()
                  if k not in ("timestamp", "migration_time_s",
                               "bytes_moved", "measured_gbps",
                               "new_device_count")}
                 for r in trainer.reassignment_history],
        record_keys=[sorted(r) for r in trainer.reassignment_history],
        node_map=list(trainer.node_map))
    coord = trainer.node_map.index(2)
    out["readmitted_recovery_rate"] = float(
        np.asarray(trainer.state.trust.recovery_rate)[coord])
    counts = np.asarray(trainer.state.out_baseline.count)
    out["readmitted_baseline_fresh"] = bool(counts[coord] < counts[0])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    jtrainer = JTrainer(JTrainingConfig(checkpoint_dir=str(root / "j"),
                                        **CONFIG),
                        model_overrides=dict(TINY, dtype=jnp.float32))
    jtrainer.initialize()
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jtrainer.state.params))
    jattacker = JAttacker(JAttackConfig(**ATTACK))
    jattacker.activate_attacks()
    jrun = _drive(jtrainer, jattacker.plan(NODES), jget_dataloader,
                  jnull_plan, save=lambda t: _topology(t))

    ckpt = str(root / "port")
    trainer = DistributedTrainer(TrainingConfig(checkpoint_dir=ckpt,
                                                **CONFIG),
                                 model_overrides=dict(TINY,
                                                      dtype=torch.float32),
                                 device="cpu")
    trainer.initialize(params=convert.params_from_jax(jparams))
    attacker = AdversarialAttacker(AttackConfig(**ATTACK))
    attacker.activate_attacks()

    def save(t):
        t.save_checkpoint()
        return _topology(t)

    run = _drive(trainer, attacker.plan(NODES), get_dataloader,
                 lambda n: null_plan(n), save=save)
    return dict(jrun=jrun, run=run, ckpt=ckpt, trainer=trainer)


def _topology(trainer):
    return {"step": trainer.global_step, "num_nodes":
            trainer.config.num_nodes, "node_map": list(trainer.node_map),
            "evicted_at": dict(trainer._evicted_at)}


def test_compact_train_state_matches_jax(tmp_path):
    """The per-node rows of the kept coordinates, as JAX compacts them;
    params and optimizer state untouched."""
    jt = JTrainer(JTrainingConfig(checkpoint_dir=str(tmp_path / "j"),
                                  **CONFIG), model_overrides=dict(TINY))
    jstate = jt.initialize()
    t = DistributedTrainer(TrainingConfig(checkpoint_dir=str(tmp_path),
                                          **CONFIG),
                           model_overrides=dict(TINY), device="cpu")
    state = t.initialize()
    scores = [0.9, 0.8, 0.1, 0.7]
    jstate = jstate._replace(trust=jstate.trust._replace(
        scores=jnp.asarray(scores, jnp.float32)))
    state = state._replace(trust=state.trust._replace(
        scores=torch.tensor(scores)))
    keep = [0, 1, 3]
    jc, c = jel.compact_train_state(jstate, keep), \
        el.compact_train_state(state, keep)
    _assert_rows_equal(jc, c)
    np.testing.assert_allclose(c.trust.scores.numpy(), [0.9, 0.8, 0.7])
    assert c.out_baseline.ring.shape[0] == 3
    assert c.monitor.grad_norm_avg.shape[0] == 3
    assert c.prev_suspects.shape == (3,)
    assert c.params is state.params and c.opt_state is state.opt_state
    assert el.PER_NODE_FIELDS == jel.PER_NODE_FIELDS


def test_expand_train_state_matches_jax(tmp_path):
    """Probation rows: trust 0.5, RECOVERING, recovery rate 0.02, the
    clock at ``now``, default metrics, empty baselines, as JAX appends
    them."""
    jt = JTrainer(JTrainingConfig(checkpoint_dir=str(tmp_path / "j"),
                                  **CONFIG), model_overrides=dict(TINY))
    t = DistributedTrainer(TrainingConfig(checkpoint_dir=str(tmp_path),
                                          **CONFIG),
                           model_overrides=dict(TINY), device="cpu")
    kw = dict(now=12.0, decay_rate=0.01)
    jx = jel.expand_train_state(jt.initialize(), 2, **kw)
    x = el.expand_train_state(t.initialize(), 2, **kw)
    _assert_rows_equal(jx, x)
    assert x.trust.scores.tolist()[-2:] == [0.5, 0.5]
    assert x.trust.status.tolist()[-2:] == [int(NodeStatus.RECOVERING)] * 2
    assert x.trust.recovery_rate[-1].item() == pytest.approx(0.02)


def _assert_rows_equal(jstate, state):
    for name in el.PER_NODE_FIELDS:
        jvalue, value = getattr(jstate, name), getattr(state, name)
        pairs = [(name, jvalue, value)] if isinstance(value, torch.Tensor) \
            else [(f"{name}.{k}", getattr(jvalue, k), getattr(value, k))
                  for k in value._fields]
        for key, a, b in pairs:
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       b.double().numpy(), err_msg=key)


def test_eviction_readmission_and_re_eviction_match_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    evictions = [r for r in run["records"] if "evicted_nodes" in r]
    readmits = [r for r in run["records"] if "readmitted_nodes" in r]
    assert len(evictions) == 2 and len(readmits) == 2
    assert all(r["evicted_nodes"] == [2] for r in evictions)
    assert all(r["readmitted_nodes"] == [2] for r in readmits)
    for key in ("records", "record_keys", "incidents", "steps", "nodes",
                "node_map", "batch_sizes"):
        assert run[key] == jrun[key], key
    assert run["node_map"] == [0, 1, 3, 2]
    assert {node for node, _, _ in run["incidents"]} == {2}
    assert len(run["incidents"]) == 2          # re-detected after return


def test_losses_and_trust_within_the_training_contract(runs):
    run, jrun = runs["run"], runs["jrun"]
    np.testing.assert_allclose(run["loss"], jrun["loss"], atol=ATOL, rtol=0)
    for got, want in zip(run["trust"], jrun["trust"], strict=True):
        assert got.keys() == want.keys()
        for node in got:
            assert abs(got[node] - want[node]) <= ATOL, node
    assert np.isfinite(run["final_loss"])


def test_readmitted_row_is_on_probation_like_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    assert run["readmitted_recovery_rate"] == pytest.approx(0.02)
    assert run["readmitted_recovery_rate"] == \
        pytest.approx(jrun["readmitted_recovery_rate"])
    assert run["readmitted_baseline_fresh"] and \
        jrun["readmitted_baseline_fresh"]
    trainer = runs["trainer"]
    assert trainer.trust_manager.get_node_status(2) != \
        NodeStatus.COMPROMISED


def test_loader_resized_after_each_change(runs):
    """3 nodes x 2 a node after an eviction, 4 x 2 after a readmission,
    the config following the loader."""
    sizes = runs["run"]["batch_sizes"]
    assert (3, 6, 6) in sizes and sizes[-1] == (4, 8, 8)
    assert all(bs == 2 * n and cfg == bs for n, bs, cfg in sizes)


def test_resume_onto_the_saved_topology_keeps_the_cooloff(runs):
    """A fresh trainer built for 4 nodes loads the checkpoint saved after
    the first eviction: it adopts 3 nodes, the node map and the pending
    cool-off (equal to JAX's at that point), and readmits on schedule."""
    saved, jsaved = runs["run"]["saved"], runs["jrun"]["saved"]
    assert saved == jsaved
    assert saved["num_nodes"] == 3 and saved["node_map"] == [0, 1, 3]
    fresh = DistributedTrainer(TrainingConfig(checkpoint_dir=runs["ckpt"],
                                              **CONFIG),
                               model_overrides=dict(TINY,
                                                    dtype=torch.float32),
                               device="cpu")
    fresh.load_checkpoint(saved["step"])
    assert _topology(fresh) == saved
    assert fresh.state.trust.scores.shape == (3,)
    assert fresh.trust_manager.get_node_status(2) == NodeStatus.COMPROMISED
    with pytest.raises(RuntimeError, match="topology change"):
        fresh.reset_for_run()
    fresh.set_attack_plan(null_plan(3))
    dl = get_dataloader("openwebtext", batch_size=6, seq_len=16,
                        vocab_size=128, num_examples=48, seed=7)
    epoch = 0
    while fresh.config.num_nodes == 3 and epoch < 4:
        loss = fresh.train_epoch(dl, epoch)
        epoch += 1
    readmits = [r for r in fresh.reassignment_history
                if "readmitted_nodes" in r]
    assert fresh.node_map == [0, 1, 3, 2] and len(readmits) == 1
    assert readmits[0]["step"] == saved["evicted_at"][2] + \
        CONFIG["readmit_after_steps"]
    assert np.isfinite(loss) and dl.batch_size == 8


def test_other_modes_still_raise_naming_their_item():
    """The group modes evict now, as in JAX (``ELASTIC_MODES``): tensor
    mode with ``elastic_resharding`` constructs.  What JAX refuses the
    port refuses with JAX's words: a pipeline stage restaffs instead,
    and a hybrid layout whose data extent is not the node count cannot
    reshape (the trainer keeps the greedy hand-off there)."""
    assert el.ELASTIC_MODES == jel.ELASTIC_MODES
    for parallelism, kw, match in (
            ("model", {}, "restaff"),
            ("hybrid", dict(mesh_shape={"data": 2, "model": 2}),
             "hybrid elasticity requires")):
        class Stub:
            config = TrainingConfig(parallelism=parallelism, **kw)

        assert not el.elastic_supported(Stub.config)
        for fn in (el.evict_and_reshard, el.readmit_and_reshard):
            with pytest.raises(NotImplementedError, match=match):
                fn(Stub(), [0])
    tr = DistributedTrainer(TrainingConfig(parallelism="tensor",
                                           elastic_resharding=True),
                            model_overrides=dict(TINY), device="cpu")
    assert el.elastic_supported(tr.config)
    assert tr.mesh.shape == {"data": 1, "model": 1}
