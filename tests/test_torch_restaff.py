"""The port's pipeline restaff (``elastic/restaff.py`` and the trainer's
model-mode elastic hooks) against the JAX package's, on the CPU; mirrors
``tests/test_restaff.py`` and the model-mode regrowth of
``tests/test_elastic_modes.py``.

One module-scoped run of each package: GPT-2 at 4 layers, 32 wide, 4
heads (vocab 307), T 16, f32, 4 stages of one layer, M = 4, batch 8 (4
steps an epoch), ``elastic_resharding`` with ``readmit_after_steps=12``,
the async host pipeline and prefetch at their defaults, the port given
JAX's initial params and canary input:

1. stage 2 poisoned from step 8: confirmed at 10, restaffed at the next
   full drain (12): 3 candidates, 4 layers -> 2 stages of 2, node 3
   parked in the idle pool (a checkpoint is saved there);
2. coordinate 1 (node 1) poisoned once the fresh baselines are warm: the
   second restaff seats the pool's node 3 (2 stages again, pool empty);
3. the attack cleared: node 2's cool-off ends and it waits in the pool
   (3 candidates still give 2 stages), then node 1's, and the pipeline
   regrows to 4 stages with every id back.

Equal to JAX's: every step's stage count, the incidents, every restaff
record (ids, idle pool, stage counts, layers a stage, step), the node map
and idle pool after each phase.  Within the training contract's 1e-5:
every step's loss and trust.  Every layer's params move after the first
restaff; the survivors keep their trust rows; the readmitted ids return
on probation (RECOVERING, trust >= 0.45); a fresh port trainer built for
4 stages restores the step-12 checkpoint onto 2 stages and continues
equal (1e-6) to the running trainer over the next epoch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.attacks.adversarial import \
    plan_from_config as jplan_from_config
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.data import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.elastic import restaff as jrestaff
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu.parallel import pipeline as jpipe
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan, \
    plan_from_config
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.elastic import reassignment as el
from trustworthy_dl_tpu_torch.elastic import restaff
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.parallel import pipeline as pipe
from trustworthy_dl_tpu_torch.trust.state import NodeStatus
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=4, n_embd=32, n_head=4, vocab_size=307, n_positions=32,
            seq_len=16)
S, B, T = 4, 8, 16
ATOL = 1e-5
CONFIG = dict(model_name="gpt2", batch_size=B, learning_rate=3e-3,
              num_nodes=S, optimizer="adamw", parallelism="model",
              num_microbatches=4, checkpoint_interval=10_000,
              detector_warmup=4, elastic_resharding=True,
              readmit_after_steps=12)
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
              intensity=0.5, start_step=8)
SKIP_KEYS = ("timestamp", "migration_time_s", "bytes_moved",
             "measured_gbps", "new_device_count")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _loader(fn, epochs_done=0):
    dl = fn("openwebtext", batch_size=B, seq_len=T,
            vocab_size=TINY["vocab_size"], num_examples=32)
    for _ in range(epochs_done):
        for _ in dl:
            pass
    return dl


def _topology(tr):
    return {"step": tr.global_step, "stages": tr.config.num_nodes,
            "node_map": list(tr.node_map), "idle_pool": sorted(tr._idle_pool),
            "evicted_at": dict(tr._evicted_at)}


def _second_plan(plan_fn, config_cls, num_nodes, start):
    return plan_fn(config_cls(attack_types=["gradient_poisoning"],
                              target_nodes=[1], intensity=0.5,
                              start_step=start),
                   num_nodes=num_nodes, active=True)


def _drive(tr, first_plan, plan_fn, config_cls, null_fn, loader_fn,
           blocks_np, save=None):
    """The module's schedule; returns what both packages are held to."""
    out = {}
    tr.set_attack_plan(first_plan)
    dl = _loader(loader_fn)

    def restaffs():
        return [r for r in tr.reassignment_history if "new_num_stages" in r]

    epoch = 0
    while not restaffs() and epoch < 6:
        tr.train_epoch(dl, epoch)
        epoch += 1
    out["first"] = _topology(tr)
    out["blocks_after_first"] = blocks_np(tr)
    out["epoch_after_first"] = epoch
    if save is not None:
        save(tr)
    victim = tr.node_map[1]
    out["plan2_start"] = tr.global_step + 4
    tr.set_attack_plan(_second_plan(plan_fn, config_cls, tr.config.num_nodes,
                                    out["plan2_start"]),
                       target_ids=[victim])
    while len(restaffs()) < 2 and epoch < 10:
        tr.train_epoch(dl, epoch)
        epoch += 1
    out["second"] = _topology(tr)
    tr.set_attack_plan(null_fn(tr.config.num_nodes))
    while tr.config.num_nodes < S and epoch < 18:
        tr.train_epoch(dl, epoch)
        epoch += 1
    out["regrown"] = _topology(tr)
    out["final_loss"] = tr.train_epoch(dl, epoch)
    out["blocks_final"] = blocks_np(tr)
    hist = tr.metrics_collector.batch_metrics
    out.update(
        steps=[h["step"] for h in hist],
        loss=[h["loss"] for h in hist],
        trust=[h["trust_scores"] for h in hist],
        stages=[len(h["trust_scores"]) for h in hist],
        incidents=[(r["node_id"], r["step"], r["attack_type"])
                   for r in tr.attack_history],
        records=[{k: v for k, v in r.items() if k not in SKIP_KEYS}
                 for r in tr.reassignment_history],
        record_keys=[sorted(r) for r in tr.reassignment_history])
    coord = tr.node_map.index(2)
    out["readmitted"] = (int(np.asarray(tr.state.trust.status)[coord]),
                         float(np.asarray(tr.state.trust.scores)[coord]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("restaff")
    jtr = JTrainer(JTrainingConfig(checkpoint_dir=str(root / "j"), **CONFIG),
                   model_overrides=dict(TINY, dtype=jnp.float32))
    jtr.initialize()
    init = jax.tree_util.tree_map(np.asarray,
                                  jax.device_get(jtr.state.params))
    init["blocks"] = jax.tree_util.tree_map(
        np.asarray, jpipe.unstack_stages(jtr.state.params["blocks"]))
    jatt = JAttacker(JAttackConfig(**ATTACK))
    jatt.activate_attacks()
    jrun = _drive(jtr, jatt.plan(S), jplan_from_config, JAttackConfig,
                  jnull_plan, jget_dataloader,
                  lambda t: [np.asarray(x) for x in jax.tree_util.tree_leaves(
                      jpipe.unstack_stages(t.state.params["blocks"]))])
    canary = np.array(jpipe.make_canary(jtr.model.config, 8))

    def jax_canary(_cfg, canary_tokens=8, canary_batch=1, device="cpu"):
        return torch.from_numpy(canary.copy()).to(device)

    ckpt = str(root / "t")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipe, "make_canary", jax_canary)
        tr = DistributedTrainer(TrainingConfig(checkpoint_dir=ckpt,
                                               **CONFIG),
                                model_overrides=dict(TINY,
                                                     dtype=torch.float32),
                                device="cpu")
        tr.initialize(params=convert.params_from_jax(init))
        att = AdversarialAttacker(AttackConfig(**ATTACK))
        att.activate_attacks()
        run = _drive(tr, att.plan(S), plan_from_config, AttackConfig,
                     null_plan, get_dataloader,
                     lambda t: [x.numpy().copy() for x in tree_leaves(
                         pipe.unstack_stages(t.state.params["blocks"]))],
                     save=lambda t: t.save_checkpoint())
        fresh = DistributedTrainer(TrainingConfig(checkpoint_dir=ckpt,
                                                  **CONFIG),
                                   model_overrides=dict(
                                       TINY, dtype=torch.float32),
                                   device="cpu")
        fresh.load_checkpoint(run["first"]["step"])
        resumed = {"topology": _topology(fresh)}
        fresh.set_attack_plan(_second_plan(
            plan_from_config, AttackConfig, fresh.config.num_nodes,
            run["plan2_start"]), target_ids=[fresh.node_map[1]])
        fresh.train_epoch(_loader(get_dataloader,
                                  run["epoch_after_first"]),
                          run["epoch_after_first"])
        resumed["steps"] = [h["step"] for h in fresh.batch_history]
        resumed["loss"] = [h["loss"] for h in fresh.batch_history]
    return dict(jrun=jrun, run=run, trainer=tr, resumed=resumed)


def test_choose_stage_count_matches_jax():
    for layers in range(1, 49):
        for max_stages in range(1, 17):
            assert restaff.choose_stage_count(layers, max_stages) == \
                jrestaff.choose_stage_count(layers, max_stages)
    assert restaff.choose_stage_count(12, 3) == 3


def test_restack_keeps_layer_order_and_moments_follow():
    blocks = {"w": torch.arange(8 * 3 * 2, dtype=torch.float32
                                ).reshape(8, 1, 3, 2)}
    restacked = restaff.restack_blocks(blocks, 4)
    assert tuple(restacked["w"].shape) == (4, 2, 3, 2)
    assert torch.equal(pipe.unstack_stages(restacked)["w"],
                       pipe.unstack_stages(blocks)["w"])
    from trustworthy_dl_tpu_torch.engine.optimizer import OptState

    opt = OptState(torch.zeros((), dtype=torch.int32),
                   [blocks["w"], torch.ones(3, 2)],
                   [blocks["w"] * 2, torch.ones(3, 2)])
    new = restaff.restack_opt_state(opt, [0], 2, 4, (8, 1))
    assert tuple(new.mu[0].shape) == tuple(new.nu[0].shape) == (4, 2, 3, 2)
    assert new.mu[1] is opt.mu[1]
    assert torch.equal(new.nu[0].reshape(-1), (blocks["w"] * 2).reshape(-1))


def test_topology_and_records_match_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    for phase in ("first", "second", "regrown"):
        assert run[phase] == jrun[phase], phase
    assert run["first"]["stages"] == 2 and run["first"]["idle_pool"] == [3]
    assert run["second"]["node_map"] == [0, 3]
    assert run["regrown"]["node_map"] == [0, 1, 2, 3]
    assert run["records"] == jrun["records"]
    assert run["record_keys"] == jrun["record_keys"]
    assert run["incidents"] == jrun["incidents"]
    assert run["steps"] == jrun["steps"]
    assert run["stages"] == jrun["stages"]


def test_second_restaff_reuses_the_idle_pool(runs):
    records = [r for r in runs["run"]["records"] if "new_num_stages" in r]
    first, second = records[0], records[1]
    assert first["evicted_nodes"] == [2] and first["idle_nodes"] == [3]
    assert (first["old_num_stages"], first["new_num_stages"],
            first["layers_per_stage"]) == (4, 2, 2)
    assert second["evicted_nodes"] == [1]
    assert second["surviving_nodes"] == [0, 3] and second["idle_nodes"] == []
    # Identities are conserved: seated + pooled + evicted.
    topo = runs["run"]["second"]
    assert set(topo["node_map"]) | set(topo["idle_pool"]) | \
        set(topo["evicted_at"]) == set(range(S))


def test_losses_and_trust_within_the_training_contract(runs):
    run, jrun = runs["run"], runs["jrun"]
    np.testing.assert_allclose(run["loss"], jrun["loss"], rtol=0, atol=ATOL)
    for got, want in zip(run["trust"], jrun["trust"]):
        assert sorted(got) == sorted(want)
        for nid in want:
            assert abs(got[nid] - want[nid]) <= ATOL, (nid, got, want)
    assert np.isfinite(run["final_loss"])


def test_every_layer_keeps_training_after_the_restaff(runs):
    run = runs["run"]
    for before, after in zip(run["blocks_after_first"],
                             run["blocks_final"]):
        deltas = np.sqrt(((after - before) ** 2).reshape(
            before.shape[0], -1).sum(axis=1))
        assert (deltas > 0).all(), deltas


def test_survivors_keep_their_trust(runs):
    tr, run = runs["trainer"], runs["run"]
    first = [r for r in run["records"] if "new_num_stages" in r][0]
    step = first["step"]
    before = run["trust"][run["steps"].index(step)]
    after = run["trust"][run["steps"].index(step + 1)]
    for nid in first["surviving_nodes"]:
        # The row carried over: one more EMA step from where it stood.
        assert abs(after[nid] - before[nid]) < 0.05, (nid, before, after)
        assert after[nid] > 0.5
    assert tr.trust_manager.get_node_status(2) != NodeStatus.COMPROMISED
    assert tr.trust_manager.get_trust_score(0) > 0.5


def test_readmitted_stages_are_on_probation(runs):
    status, score = runs["run"]["readmitted"]
    assert status != int(NodeStatus.COMPROMISED)
    assert score >= 0.45
    assert runs["run"]["readmitted"][0] == runs["jrun"]["readmitted"][0]
    assert abs(score - runs["jrun"]["readmitted"][1]) <= ATOL


def test_resume_after_the_restaff_continues_equal(runs):
    run, resumed = runs["run"], runs["resumed"]
    assert resumed["topology"] == run["first"]
    idx = [run["steps"].index(s) for s in resumed["steps"]]
    assert resumed["steps"] and resumed["steps"][0] == run["first"]["step"] + 1
    np.testing.assert_allclose(resumed["loss"], [run["loss"][i] for i in idx],
                               rtol=0, atol=1e-6)


def test_model_mode_eviction_routes_to_the_restaff():
    class Stub:
        config = TrainingConfig(parallelism="model")

    for fn in (el.evict_and_reshard, el.readmit_and_reshard):
        with pytest.raises(NotImplementedError, match="restaff"):
            fn(Stub(), [0])
    assert el.ELASTIC_MODES == ("data", "tensor", "sequence", "expert",
                                "hybrid")
    with pytest.raises(ValueError, match="parallelism='model'"):
        restaff.restaff_pipeline(type("T", (), {
            "config": dataclasses.replace(Stub.config,
                                          parallelism="data")})(), [0])
