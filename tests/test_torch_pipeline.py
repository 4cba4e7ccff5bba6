"""The port's pipeline (stage) parallelism (``parallel/pipeline.py``, the
trainer's ``model`` branches) against the JAX package's, on the CPU.

JAX's ``tests/test_pipeline.py`` geometry: GPT-2 at 8 layers, 32 wide, 4
heads (vocab 293, a size no other test file compiles), T = 16, f32
compute, S = 4 stages of 2 layers, M = 4 microbatches, JAX on the
conftest's virtual CPU devices (a (1, 4) data x stage mesh), the port on
its one-CPU mesh.  The same numpy tokens and converted weights go through
both; the canary input is JAX's draw (``jax.random.normal(PRNGKey(
0xCA9A12))``, which torch cannot reproduce), handed to the port.

Tolerances (f32 on both sides; only summation orders differ):
  * ``stack_stages`` / ``unstack_stages`` exact; ``choose_num_microbatches``
    (its warning included), ``bubble_fraction`` equal over a grid;
  * the pipeline's outputs, ``act_mean`` and ``act_std`` within 1e-5, the
    boundary batteries within 1e-5 relative and absolute (L1 and L2 norms
    are sums over 4,096 values);
  * the pipelined loss and every gradient within 1e-5 of JAX's pipeline,
    and both within JAX's own test tolerance (rtol 5e-2, atol 5e-3) of
    the port's sequential forward; they meet it at 1e-5;
  * ``canary_probe``'s state within 1e-5, ``byz`` and ``backdoor``
    equal; ``corrupt_stage_compute`` with JAX's noise within 1e-6;
  * the trainer under gradient poisoning of stage 2 from step 8 (JAX's
    fixture at 4 stages): every step's loss and trust within 1e-5 (the
    attacked stage's noise is each package's own draw; the stage is gated
    from its first attacked step), the incidents, the gating and the
    frozen stage equal, the clean stages trusted, validation loss and
    accuracy within 1e-5 (perplexity, their exp, within 1e-5 relative).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.attacks.adversarial import \
    corrupt_stage_compute as jcorrupt
from trustworthy_dl_tpu.attacks.adversarial import \
    plan_from_config as jplan_from_config
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core import sharding as jsharding
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.core.mesh import build_mesh as jbuild_mesh
from trustworthy_dl_tpu.data import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu.experiments.runner import \
    ExperimentRunner as JExperimentRunner
from trustworthy_dl_tpu.experiments.runner import \
    preset_config as jpreset_config
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models import layers as jL
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu.parallel import pipeline as jpipe
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.attacks.adversarial import \
    corrupt_stage_compute, plan_from_config
from trustworthy_dl_tpu_torch.core import mesh as tmesh
from trustworthy_dl_tpu_torch.core import sharding as tsharding
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.experiments.runner import ExperimentRunner, \
    preset_config
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.models.factory import create_model
from trustworthy_dl_tpu_torch.parallel import pipeline as pipe
from trustworthy_dl_tpu_torch.trust.state import NodeStatus
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=8, n_embd=32, n_head=4, vocab_size=293, n_positions=32,
            seq_len=16)
S, M, B, T = 4, 4, 8, 16
ATOL = 1e-5
CONFIG = dict(model_name="gpt2", batch_size=B, learning_rate=3e-3,
              num_nodes=S, optimizer="adamw", parallelism="model",
              num_microbatches=M, checkpoint_interval=10_000,
              detector_warmup=4)
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
              intensity=0.5, start_step=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def models():
    """Both bundles and JAX's params (unstacked), converted."""
    jb = jcreate_model("gpt2", **TINY, dtype=jnp.float32)
    jparams = jb.init(jax.random.PRNGKey(0))
    tb = create_model("gpt2", **TINY, dtype=torch.float32)
    return dict(jb=jb, jparams=jparams, tb=tb,
                tparams=convert.params_from_jax(_np(jparams)))


def _canary_np(cfg, tokens=8):
    return np.asarray(jpipe.make_canary(cfg, tokens))


def _patch_canary(mp, cfg):
    """The port's pipeline draws JAX's canary."""
    def jax_canary(_cfg, canary_tokens=8, canary_batch=1, device="cpu"):
        return torch.from_numpy(_canary_np(cfg, canary_tokens).copy()
                                ).to(device)

    mp.setattr(pipe, "make_canary", jax_canary)


def _close(a, b, atol=ATOL, rtol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                               np.asarray(b, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


# --------------------------------------------------------------------------
# Schedule arithmetic
# --------------------------------------------------------------------------

def test_stack_unstack_match_jax_and_refuse_alike(models):
    blocks = _np(models["jparams"]["blocks"])
    tblocks = models["tparams"]["blocks"]
    for stages in (1, 2, 4, 8):
        want = _np(jpipe.stack_stages(blocks, stages))
        got = pipe.stack_stages(tblocks, stages)
        for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
            np.testing.assert_array_equal(a, b.numpy())
        back = pipe.unstack_stages(got)
        for a, b in zip(tree_leaves(tblocks), tree_leaves(back)):
            assert torch.equal(a, b)
    for stages in (3, 5, 6):
        with pytest.raises(ValueError) as jerr:
            jpipe.stack_stages(blocks, stages)
        with pytest.raises(ValueError) as terr:
            pipe.stack_stages(tblocks, stages)
        assert str(terr.value) == str(jerr.value) == \
            f"8 layers not divisible by {stages} stages"


@pytest.mark.parametrize("dp", [1, 2])
def test_choose_num_microbatches_matches_jax(dp):
    for batch in range(1, 130):
        for stages in (1, 2, 3, 4, 8):
            assert pipe.choose_num_microbatches(batch, stages, dp) == \
                jpipe.choose_num_microbatches(batch, stages, dp), \
                (batch, stages, dp)


def test_trim_tolerant_fallback_warns_like_jax(caplog):
    with caplog.at_level(logging.WARNING):
        assert pipe.choose_num_microbatches(13, 2) == 6
        assert jpipe.choose_num_microbatches(13, 2) == 6
    msgs = [r.getMessage() for r in caplog.records
            if "trim-tolerant" in r.getMessage()]
    assert len(msgs) == 2 and msgs[0] == msgs[1]


def test_bubble_fraction_matches_jax():
    for stages in range(1, 9):
        for m in range(1, 40):
            assert pipe.bubble_fraction(stages, m) == \
                jpipe.bubble_fraction(stages, m)


def test_mesh_and_rules():
    mesh = tmesh.build_mesh(S, "model")
    jmesh = jbuild_mesh(S, "model")
    assert mesh.shape == dict(jmesh.shape) == {"data": 1, "stage": S}
    assert mesh.axis_names == tuple(jmesh.axis_names)
    assert tmesh.stage_devices(mesh) == [torch.device("cpu")] * S
    assert tmesh.build_mesh(4, "data").shape == {"data": 1}
    assert tmesh.node_axis_for("model") == "stage"
    for mode in ("data", "model", "tensor", "sequence", "expert", "hybrid"):
        jrules = jsharding.rules_for(mode)
        rules = tsharding.rules_for(mode)
        assert dict(rules.table) == dict(jrules.table)
        assert rules.partition_spec("stage", None) == \
            tuple(jrules.partition_spec("stage", None))
    # The tensor and expert arms without positions: JAX's one-device
    # layout; hybrid needs its mesh_shape in both packages.
    one = jbuild_mesh(S, "data").devices.flat[:1]
    for mode in ("tensor", "expert"):
        jone = jbuild_mesh(4, mode, devices=list(one))
        assert tmesh.build_mesh(4, mode).shape == dict(jone.shape)
    for build in (tmesh.build_mesh, jbuild_mesh):
        with pytest.raises(ValueError, match="requires mesh_shape"):
            build(4, "hybrid")
    assert tmesh.build_mesh(4, "sequence").shape == {"data": 1, "seq": 1}
    place = tsharding.row_placer(mesh, "stage", S)
    assert place(torch.ones(S, 2)).device == torch.device("cpu")
    assert tsharding.tree_bytes_per_device(
        {"a": torch.ones(4, 2), "b": [torch.ones(3)]}) == 44


# --------------------------------------------------------------------------
# The schedule: apply, loss and gradients
# --------------------------------------------------------------------------

def _tokens(rows, width, seed):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], (rows, width)).astype(np.int32)


def test_pipeline_apply_matches_jax(models):
    jb, jparams = models["jb"], models["jparams"]
    tokens = _tokens(B, T, 1)
    jx = jgpt2.embed(jparams, jnp.asarray(tokens), jb.config)
    jfn = jpipe.build_pipeline_apply(jb.config, jbuild_mesh(S, "model"), S,
                                     M)
    jy, jstats, jmean, jstd = jax.jit(jfn)(
        jpipe.stack_stages(jparams["blocks"], S),
        jx.reshape(M, B // M, T, -1))
    tparams = models["tparams"]
    fn = pipe.build_pipeline_apply(models["tb"].config,
                                   tmesh.build_mesh(S, "model"), S, M)
    x = gpt2.embed(tparams, torch.from_numpy(tokens).long())
    with torch.no_grad():
        y, stats, mean, std = fn(pipe.stack_stages(tparams["blocks"], S),
                                 x.reshape(M, B // M, T, -1))
    _close(y, jy, what="outputs")
    assert tuple(stats.shape) == (S, 17)
    _close(stats, jstats, atol=ATOL, rtol=ATOL, what="stage stats")
    _close(mean, jmean, what="act_mean")
    _close(std, jstd, what="act_std")
    # The sequential model gives the same activations.
    with torch.no_grad():
        seq = gpt2.apply_blocks(tparams["blocks"], x, models["tb"].config)
    _close(y.reshape(B, T, -1), seq, what="sequential")


def test_pipeline_loss_and_grads_match_jax_and_sequential(models):
    jb, jparams = models["jb"], models["jparams"]
    tokens = _tokens(B, T + 1, 2)
    batch = {"input": tokens[:, :-1], "target": tokens[:, 1:]}
    jfn = jpipe.build_pipeline_apply(jb.config, jbuild_mesh(S, "model"), S,
                                     M)

    def jloss(p, b):
        x = jgpt2.embed(p, b["input"], jb.config)
        y, _, _, _ = jfn(p["blocks"], x.reshape(M, B // M, T, -1))
        return jL.cross_entropy_loss(
            jgpt2.unembed(p, y.reshape(B, T, -1), jb.config), b["target"])

    jstacked = dict(jparams, blocks=jpipe.stack_stages(jparams["blocks"], S))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jstacked, {k: jnp.asarray(v) for k, v in batch.items()})
    jg = _np(dict(jg, blocks=jpipe.unstack_stages(jg["blocks"])))

    cfg = models["tb"].config
    fn = pipe.build_pipeline_apply(cfg, tmesh.build_mesh(S, "model"), S, M)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}

    def grads_of(params, loss_fn):
        leaves = [p.detach().clone().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def piped(p):
        x = gpt2.embed(p, tb["input"])
        y = fn(p["blocks"], x.reshape(M, B // M, T, -1))[0]
        return L.cross_entropy_loss(gpt2.unembed(p, y.reshape(B, T, -1),
                                                 cfg), tb["target"])

    tparams = models["tparams"]
    stacked = dict(tparams, blocks=pipe.stack_stages(tparams["blocks"], S))
    loss, grads = grads_of(stacked, piped)
    seq_loss, seq_grads = grads_of(tparams, lambda p: models["tb"].loss(
        p, tb))
    _close(loss, jl, what="loss")
    _close(seq_loss, loss, what="sequential loss")
    shapes = [tuple(g.shape) for g in seq_grads]
    flat_j = jax.tree_util.tree_leaves(jg)
    for g, sg, jgl, shape in zip(grads, seq_grads, flat_j, shapes):
        g = g.reshape(shape)
        _close(g, jgl, what="grad vs JAX")
        np.testing.assert_allclose(g.numpy(), sg.numpy(), rtol=5e-2,
                                   atol=5e-3)
        _close(g, sg, what="grad vs sequential")


# --------------------------------------------------------------------------
# Canary and stage-compute corruption
# --------------------------------------------------------------------------

def test_canary_probe_matches_jax(models):
    jb, jparams = models["jb"], models["jparams"]
    jstacked = jpipe.stack_stages(jparams["blocks"], S)
    jcanary = jpipe.make_canary(jb.config, 8)
    jstate = jpipe.init_canary_state(S, jcanary)
    canary = torch.from_numpy(np.array(jcanary))
    state = pipe.init_canary_state(S, canary)
    stacked = pipe.stack_stages(models["tparams"]["blocks"], S)
    noise = [np.random.default_rng(9 + i).standard_normal(
        np.asarray(x).shape).astype(np.float32)
        for i, x in enumerate(jax.tree_util.tree_leaves(jstacked))]
    mask = np.zeros((S, 1), np.float32)
    mask[2] = 3.0

    jcorrupted = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jstacked),
        [np.asarray(x) + mask.reshape((S,) + (1,) * (z.ndim - 1)) * z
         for x, z in zip(jax.tree_util.tree_leaves(jstacked), noise)])
    tcorrupted = convert.params_from_jax(
        _np(dict(jparams, blocks=jcorrupted)))["blocks"]
    plan = [(jstacked, stacked)] * 3 + [(jcorrupted, tcorrupted)] + \
        [(jstacked, stacked)]
    seen = []
    for jblocks, tblocks in plan:
        jstate, jbyz, jback = jpipe.canary_probe(jstate, jblocks, jcanary,
                                                 jb.config, warmup=2)
        state, byz, back = pipe.canary_probe(state, tblocks, canary,
                                             models["tb"].config, warmup=2)
        _close(state.prev, jstate.prev, what="prev")
        _close(state.sig_ema, jstate.sig_ema, what="sig_ema")
        assert int(state.count) == int(jstate.count)
        assert byz.tolist() == np.asarray(jbyz).tolist()
        assert back.tolist() == np.asarray(jback).tolist()
        seen.append(byz.tolist())
    assert seen[3] == [False, False, True, False]
    assert not any(any(v) for v in seen[:3] + seen[4:])


def test_corrupt_stage_compute_matches_jax(models):
    jstacked = jpipe.stack_stages(models["jparams"]["blocks"], S)
    jplan = jplan_from_config(JAttackConfig(
        attack_types=["byzantine"], target_nodes=[1], intensity=0.5,
        start_step=0), num_nodes=S, active=True)
    plan = plan_from_config(AttackConfig(
        attack_types=["byzantine"], target_nodes=[1], intensity=0.5,
        start_step=0), num_nodes=S, active=True)
    rng = jax.random.PRNGKey(7)
    want = _np(jcorrupt(jplan, jstacked, jnp.int32(3), rng))
    leaves = jax.tree_util.tree_leaves(jstacked)
    keys = jax.random.split(rng, len(leaves))
    noise = [torch.from_numpy(np.array(jax.random.normal(
        k, x.shape, x.dtype))) for k, x in zip(keys, leaves)]
    tleaves = [torch.from_numpy(np.array(x)) for x in leaves]
    got = corrupt_stage_compute(plan, tleaves, 3, noise=noise)
    for a, b, orig in zip(got, jax.tree_util.tree_leaves(want), tleaves):
        _close(a, b, atol=1e-6, what="corrupted leaf")
        assert torch.equal(a[0], orig[0]) and not torch.equal(a[1], orig[1])
    # Not live, or not Byzantine: the blocks pass through.
    assert all(x is y for x, y in zip(corrupt_stage_compute(
        plan._replace(active=False), tleaves, 3), tleaves))


# --------------------------------------------------------------------------
# The trainer
# --------------------------------------------------------------------------

def _capture_jax_gates(jtr):
    """JAX's batch records hold no gate: read each recorded step's."""
    seen = []
    record = jtr._record_batch

    def wrapped(metrics, epoch, loss):
        seen.append({"weights": np.asarray(metrics.weights).tolist(),
                     "attacked": np.asarray(metrics.attacked).tolist()})
        return record(metrics, epoch, loss)

    jtr._record_batch = wrapped
    return seen


def _drive(trainer, plan, loader_fn, epochs=2, gates=None):
    trainer.set_attack_plan(plan)
    dl = loader_fn("openwebtext", batch_size=B, seq_len=T,
                   vocab_size=TINY["vocab_size"], num_examples=64)
    epoch_losses = [trainer.train_epoch(dl, e) for e in range(epochs)]
    hist = trainer.metrics_collector.batch_metrics
    gates = hist if gates is None else gates
    val = loader_fn("openwebtext", split="validation", batch_size=B,
                    seq_len=T, vocab_size=TINY["vocab_size"],
                    num_examples=16)
    return dict(
        epoch_losses=epoch_losses,
        loss=[h["loss"] for h in hist],
        trust=[[h["trust_scores"][i] for i in range(S)] for h in hist],
        weights=[list(g["weights"]) for g in gates],
        attacked=[list(g["attacked"]) for g in gates],
        incidents=[(r["node_id"], r["step"], r["attack_type"])
                   for r in trainer.attack_history],
        status={i: trainer.trust_manager.get_node_status(i).name
                for i in range(S)},
        val=trainer.validate_metrics(val))


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    root = tmp_path_factory.mktemp("pipe")
    overrides = dict(TINY, dtype=jnp.float32)
    jtr = JTrainer(JTrainingConfig(checkpoint_dir=str(root / "j"), **CONFIG),
                   model_overrides=overrides)
    jtr.initialize()
    init = _np(jtr.state.params)
    init["blocks"] = _np(jpipe.unstack_stages(jtr.state.params["blocks"]))
    jatt = JAttacker(JAttackConfig(**ATTACK))
    jatt.activate_attacks()
    jrun = _drive(jtr, jatt.plan(S), jget_dataloader,
                  gates=_capture_jax_gates(jtr))

    with pytest.MonkeyPatch.context() as mp:
        _patch_canary(mp, jtr.model.config)
        tr = DistributedTrainer(TrainingConfig(
            checkpoint_dir=str(root / "t"), **CONFIG),
            model_overrides=dict(TINY, dtype=torch.float32), device="cpu")
        tr.initialize(params=convert.params_from_jax(init))
        att = AdversarialAttacker(AttackConfig(**ATTACK))
        att.activate_attacks()
        run = _drive(tr, att.plan(S), get_dataloader)
    return dict(jrun=jrun, run=run, trainer=tr, jtrainer=jtr)


def test_trainer_losses_and_trust_match_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    assert len(run["loss"]) == len(jrun["loss"]) == 16
    _close(run["loss"], jrun["loss"], what="loss")
    _close(run["trust"], jrun["trust"], what="trust")
    _close(run["epoch_losses"], jrun["epoch_losses"], what="epoch losses")
    assert run["epoch_losses"][-1] < run["epoch_losses"][0]


def test_trainer_verdicts_and_incidents_match_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    assert run["incidents"] == jrun["incidents"]
    assert [i[0] for i in run["incidents"]] == [2]
    assert run["attacked"] == jrun["attacked"]
    assert [[w > 0 for w in ws] for ws in run["weights"]] == \
        [[w > 0 for w in ws] for ws in jrun["weights"]]
    assert run["status"] == jrun["status"]
    # Stage 2 frozen from its first attacked step, nothing before.
    for step, ws in enumerate(run["weights"]):
        assert (ws[2] == 0) == (step >= ATTACK["start_step"]), (step, ws)
    assert runs["trainer"].trust_manager.get_node_status(2) == \
        NodeStatus.COMPROMISED


def test_trainer_clean_stages_unaffected(runs):
    run, tr = runs["run"], runs["trainer"]
    for stage in (0, 1, 3):
        assert all(ws[stage] > 0 for ws in run["weights"])
        assert tr.trust_manager.get_trust_score(stage) > 0.5
    assert tr.trust_manager.get_trust_score(2) < 0.3
    assert int(tr.state.canary.count) == 16


def test_trainer_validation_matches_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    for key in ("loss", "accuracy"):
        _close(run["val"][key], jrun["val"][key], what=key)
    # exp of a loss within 1e-5: within 1e-5 relative.
    _close(run["val"]["perplexity"], jrun["val"]["perplexity"], atol=0.0,
           rtol=ATOL, what="perplexity")


def test_nan_stage_does_not_corrupt_the_params(tmp_path):
    """A stage emitting infinite-intensity poison is gated; no param
    takes a NaN (JAX's ``test_pipeline_nan_stage_does_not_corrupt``)."""
    tr = DistributedTrainer(TrainingConfig(
        checkpoint_dir=str(tmp_path), **CONFIG),
        model_overrides=dict(TINY, dtype=torch.float32), device="cpu")
    tr.initialize()
    att = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[3],
        intensity=float("inf"), start_step=0))
    att.activate_attacks()
    tr.set_attack_plan(att.plan(S))
    loss = tr.train_epoch(get_dataloader(
        "openwebtext", batch_size=B, seq_len=T,
        vocab_size=TINY["vocab_size"], num_examples=32), 0)
    assert np.isfinite(loss)
    for leaf in tree_leaves(tr.state.params):
        assert bool(torch.isfinite(leaf).all())
    assert all(h["weights"][3] == 0 for h in tr.batch_history)


def test_byzantine_stage_caught_by_the_canary(tmp_path):
    """Byzantine compute on stage 1 from step 5: the canary flags it as
    ``byzantine`` at once, no other stage is flagged, the losses stay
    finite and every attacked step skips the update."""
    tr = DistributedTrainer(TrainingConfig(
        checkpoint_dir=str(tmp_path), **CONFIG),
        model_overrides=dict(TINY, dtype=torch.float32), device="cpu")
    tr.initialize()
    att = AdversarialAttacker(AttackConfig(
        attack_types=["byzantine"], target_nodes=[1], intensity=0.5,
        start_step=5))
    att.activate_attacks()
    tr.set_attack_plan(att.plan(S))
    losses = [tr.train_epoch(get_dataloader(
        "openwebtext", batch_size=B, seq_len=T,
        vocab_size=TINY["vocab_size"], num_examples=48), e)
        for e in range(2)]
    assert np.isfinite(losses).all()
    assert [(r["node_id"], r["step"], r["attack_type"])
            for r in tr.attack_history] == [(1, 6, "byzantine")]
    hist = tr.batch_history
    assert all(h["attacked"][1] for h in hist[5:])
    assert not any(h["attacked"][i] for h in hist for i in (0, 2, 3))
    for stage in (0, 2, 3):
        assert tr.trust_manager.get_trust_score(stage) > 0.5


def test_cli_trains_with_parallelism_model(capsys, tmp_path):
    tiny = {k: v for k, v in TINY.items() if k != "seq_len"}
    rc = cli.train_main(["--parallelism", "model", "--device", "cpu",
                         "--nodes", "4", "--batch-size", "8", "--seq-len",
                         "16", "--steps-per-epoch", "3", "--epochs", "1",
                         "--checkpoint-dir", str(tmp_path / "ck")],
                        model_overrides=dict(tiny, dtype=torch.float32))
    out = capsys.readouterr().out
    assert rc == 0 and "Training completed: 3 steps" in out
    # A pipeline checkpoint the port trained: serve and generate refuse it.
    rc = cli.generate_main(["--device", "cpu", "--checkpoint-dir",
                            str(tmp_path / "ck"), "--max-new-tokens", "4"],
                           model_overrides=dict(tiny, dtype=torch.float32))
    assert rc == 2
    assert "pipeline (stage) parallelism" in capsys.readouterr().out
    rc = cli.serve_main(["--device", "cpu", "--checkpoint-dir",
                         str(tmp_path / "ck")],
                        model_overrides=dict(tiny, dtype=torch.float32))
    assert rc == 2
    assert "pipeline (stage) parallelism" in capsys.readouterr().out


def test_pipeline_preset_refused_alike(tmp_path):
    """JAX's preset ``gpt2_small_pipeline_clean`` asks for 8 stages of
    GPT-2 small's 12 layers: both packages refuse it when initialised,
    with the same error (narrow widths, the preset's 12 layers)."""
    narrow = dict(n_embd=32, n_head=4, vocab_size=TINY["vocab_size"],
                  n_positions=32)
    jrunner = JExperimentRunner(jpreset_config(
        "gpt2_small_pipeline_clean", output_dir=str(tmp_path / "j"),
        num_epochs=1), model_overrides=dict(narrow, dtype=jnp.float32),
        data_overrides=dict(seq_len=16, num_examples=32))
    runner = ExperimentRunner(preset_config(
        "gpt2_small_pipeline_clean", output_dir=str(tmp_path / "t"),
        num_epochs=1), model_overrides=dict(narrow, dtype=torch.float32),
        data_overrides=dict(seq_len=16, num_examples=32), device="cpu")
    with pytest.raises(ValueError) as jerr:
        jrunner.setup_experiment()
    with pytest.raises(ValueError) as terr:
        runner.setup_experiment()
    assert str(terr.value) == str(jerr.value) == \
        "12 layers not divisible by 8 stages"
