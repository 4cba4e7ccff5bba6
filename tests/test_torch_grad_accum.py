"""Gradient accumulation, the fused head inside the step, and the
``attention`` remat policy: the port against itself (mirroring
``tests/test_grad_accum.py``) and against the JAX package on the CPU.

A 2-layer, 32-wide, 4-head GPT-2 (vocab 100, T = 16) over 4 nodes of 4
sequences, run as 2 microbatches of 2, from the same converted weights
and numpy batches.  The gradient-poisoning noise is JAX's own draw.

Tolerances are the port's training contract (f32 compute): per-node loss
and trust within 1e-5; after 3 clean steps params within 1e-5 (5e-5
where Adam's first update divides by a gradient within 10x of its 1e-8
epsilon); every verdict vector exactly equal.  Accumulation against the
full batch within the port: the JAX test's bounds, in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.attacks.adversarial import \
    plan_from_config as jplan_from_config
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.engine.optimizer import \
    build_optimizer as jbuild_optimizer
from trustworthy_dl_tpu.engine.state import \
    init_train_state as jinit_train_state
from trustworthy_dl_tpu.engine.step import \
    build_train_step as jbuild_train_step
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan, \
    plan_from_config
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.optimizer import build_optimizer
from trustworthy_dl_tpu_torch.engine.state import init_train_state
from trustworthy_dl_tpu_torch.engine.step import build_train_step
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models.factory import create_model
from trustworthy_dl_tpu_torch.ops import fused_ce
from trustworthy_dl_tpu_torch.ops import fused_stats as fs
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=100, n_positions=32,
            seq_len=16)
N, B, T, ACCUM = 4, 4, 16, 2
LR = 1e-3
VERDICTS = ("attacked", "verified", "finite", "byzantine", "backdoor",
            "status")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[0, 32], ids=["materialised",
                                                     "fused32"])
def sides(request):
    """Both packages' accumulated steps (head chunk 0 or 32) on the same
    converted weights; the JAX step jitted once for every plan."""
    chunk = request.param
    jbundle = jcreate_model("gpt2", dtype=jnp.float32, lm_head_chunk=chunk,
                            **TINY)
    kw = dict(num_nodes=N, batch_size=N * B, learning_rate=LR,
              detector_warmup=4, grad_accum_steps=ACCUM)
    jconfig = JTrainingConfig(**kw)
    jopt = jbuild_optimizer(jconfig)
    jstep = jax.jit(jbuild_train_step(jbundle, jconfig, jopt))
    jparams = jbundle.init(jax.random.PRNGKey(0))
    bundle = create_model("gpt2", dtype=torch.float32, lm_head_chunk=chunk,
                          **TINY)
    config = TrainingConfig(**kw)
    opt = build_optimizer(config)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return dict(chunk=chunk, jopt=jopt, jstep=jstep, jparams=jparams,
                opt=opt, step=build_train_step(bundle, config, opt),
                tparams=tparams)


def _batches(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        toks = rng.integers(0, TINY["vocab_size"], size=(N, B, T + 1))
        yield toks[..., :-1], toks[..., 1:]


def _run_both(sides, n_steps, jplan, plan):
    jp = sides["jparams"]
    jstate = jinit_train_state(jax.random.PRNGKey(1), jp,
                               sides["jopt"].init(jp), num_nodes=N,
                               detector_window=1000)
    tp = sides["tparams"]
    tstate = init_train_state(torch.Generator().manual_seed(1), tp,
                              sides["opt"].init(tree_leaves(tp)),
                              num_nodes=N, detector_window=1000)
    out = []
    fused_ce.reset_calls()
    for s, (x, y) in enumerate(_batches(n_steps)):
        noise = None
        if plan.is_live(s):
            _, _, k_grad = jax.random.split(jstate.rng, 3)
            leaves = jax.tree_util.tree_leaves(jstate.params)
            keys = jax.random.split(k_grad, len(leaves))
            noise = [torch.from_numpy(np.array(jax.random.normal(
                k, (N,) + leaf.shape, jnp.float32)))
                for k, leaf in zip(keys, leaves)]
        jstate, jm = sides["jstep"](
            jstate, {"input": jnp.asarray(x, jnp.int32),
                     "target": jnp.asarray(y, jnp.int32)}, jplan)
        tstate, tm = sides["step"](
            tstate, {"input": torch.from_numpy(x),
                     "target": torch.from_numpy(y)}, plan, grad_noise=noise)
        fields = ("per_node_loss", "trust_scores", "weights",
                  "attack_type") + VERDICTS
        out.append(({f: np.asarray(getattr(jm, f)) for f in fields},
                    {f: getattr(tm, f).numpy() for f in fields}))
    # One fused forward and backward a microbatch of every node.
    want = n_steps * N * ACCUM if sides["chunk"] else 0
    assert fused_ce.CALLS["forward"] == fused_ce.CALLS["backward"] == want
    return out, jstate, tstate


def _check_step(s, j, t):
    ctx = f"step {s}"
    np.testing.assert_allclose(t["per_node_loss"], j["per_node_loss"],
                               rtol=0, atol=1e-5, err_msg=ctx)
    np.testing.assert_allclose(t["trust_scores"], j["trust_scores"],
                               rtol=0, atol=1e-5, err_msg=ctx)
    for name in VERDICTS:
        np.testing.assert_array_equal(t[name], j[name],
                                      err_msg=f"{ctx} {name}")
    np.testing.assert_array_equal(t["weights"] > 0, j["weights"] > 0,
                                  err_msg=ctx)
    np.testing.assert_array_equal(t["attack_type"][t["attacked"]],
                                  j["attack_type"][j["attacked"]],
                                  err_msg=f"{ctx} attack_type")


def test_accumulated_clean_steps_match_jax(sides):
    steps, jstate, tstate = _run_both(sides, 3, jnull_plan(N), null_plan(N))
    for s, (j, t) in enumerate(steps):
        _check_step(s, j, t)
        assert t["weights"].min() > 0
    # Elements whose first update divided by a near-epsilon gradient
    # (|g1| < 1e-7) are held to 5e-5, all others to 1e-5.
    for a, b in zip(tree_leaves(tstate.params),
                    jax.tree_util.tree_leaves(jstate.params)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert diff.max() <= 5e-5
        assert (diff > 1e-5).mean() < 0.01


def test_accumulated_attacked_steps_match_jax(sides):
    """Gradient poisoning of node 2 from step 11, after the detector's
    (4) and the verifier's (10) warm-ups: verdicts equal every step."""
    attack = AttackConfig(attack_types=["gradient_poisoning"],
                          target_nodes=[2], intensity=1.0, start_step=11)
    steps, _, _ = _run_both(
        sides, 13, jplan_from_config(JAttackConfig(**attack.__dict__), N,
                                     True),
        plan_from_config(attack, N, True))
    for s, (j, t) in enumerate(steps):
        _check_step(s, j, t)
    gated = [s for s, (_, t) in enumerate(steps) if t["weights"][2] == 0]
    assert gated == [11, 12]
    for _, t in steps:
        assert (t["weights"][[0, 1, 3]] > 0).all()


def _trainer(accum, nodes=4, batch=16, **kw):
    config = TrainingConfig(model_name="gpt2", batch_size=batch,
                            num_nodes=nodes, learning_rate=3e-3,
                            grad_accum_steps=accum, **kw)
    trainer = DistributedTrainer(config, model_overrides=dict(TINY),
                                 device="cpu")
    trainer.initialize()
    return trainer


def test_accum_matches_full_batch():
    """bf16: accumulation of 2 equals the full batch to accumulation
    precision (the JAX test's bounds)."""
    t1, t2 = _trainer(1), _trainer(2)
    batch = t1._node_batch(t1.model.example_batch(
        16, torch.Generator().manual_seed(0)))
    plan = null_plan(4)
    s1, s2 = t1.state, t2.state
    for step in range(3):
        s1, m1 = t1._train_step(s1, batch, plan)
        s2, m2 = t2._train_step(s2, batch, plan)
        tol = 1e-4 if step == 0 else 5e-3
        np.testing.assert_allclose(float(m2.loss), float(m1.loss), rtol=tol)
        np.testing.assert_allclose(m2.per_node_loss.numpy(),
                                   m1.per_node_loss.numpy(), rtol=tol)
        np.testing.assert_allclose(float(m2.grad_norm), float(m1.grad_norm),
                                   rtol=5e-4 if step == 0 else 5e-2)
    num = den = 0.0
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        num += float(((a - b) ** 2).sum())
        den += float((a ** 2).sum())
    assert (num / den) ** 0.5 < 1e-2


def test_accum_detects_attack():
    """8 nodes, accumulation 2: node 2's gradient poisoning is confirmed
    and no other node is."""
    trainer = _trainer(2, nodes=8, detector_warmup=3)
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=0.8, start_step=6))
    attacker.activate_attacks()
    plan = attacker.plan(8)
    batch = trainer._node_batch(trainer.model.example_batch(
        16, torch.Generator().manual_seed(0)))
    state, attacked = trainer.state, set()
    for _ in range(14):
        state, metrics = trainer._train_step(state, batch, plan)
        attacked |= set(np.nonzero(metrics.attacked.numpy())[0].tolist())
        assert np.isfinite(float(metrics.loss))
    assert attacked == {2}


def test_accum_ragged_batch_trimmed():
    """Batches trim to a multiple of nodes x accumulation (4 x 3 = 12);
    one below it raises."""
    trainer = _trainer(3)
    nb = trainer._node_batch(trainer.model.example_batch(16))
    assert tuple(nb["input"].shape[:2]) == (4, 3)
    with pytest.raises(ValueError):
        trainer._node_batch(trainer.model.example_batch(8))


def test_feature_segments_past_one_launch_split(monkeypatch):
    """2 nodes x 65 microbatches = 130 feature segments, past a cap of 128
    a launch: the step splits them over launches of at most
    ``MAX_SEGMENTS`` (128, then 2) and trains.  The cap is set to 128
    here: the kernel's own (2,000) would take 1,001 microbatches a node;
    ``tests/test_torch_fused_stats.py`` splits past it."""
    sizes = []
    real = fs.fused_moments

    def counting(segments):
        sizes.append(len(segments))
        return real(segments)

    monkeypatch.setattr(fs, "MAX_SEGMENTS", 128)
    monkeypatch.setattr(fs, "fused_moments", counting)
    trainer = _trainer(65, nodes=2, batch=130)
    batch = trainer._node_batch(trainer.model.example_batch(
        130, torch.Generator().manual_seed(0)))
    _, metrics = trainer._train_step(trainer.state, batch, null_plan(2))
    assert np.isfinite(metrics.per_node_loss.numpy()).all()
    assert sizes[:2] == [fs.MAX_SEGMENTS, 130 - fs.MAX_SEGMENTS]
    assert max(sizes) <= fs.MAX_SEGMENTS


@pytest.mark.parametrize("attn_impl", ["full", "auto"])
def test_attention_remat_matches_jax_and_block_remat(attn_impl):
    """remat_policy="attention" where attention is full (``auto`` at
    T = 16 is full): loss and gradients equal JAX's under the same policy
    and the port's block remat, and it saves less than no remat and more
    than block remat."""
    geo = {k: v for k, v in TINY.items() if k != "seq_len"}
    jbundle = jcreate_model("gpt2", dtype=jnp.float32, **TINY)
    jparams = jbundle.init(jax.random.PRNGKey(3))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    x, y = next(_batches(1, seed=7))
    jcfg = jgpt2.GPT2Config(dtype=jnp.float32, remat=True,
                            remat_policy="attention", attn_impl=attn_impl,
                            **geo)
    jl, jg = jax.value_and_grad(lambda p: jgpt2.loss_with_monitor(
        p, {"input": jnp.asarray(x[0]), "target": jnp.asarray(y[0])},
        jcfg)[0])(jparams)

    def run(**kw):
        cfg = gpt2.GPT2Config(dtype=torch.float32, attn_impl=attn_impl,
                              **geo, **kw)
        leaves = [p.clone().requires_grad_() for p in tree_leaves(tparams)]
        saved = {}

        def pack(t):
            saved[t.untyped_storage().data_ptr()] = t.untyped_storage(
                ).nbytes()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = gpt2.loss_with_monitor(
                tree_unflatten(tparams, leaves),
                {"input": torch.from_numpy(x[0]),
                 "target": torch.from_numpy(y[0])}, cfg)[0]
        return loss, torch.autograd.grad(loss, leaves), sum(saved.values())

    loss, grads, saved_attn = run(remat=True, remat_policy="attention")
    b_loss, b_grads, saved_block = run(remat=True, remat_policy="block")
    _, _, saved_none = run(remat=False)
    assert saved_block < saved_attn < saved_none
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert float(loss.detach()) == float(b_loss.detach())
    for a, b, c in zip(grads, jax.tree_util.tree_leaves(jg), b_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=0, atol=1e-6)


def test_trainer_runs_accumulation_fused_head_and_attention_remat():
    """Every knob of the slice through ``DistributedTrainer.train``: two
    microbatches, the fused head at 32 columns (training and eval), and
    the attention remat policy on full attention."""
    config = TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                            learning_rate=3e-3, grad_accum_steps=2,
                            lm_head_chunk=32, remat=True,
                            remat_policy="attention", detector_warmup=2)
    trainer = DistributedTrainer(config, model_overrides=dict(
        TINY, attn_impl="full"), device="cpu")
    kw = dict(batch_size=8, seq_len=16, vocab_size=100, num_examples=24)
    fused_ce.reset_calls()
    result = trainer.train(get_dataloader("openwebtext", **kw),
                           get_dataloader("openwebtext", split="validation",
                                          **kw), num_epochs=1)
    assert fused_ce.CALLS == {"forward": 3 * 4 * 2, "backward": 3 * 4 * 2,
                              "eval": 3 * 4}
    record = result["epochs"][0]
    assert np.isfinite(record["train_loss"]) and np.isfinite(
        record["val_loss"])
    assert trainer.model.config.remat_policy == "attention"
