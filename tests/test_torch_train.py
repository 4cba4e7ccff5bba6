"""The port's trusted training step, stage by stage, against the JAX
package's on the CPU: a 2-layer, 64-wide, 4-head GPT-2 (vocab 229,
T = 64, f32 compute) over 4 nodes, from the same converted weights and the
same numpy batches; the gradient-poisoning noise is JAX's own draw,
handed to the port's ``poison_gradients``.

Tolerances (f32 on both sides; only summation orders differ):
  * per-node loss within 1e-5, trust scores within 1e-5, parameters after
    3 steps at lr 1e-3 within 1e-5 (5e-5 where Adam's first denominator
    is dominated by its epsilon, see the test);
  * the 17-stat batteries within rel 1e-4 plus 1e-4 of the node's own
    std stat (location stats of near-zero-mean data), kurtosis within
    rel 1e-3, and the dimensionless skewness and cosine similarity
    within 1e-4 (each a small difference of f32 raw-moment sums);
  * verdicts exactly equal: attacked, verified, finite, byzantine,
    backdoor, status, which weights are > 0, and attack_type wherever it
    is defined (on confirmed nodes; elsewhere it is the argmax of
    noise-level z-scores, which two summation orders may break
    differently when two families tie);
  * the model's loss, features, mean logits and gradients within 1e-5,
    with and without block remat; optimizer updates within 1e-6.

The trainer runs the canonical drive (``.claude/skills/verify/SKILL.md``:
tiny GPT-2, gradient poisoning of node 2 from step 8) on both packages;
the incidents must name the same node and attack type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.attacks.adversarial import \
    plan_from_config as jplan_from_config
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.data.loader import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.engine.optimizer import \
    build_optimizer as jbuild_optimizer
from trustworthy_dl_tpu.engine.state import \
    init_train_state as jinit_train_state
from trustworthy_dl_tpu.engine.step import \
    build_train_step as jbuild_train_step
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan, \
    plan_from_config
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data.loader import get_dataloader
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.engine.optimizer import Optimizer, \
    build_optimizer, build_schedule
from trustworthy_dl_tpu_torch.engine.state import init_train_state
from trustworthy_dl_tpu_torch.engine.step import build_train_step
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models.factory import create_model
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.torchport

# vocab 229 / 227: sizes no other test file uses, so the JAX programs this
# file compiles are its own in the process-global jit cache.
TINY = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=229, n_positions=64,
            seq_len=64)
N, B, T = 4, 2, 64
LR = 1e-3
VERDICTS = ("attacked", "verified", "finite", "byzantine", "backdoor",
            "status")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sides():
    """The JAX step (jitted once for every plan) and the port's, on the
    same converted weights."""
    jbundle = jcreate_model("gpt2", dtype=jnp.float32, **TINY)
    jconfig = JTrainingConfig(num_nodes=N, batch_size=N * B,
                              learning_rate=LR, detector_warmup=4)
    jopt = jbuild_optimizer(jconfig)
    jstep = jax.jit(jbuild_train_step(jbundle, jconfig, jopt))
    jparams = jbundle.init(jax.random.PRNGKey(0))

    bundle = create_model("gpt2", dtype=torch.float32, **TINY)
    config = TrainingConfig(num_nodes=N, batch_size=N * B,
                            learning_rate=LR, detector_warmup=4)
    opt = build_optimizer(config)
    step = build_train_step(bundle, config, opt)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return dict(jbundle=jbundle, jconfig=jconfig, jopt=jopt, jstep=jstep,
                jparams=jparams, bundle=bundle, config=config, opt=opt,
                step=step, tparams=tparams)


def _batches(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        toks = rng.integers(0, TINY["vocab_size"], size=(N, B, T + 1))
        yield toks[..., :-1], toks[..., 1:]


def _run_both(sides, n_steps, jplan, plan):
    """Step both packages through the same batches; returns per-step
    (jax metrics, port metrics) as numpy dicts and the final states."""
    jp = sides["jparams"]
    jstate = jinit_train_state(jax.random.PRNGKey(1), jp,
                               sides["jopt"].init(jp), num_nodes=N,
                               detector_window=1000)
    tp = sides["tparams"]
    tstate = init_train_state(torch.Generator().manual_seed(1), tp,
                              sides["opt"].init(tree_leaves(tp)),
                              num_nodes=N, detector_window=1000)
    out, tstates = [], []
    for s, (x, y) in enumerate(_batches(n_steps)):
        noise = None
        if plan.is_live(s):
            # JAX's own draws (engine/step.py: split the state's key in
            # three, the third into one key per gradient leaf).
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
        fields = [f for f in tm._fields if f not in ("model_aux",
                                                     "fleet_alert")]
        out.append(({f: np.asarray(getattr(jm, f)) for f in fields},
                    {f: getattr(tm, f).numpy() for f in fields}))
        tstates.append(tstate)
    return out, jstate, tstates


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
    # attack_type is defined where a node is confirmed (elsewhere it is
    # the argmax of noise-level signature z-scores).
    np.testing.assert_array_equal(t["attack_type"][t["attacked"]],
                                  j["attack_type"][j["attacked"]],
                                  err_msg=f"{ctx} attack_type")
    kurt = st.STAT_INDEX["kurtosis"]
    shape = [st.STAT_INDEX["skewness"], st.STAT_INDEX["cosine_similarity"]]
    for key in ("out_stats", "grad_stats"):
        for node in range(len(j[key])):
            a, b = t[key][node], j[key][node]
            scale = abs(b[st.STAT_INDEX["std"]])
            cols = [c for c in range(st.NUM_GRADIENT_STATS)
                    if c != kurt and c not in shape]
            np.testing.assert_allclose(a[cols], b[cols], rtol=1e-4,
                                       atol=1e-4 * scale,
                                       err_msg=f"{ctx} {key} node {node}")
            np.testing.assert_allclose(a[kurt], b[kurt], rtol=1e-3,
                                       err_msg=f"{ctx} {key} kurtosis")
            np.testing.assert_allclose(a[shape], b[shape], rtol=0,
                                       atol=1e-4,
                                       err_msg=f"{ctx} {key} skew/cosine")


def test_clean_steps_match_jax_stage_by_stage(sides):
    """3 clean steps; then the params.  Adam's first update is
    ``lr * g / (|g| + 1e-8)``: where the first aggregated gradient is
    within 10x of that epsilon (|g| < 1e-7), an f32 rounding difference
    of g moves the update by a share of lr, so those elements are held
    to 5e-5 (5 % of lr) and every other element to 1e-5."""
    steps, jstate, tstates = _run_both(sides, 3, jnull_plan(N),
                                       null_plan(N))
    for s, (j, t) in enumerate(steps):
        _check_step(s, j, t)
        assert t["weights"].min() > 0
    first_g = [m / 0.1 for m in tstates[0].opt_state.mu]   # mu1 = 0.1 g1
    held = total = 0
    for a, b, g in zip(tree_leaves(tstates[-1].params),
                       jax.tree_util.tree_leaves(jstate.params), first_g):
        diff = np.abs(a.numpy() - np.asarray(b))
        well_posed = g.abs().numpy() >= 1e-7
        held, total = held + well_posed.sum(), total + well_posed.size
        assert diff[well_posed].max(initial=0.0) <= 1e-5
        assert diff.max() <= 5e-5
    assert held / total > 0.99
    assert int(tstates[-1].opt_state.count) == 3


def test_attacked_steps_match_jax_stage_by_stage(sides):
    """Gradient poisoning of node 2 from step 11: after the detector's
    (4) and the verifier's (10) warm-ups, as on the card."""
    attack = AttackConfig(attack_types=["gradient_poisoning"],
                          target_nodes=[2], intensity=1.0, start_step=11)
    jattack = JAttackConfig(**attack.__dict__)
    steps, _, _ = _run_both(sides, 14, jplan_from_config(jattack, N, True),
                            plan_from_config(attack, N, True))
    for s, (j, t) in enumerate(steps):
        _check_step(s, j, t)
    gated = [s for s, (_, t) in enumerate(steps) if t["weights"][2] == 0]
    confirmed = [s for s, (_, t) in enumerate(steps) if t["attacked"][2]]
    assert gated == [11, 12, 13] and confirmed[0] == 12, (gated, confirmed)
    for _, t in steps:
        assert (t["weights"][[0, 1, 3]] > 0).all()
        assert not t["attacked"][[0, 1, 3]].any()


def test_all_gated_step_skips_the_update(sides):
    """Every node poisoned to infinity: every node is gated, and params AND
    optimizer state (the count included) pass through unchanged."""
    attack = AttackConfig(attack_types=["gradient_poisoning"],
                          target_nodes=[0, 1, 2, 3],
                          intensity=float("inf"), start_step=0)
    jattack = JAttackConfig(**attack.__dict__)
    steps, _, tstates = _run_both(
        sides, 1, jplan_from_config(jattack, N, True),
        plan_from_config(attack, N, True))
    tstate = tstates[0]
    j, t = steps[0]
    for name in ("finite", "verified", "status", "attacked"):
        np.testing.assert_array_equal(t[name], j[name], err_msg=name)
    assert (t["weights"] == 0).all() and (j["weights"] == 0).all()
    assert float(t["loss"]) == 0.0
    for a, b in zip(tree_leaves(tstate.params),
                    tree_leaves(sides["tparams"])):
        assert torch.equal(a, b)
    assert int(tstate.opt_state.count) == 0
    assert all(not m.any() for m in tstate.opt_state.mu)


@pytest.mark.parametrize("remat", [False, True])
def test_monitored_loss_and_grads_match_jax(sides, remat):
    jcfg = jgpt2.GPT2Config(dtype=jnp.float32, remat=remat,
                            **{k: v for k, v in TINY.items()
                               if k != "seq_len"})
    cfg = gpt2.GPT2Config(dtype=torch.float32, remat=remat,
                          **{k: v for k, v in TINY.items()
                             if k != "seq_len"})
    x, y = next(_batches(1, seed=5))
    jbatch = {"input": jnp.asarray(x[0]), "target": jnp.asarray(y[0])}

    def jloss(p):
        loss, feats, ml = jgpt2.loss_with_monitor(p, jbatch, jcfg)
        return loss, (feats, ml)

    (jl, (jf, jml)), jg = jax.value_and_grad(jloss, has_aux=True)(
        sides["jparams"])
    leaves = [p.clone().requires_grad_() for p in
              tree_leaves(sides["tparams"])]
    params = tree_unflatten(sides["tparams"], leaves)
    loss, feats, ml = gpt2.loss_with_monitor(
        params, {"input": torch.from_numpy(x[0]),
                 "target": torch.from_numpy(y[0])}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jf),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ml.detach().numpy(), np.asarray(jml),
                               rtol=0, atol=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    logits, f2, ml2 = gpt2.forward_with_monitor(params, torch.from_numpy(
        x[0]), cfg)
    jlogits, jf2, jml2 = jgpt2.forward_with_monitor(
        sides["jparams"], jnp.asarray(x[0]), jcfg)
    for a, b in ((logits, jlogits), (f2, jf2), (ml2, jml2)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)


def test_model_bundle_matches_jax_bundle(sides):
    """create_model's GPT-2 bundle: the same input contract, parameter
    count, logits and loss as the JAX package's (within 1e-5)."""
    jb, b = sides["jbundle"], sides["bundle"]
    assert (b.name, b.kind, b.num_blocks, b.input_spec) == \
        (jb.name, jb.kind, jb.num_blocks, jb.input_spec)
    assert b.num_params(sides["tparams"]) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
            sides["jparams"]))
    batch = b.example_batch(3, torch.Generator().manual_seed(0))
    assert batch["input"].shape == batch["target"].shape == (3, T)
    assert torch.equal(batch["input"][:, 1:], batch["target"][:, :-1])
    x, y = batch["input"].numpy(), batch["target"].numpy()
    np.testing.assert_allclose(
        b.apply(sides["tparams"], batch["input"]).numpy(),
        np.asarray(jb.apply(sides["jparams"], jnp.asarray(x))),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        float(b.loss(sides["tparams"], batch)),
        float(jb.loss(sides["jparams"], {"input": jnp.asarray(x),
                                         "target": jnp.asarray(y)})),
        rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        create_model("resnet18")


def test_trust_layer_matches_jax():
    """trust/state.py's functions and the host TrustManager, driven through
    the same updates, compromise, recovery and adaptive threshold on a
    fixed clock: scores, metrics and threshold within 1e-6, statuses,
    counts, weights' support and the manager's node lists equal."""
    from trustworthy_dl_tpu.trust import state as jts
    from trustworthy_dl_tpu.trust.manager import TrustManager as JManager

    from trustworthy_dl_tpu_torch.trust import state as ts
    from trustworthy_dl_tpu_torch.trust.manager import TrustManager

    rng = np.random.default_rng(2)
    n = 5
    j, t = jts.init_trust_state(n), ts.init_trust_state(n)
    streak_j = jnp.zeros(n, jnp.int32)
    streak_t = torch.zeros(n, dtype=torch.int32)
    for step in range(12):
        dev = rng.random(n).astype(np.float32)
        cons = rng.random(n).astype(np.float32)
        upd = rng.random(n) < 0.8
        j = jts.update_trust(j, jnp.asarray(dev), jnp.asarray(cons),
                             float(step), update_mask=jnp.asarray(upd))
        t = ts.update_trust(t, torch.from_numpy(dev), torch.from_numpy(cons),
                            float(step), update_mask=torch.from_numpy(upd))
        if step in (3, 7):
            hit = np.eye(n, dtype=bool)[step % n]
            j = jts.mark_compromised(j, jnp.asarray(hit))
            t = ts.mark_compromised(t, torch.from_numpy(hit))
        if step == 9:
            back = np.eye(n, dtype=bool)[3]
            j = jts.initiate_recovery(j, jnp.asarray(back))
            t = ts.initiate_recovery(t, torch.from_numpy(back))
        clean = rng.random(n) < 0.9
        j, streak_j = jts.probation_recovery(j, streak_j, jnp.asarray(clean),
                                             3)
        t, streak_t = ts.probation_recovery(t, streak_t,
                                            torch.from_numpy(clean), 3)
        for name in ("scores", "metrics", "last_updated", "threshold"):
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        for name in ("status", "update_count", "attack_count"):
            np.testing.assert_array_equal(getattr(t, name).numpy(),
                                          np.asarray(getattr(j, name)),
                                          err_msg=f"step {step} {name}")
        np.testing.assert_array_equal(streak_t.numpy(), np.asarray(streak_j))
        np.testing.assert_array_equal(
            ts.contribution_weights(t).numpy() > 0,
            np.asarray(jts.contribution_weights(j)) > 0)
    j, t = jts.adaptive_threshold(j), ts.adaptive_threshold(t)
    np.testing.assert_allclose(float(t.threshold), float(j.threshold),
                               atol=1e-6)
    np.testing.assert_allclose(float(ts.system_trust(t)),
                               float(jts.system_trust(j)), atol=1e-6)

    jm, tm = JManager(n), TrustManager(n)
    jm.sync_from_device(j, wall_time=100.0, node_ids=[4, 3, 2, 1, 0])
    tm.sync_from_device(t, wall_time=100.0, node_ids=[4, 3, 2, 1, 0])
    for i in range(n):
        assert abs(tm.get_trust_score(i) - jm.get_trust_score(i)) < 1e-6
        assert int(tm.get_node_status(i)) == int(jm.get_node_status(i))
    for query in ("get_trusted_nodes", "get_suspicious_nodes",
                  "get_compromised_nodes"):
        assert getattr(tm, query)() == list(getattr(jm, query)()), query
    assert abs(tm.calculate_system_trust() - jm.calculate_system_trust()) \
        < 1e-6
    jm.adaptive_threshold_adjustment()
    tm.adaptive_threshold_adjustment()
    assert abs(tm.trust_threshold - jm.trust_threshold) < 1e-6


def test_optimizer_matches_optax():
    """AdamW with decay, clipping and a warmup + cosine schedule; Adam;
    SGD with momentum: four updates, the port against optax."""
    rng = np.random.default_rng(9)
    shapes = [(5, 3), (7,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [[rng.standard_normal(s).astype(np.float32) * 3 for s in shapes]
          for _ in range(4)]
    for name, kw in (("adamw", dict(weight_decay=0.01, grad_clip_norm=1.0,
                                    lr_schedule="cosine", warmup_steps=2,
                                    lr_decay_steps=5, min_lr_ratio=0.1)),
                     ("adam", {}), ("sgd", {})):
        jcfg = JTrainingConfig(optimizer=name, learning_rate=0.1, **kw)
        cfg = TrainingConfig(optimizer=name, learning_rate=0.1, **kw)
        jopt = jbuild_optimizer(jcfg)
        jp = [jnp.asarray(a) for a in p0]
        js = jopt.init(jp)
        opt = build_optimizer(cfg)
        tp = [torch.from_numpy(a) for a in p0]
        ts_ = opt.init(tp)
        for g in gs:
            upd, js = jopt.update([jnp.asarray(a) for a in g], js, jp)
            jp = optax.apply_updates(jp, upd)
            tp, ts_ = opt.update([torch.from_numpy(a) for a in g], ts_, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6, err_msg=name)
    assert callable(build_schedule(TrainingConfig(warmup_steps=3)))
    assert build_schedule(TrainingConfig()) == TrainingConfig().learning_rate
    with pytest.raises(ValueError):
        Optimizer("lamb", 0.1)


@pytest.mark.parametrize("kinds,collude", [
    (["data_poisoning"], False), (["backdoor"], False),
    (["byzantine"], False), (["byzantine", "gradient_poisoning"], True)])
def test_injectors_match_jax(kinds, collude):
    """poison_batch and poison_gradients fed JAX's own draws (the key
    splits of ``trustworthy_dl_tpu/attacks/adversarial.py``): tokens and
    labels exactly equal, gradients within 1e-6."""
    from trustworthy_dl_tpu.attacks.adversarial import \
        poison_batch as jpoison_batch
    from trustworthy_dl_tpu.attacks.adversarial import \
        poison_gradients as jpoison_gradients

    from trustworthy_dl_tpu_torch.attacks.adversarial import poison_batch, \
        poison_gradients

    attack = AttackConfig(attack_types=kinds, target_nodes=[1, 3],
                          intensity=0.4, start_step=2, intensity_ramp=0.1,
                          collude=collude)
    jplan = jplan_from_config(JAttackConfig(**attack.__dict__), N, True)
    plan = plan_from_config(attack, N, True)
    step, vocab = 5, TINY["vocab_size"]
    rng = np.random.default_rng(4)
    x = rng.integers(0, vocab, size=(N, B, 16)).astype(np.int32)
    y = rng.integers(0, vocab, size=(N, B, 16)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    jout = jpoison_batch(jplan, {"input": jnp.asarray(x),
                                 "target": jnp.asarray(y)},
                         jnp.int32(step), key, vocab)
    k_noise, k_scramble = jax.random.split(key)
    guess = max(int(x.max()) + 1, vocab)
    noise = {"scramble": torch.from_numpy(np.array(jax.random.randint(
                 k_scramble, x.shape, 0, guess, jnp.int32))),
             "flip": torch.from_numpy(np.array(jax.random.bernoulli(
                 k_noise, min(plan.effective_intensity(step), 1.0),
                 x.shape)))}
    out = poison_batch(plan, {"input": torch.from_numpy(x),
                              "target": torch.from_numpy(y)}, step, vocab,
                       noise=noise)
    for name in ("input", "target"):
        np.testing.assert_array_equal(out[name].numpy(),
                                      np.asarray(jout[name]), err_msg=name)

    grads = [rng.standard_normal((N,) + s).astype(np.float32) * 1e-2
             for s in ((6, 5), (7,))]
    jg = jpoison_gradients(jplan, [jnp.asarray(g) for g in grads],
                           jnp.int32(step), key)
    keys = jax.random.split(key, len(grads))
    draws = [np.broadcast_to(np.array(jax.random.normal(
                 k, g.shape[1:], jnp.float32))[None], g.shape) if collude
             else np.array(jax.random.normal(k, g.shape, jnp.float32))
             for k, g in zip(keys, grads)]
    tg = poison_gradients(plan, [torch.from_numpy(g) for g in grads], step,
                          noise=[torch.from_numpy(np.ascontiguousarray(d))
                                 for d in draws])
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("sampling", ["epoch", "windows"])
def test_loader_batches_match_jax(sampling):
    kw = dict(batch_size=8, seq_len=16, vocab_size=227, num_examples=64,
              seed=3, sampling=sampling)
    jdl = jget_dataloader("openwebtext", **kw)
    dl = get_dataloader("openwebtext", **kw)
    for _ in range(2):                      # two epochs: reshuffled
        for jb, b in zip(jdl, dl, strict=True):
            np.testing.assert_array_equal(b["input"], jb["input"])
            np.testing.assert_array_equal(b["target"], jb["target"])


CANON = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=227, n_positions=32,
             seq_len=16)


def _canonical(trainer, attacker_plan, loader_fn):
    trainer.initialize()
    trainer.set_attack_plan(attacker_plan)
    dl = loader_fn("openwebtext", batch_size=8, seq_len=16, vocab_size=227,
                   num_examples=64)
    return trainer.train(dl, num_epochs=2)


def test_trainer_canonical_drive_matches_jax(tmp_path):
    from trustworthy_dl_tpu.attacks.adversarial import \
        AdversarialAttacker as JAttacker
    from trustworthy_dl_tpu.engine.trainer import \
        DistributedTrainer as JTrainer

    from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker

    kw = dict(model_name="gpt2", batch_size=8, num_nodes=4,
              optimizer="adamw", learning_rate=3e-3, detector_warmup=4)
    attack = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
                  intensity=0.5, start_step=8)
    jtrainer = JTrainer(JTrainingConfig(checkpoint_dir=str(tmp_path / "ck"),
                                        **kw), model_overrides=dict(CANON))
    jattacker = JAttacker(JAttackConfig(**attack))
    jattacker.activate_attacks()
    jres = _canonical(jtrainer, jattacker.plan(4), jget_dataloader)

    trainer = DistributedTrainer(TrainingConfig(**kw),
                                 model_overrides=dict(CANON), device="cpu")
    attacker = AdversarialAttacker(AttackConfig(**attack))
    attacker.activate_attacks()
    res = _canonical(trainer, attacker.plan(4), get_dataloader)

    def incidents(history):
        return [(r["node_id"], r["attack_type"]) for r in history]

    assert incidents(trainer.attack_history) == \
        incidents(jtrainer.attack_history) == [(2, "gradient_poisoning")]
    assert res["stats"]["global_step"] == jres["stats"]["global_step"] == 16
    losses = [b["loss"] for b in trainer.batch_history]
    assert losses[-1] < losses[0]
    assert trainer.trust_manager.get_trust_score(2) < 0.3
    assert trainer.reassignment_history[0]["from_node"] == 2


def test_trainer_reads_each_step_in_one_copy_and_times_the_whole_step():
    """The host view of a step (one packed copy) holds every metric the
    host reads bit-exactly; the records' step_s tile the epoch's wall."""
    import time

    trainer = DistributedTrainer(
        TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                       detector_warmup=1),
        model_overrides=dict(CANON), device="cpu")
    trainer.initialize()
    dl = get_dataloader("openwebtext", batch_size=8, seq_len=16,
                        vocab_size=227, num_examples=24)
    batches = list(dl)
    trainer.state, metrics = trainer._train_step(
        trainer.state, trainer._node_batch(batches[0]), trainer.attack_plan)
    host = trainer._host_view(metrics)
    assert host["loss"] == float(metrics.loss)
    for key in ("per_node_loss", "weights", "trust_scores", "out_score",
                "grad_score", "attacked", "finite", "status", "attack_type"):
        want = getattr(metrics, key).numpy()
        assert host[key].dtype.kind == want.dtype.kind, key
        np.testing.assert_array_equal(host[key], want, err_msg=key)
    assert host["fleet_alert"] == bool(metrics.fleet_alert)
    assert host["fleet_streak"] == int(trainer.state.fleet_raw_streak[0])

    t0 = time.perf_counter()
    trainer.train_epoch(batches, 0)
    wall = time.perf_counter() - t0
    step_s = [r["step_s"] for r in trainer.batch_history]
    assert len(step_s) == len(batches) and min(step_s) > 0
    assert 0.9 * wall < sum(step_s) <= wall


def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    from trustworthy_dl_tpu_torch.cli import train_main

    tiny = {k: v for k, v in CANON.items() if k != "seq_len"}
    rc = train_main(["--device", "cpu", "--nodes", "4", "--batch-size", "8",
                     "--seq-len", "16", "--steps-per-epoch", "2",
                     "--epochs", "1",
                     "--checkpoint-dir", str(tmp_path / "ck")],
                    model_overrides=tiny)
    assert rc == 0
    assert "Training completed: 2 steps" in capsys.readouterr().out


def test_trainer_without_cuda_needs_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError):
        DistributedTrainer(TrainingConfig(num_nodes=4),
                           model_overrides=dict(CANON))
    with pytest.raises(ValueError):
        TrainingConfig(remat_policy="layer")
