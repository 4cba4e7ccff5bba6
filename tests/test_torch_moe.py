"""The port's Mixture-of-Experts GPT-2 against the JAX package's on the
CPU: the routing, the MoE MLP, the monitored loss and its gradients on
converted weights, and ``DistributedTrainer`` on a tiny ``gpt2-moe`` in
data mode, with JAX's own ``tests/test_moe.py`` data-mode cases ported
beside them.  Tiny shapes (2 layers, 32 wide, 4 heads, vocab 131; 4
experts), f32 compute on both sides.

Tolerances:
  * the dispatchers on the same gate probabilities: the combine's support
    (which (token, expert, slot) holds a route) exactly equal, its values
    within 1e-6, the drop fraction within 1e-7 and the aux loss within one
    f32 step of JAX's value (its gate means over the tokens are summed in
    another order by the two libraries, and one step at the aux's typical
    value of 1 to 2 is 1.19e-7);
  * ``moe_mlp``, ``loss_with_monitor`` (loss, features, mean logits, drop)
    and the gradients of every leaf within 1e-5;
  * the trainers: per-step losses and trust scores within 1e-5, the
    verdicts (attacked, weights > 0) and the incidents equal, and
    ``moe_drop_fraction`` equal at every step.

The attacked node's gradient noise is each package's own draw, but node
2 is gated from its first attacked step and its poisoned leaf norms clamp
its gradient consistency at 1, so the trusted trajectory is the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.data.loader import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.engine.step import build_eval_step as jbuild_eval
from trustworthy_dl_tpu.models import moe as jmoe
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.step import HostMetricsPacker, \
    StepMetrics, build_eval_step
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert, gpt2, moe
from trustworthy_dl_tpu_torch.models.factory import create_model
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.torchport

# vocab 131: a size no other test file uses, so the JAX programs this file
# compiles are its own in the process-global jit cache.
ARCH = dict(vocab_size=131, n_positions=32, n_layer=2, n_embd=32, n_head=4)
TINY = dict(ARCH, seq_len=16)
DISPATCHES = ("positional", "priority")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _cfgs(**kw):
    return (jmoe.MoEConfig(**ARCH, dtype=jnp.float32, **kw),
            moe.MoEConfig(**ARCH, dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    jp = jmoe.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp))


def _tokens(b=2, t=16, seed=1):
    toks = np.random.default_rng(seed).integers(0, ARCH["vocab_size"],
                                                (b, t + 1))
    return ({"input": jnp.asarray(toks[:, :-1]),
             "target": jnp.asarray(toks[:, 1:])},
            {"input": torch.from_numpy(toks[:, :-1]),
             "target": torch.from_numpy(toks[:, 1:])})


def _softmax(logits):
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


# (experts, top_k, tokens, capacity, gate probabilities)
_RNG = np.random.default_rng(7)
ROUTING = {
    "ample": (4, 2, 64, 64, _softmax(_RNG.normal(size=(64, 4)))),
    "overflow": (4, 2, 64, 8, _softmax(_RNG.normal(size=(64, 4)))),
    # A zero router: every probability 1/E, every top-k a tie.
    "zero_router": (4, 2, 32, 20, np.full((32, 4), 0.25, np.float32)),
    "one_expert": (1, 1, 32, 32, np.ones((32, 1), np.float32)),
}


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("case", sorted(ROUTING))
def test_dispatch_matches_jax(dispatch, case):
    e, k, s, capacity, probs = ROUTING[case]
    jcfg, cfg = _cfgs(n_experts=e, top_k=k, dispatch=dispatch)
    jfn = (jmoe.router_dispatch_priority if dispatch == "priority"
           else jmoe.router_dispatch)
    fn = (moe.router_dispatch_priority if dispatch == "priority"
          else moe.router_dispatch)
    jcomb, jaux = jfn(jnp.asarray(probs), jcfg, capacity)
    comb, aux = fn(torch.from_numpy(probs), cfg, capacity)
    jcomb, comb = np.asarray(jcomb), comb.numpy()
    assert comb.shape == jcomb.shape == (s, e, capacity)
    np.testing.assert_array_equal(comb > 0, jcomb > 0)
    np.testing.assert_allclose(comb, jcomb, rtol=0, atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= np.spacing(np.float32(jaux))
    drop = 1.0 - (comb > 0).sum() / (s * k)
    jdrop = 1.0 - (jcomb > 0).sum() / (s * k)
    assert abs(drop - jdrop) <= 1e-7
    if case == "overflow":
        assert drop > 0
    if case == "zero_router":
        # Ties go to the lower index: experts 0 and 1 take every route.
        assert (comb[:, 2:] == 0).all() and float(aux) == 1.0


@pytest.mark.parametrize("dispatch,factor,remat", [
    ("positional", 1.25, False), ("positional", 0.25, True),
    ("priority", 1.25, True), ("priority", 0.25, False)])
def test_mlp_loss_and_grads_match_jax(dispatch, factor, remat):
    jcfg, cfg = _cfgs(n_experts=4, dispatch=dispatch,
                      capacity_factor=factor, remat=remat)
    jp, tp = _params(jcfg)
    jbatch, batch = _tokens()

    x = np.random.default_rng(3).normal(size=(2, 16, ARCH["n_embd"])
                                        ).astype(np.float32)
    jblock = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"])["moe"]
    block = gpt2.unstack_blocks(tp["blocks"], ARCH["n_layer"])[0]["moe"]
    jy, jaux, jdrop = jmoe.moe_mlp(jblock, jnp.asarray(x), jcfg)
    y, aux, drop = moe.moe_mlp(block, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-5
    assert float(drop) == float(jdrop)
    assert (float(drop) > 0) == (factor < 1)

    def jloss(p):
        loss, feats, ml, aux = jmoe.loss_with_monitor(p, jbatch, jcfg)
        return loss, (feats, ml, aux)

    (jl, (jf, jml, jx)), jg = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tp)]
    loss, feats, ml, aux = moe.loss_with_monitor(
        tree_unflatten(tp, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jf),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ml.detach().numpy(), np.asarray(jml),
                               rtol=0, atol=1e-5)
    assert float(aux["moe_drop_fraction"]) == \
        float(jx["moe_drop_fraction"])
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(jleaves) == 17
    for a, b in zip(grads, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    # The router learns through the combine weights.
    assert grads[tree_leaves_names(tp).index("blocks.moe.router.w")
                 ].abs().max() > 0


def tree_leaves_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in tree_leaves_names(tree[k], f"{prefix}{k}.")]
    return [prefix[:-1]]


def test_convert_takes_the_moe_tree_and_refuses_a_mix():
    jcfg, _ = _cfgs(n_experts=4)
    jp = jax.tree_util.tree_map(np.asarray,
                                jmoe.init_params(jax.random.PRNGKey(0), jcfg))
    tp = convert.params_from_jax(jp)
    assert tp["blocks"]["moe"]["fc"]["w"].shape == (2, 4, 32, 128)
    assert tp["blocks"]["moe"]["router"]["w"].dtype == torch.float32
    mixed = dict(jp, blocks=dict(jp["blocks"], mlp={"fc": {"w": np.zeros(
        1), "b": np.zeros(1)}, "proj": {"w": np.zeros(1), "b": np.zeros(1)}}))
    with pytest.raises(ValueError, match="MoE GPT-2"):
        convert.params_from_jax(mixed)


def test_eval_step_skips_the_fused_head_as_jax_does():
    """With ``lm_head_chunk`` set, JAX's eval takes the plain head for MoE
    (no aux loss in validation): the port's too, within 1e-5."""
    jbundle = jcreate_model("gpt2-moe", dtype=jnp.float32, n_experts=4,
                            lm_head_chunk=64, **TINY)
    bundle = create_model("gpt2-moe", dtype=torch.float32, n_experts=4,
                          lm_head_chunk=64, **TINY)
    jp = jbundle.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jbatch, batch = _tokens(b=3)
    jout = jbuild_eval(jbundle)(jp, jbatch)
    out = build_eval_step(bundle)(tp, batch)
    logits = moe.forward(tp, batch["input"], bundle.config)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, ARCH["vocab_size"]), batch["target"].reshape(-1))
    assert abs(float(out["loss"]) - float(want)) <= 1e-5
    for key in ("loss", "accuracy"):
        assert abs(float(out[key]) - float(jout[key])) <= 1e-5, key


def test_host_packer_carries_model_aux():
    n = 2
    z = torch.zeros(n)
    metrics = StepMetrics(
        loss=torch.tensor(1.5), per_node_loss=z, trust_scores=z + 1,
        status=torch.zeros(n, dtype=torch.int32),
        attacked=torch.zeros(n, dtype=torch.bool),
        verified=torch.ones(n, dtype=torch.bool),
        finite=torch.ones(n, dtype=torch.bool), weights=z + 0.5,
        system_trust=torch.tensor(1.0), grad_norm=torch.tensor(2.0),
        out_score=z, grad_score=z,
        attack_type=torch.zeros(n, dtype=torch.int32),
        byzantine=torch.zeros(n, dtype=torch.bool),
        backdoor=torch.zeros(n, dtype=torch.bool),
        out_stats=torch.zeros(n, 17), grad_stats=torch.zeros(n, 17),
        model_aux={"moe_drop_fraction": torch.tensor(0.75)})
    packer = HostMetricsPacker(metrics)
    assert packer.matches(metrics)
    assert not packer.matches(metrics._replace(model_aux=None))
    host, _ = packer.unpack(packer.pack(metrics))
    assert host.model_aux == {"moe_drop_fraction": np.float32(0.75)}
    assert float(host.loss) == 1.5
    plain = HostMetricsPacker(metrics._replace(model_aux=None))
    assert plain.unpack(plain.pack(metrics._replace(model_aux=None))
                        )[0].model_aux is None


# --------------------------------------------------------------------------
# JAX's tests/test_moe.py data-mode cases, on the port
# --------------------------------------------------------------------------


def test_router_dispatch_invariants():
    cfg = moe.MoEConfig(**ARCH, n_experts=4, top_k=2, capacity_factor=8.0)
    probs = torch.softmax(torch.randn(64, 4, generator=torch.Generator(
    ).manual_seed(0)), dim=-1)
    combine, aux = moe.router_dispatch(probs, cfg, capacity=64)
    c = combine.numpy()
    np.testing.assert_allclose(c.sum(axis=(1, 2)), 1.0, rtol=1e-5)
    assert ((c > 0).sum(axis=0) <= 1).all()
    assert np.isfinite(float(aux))


def test_router_dispatch_capacity_drops_tokens():
    cfg = moe.MoEConfig(**ARCH, n_experts=2, top_k=1, capacity_factor=1.0)
    probs = torch.tensor([[0.99, 0.01]]).repeat(32, 1)
    combine, _ = moe.router_dispatch(probs, cfg, capacity=4)
    kept = combine.sum(dim=(1, 2)).numpy()
    np.testing.assert_allclose(kept[:4], 1.0, rtol=1e-5)
    np.testing.assert_allclose(kept[4:], 0.0)


def test_dispatch_mode_validated():
    with pytest.raises(ValueError, match="dispatch"):
        moe.MoEConfig(**ARCH, dispatch="sorted")
    assert moe.MoEConfig.from_name("gpt2-medium-moe").n_layer == 24
    with pytest.raises(ValueError, match="unknown GPT-2 size"):
        moe.MoEConfig.from_name("gpt3-moe")


def test_priority_dispatch_matches_positional_without_overflow():
    cfg = moe.MoEConfig(**ARCH, n_experts=4, top_k=2, capacity_factor=8.0)
    probs = torch.softmax(torch.randn(32, 4, generator=torch.Generator(
    ).manual_seed(0)), dim=-1)
    pos, aux_pos = moe.router_dispatch(probs, cfg, capacity=32)
    pri, aux_pri = moe.router_dispatch_priority(probs, cfg, capacity=32)
    np.testing.assert_allclose(pos.sum(-1).numpy(), pri.sum(-1).numpy(),
                               atol=1e-6)
    assert float(aux_pos) == pytest.approx(float(aux_pri), rel=1e-6)


def test_priority_dispatch_sheds_lowest_probability_routes():
    cfg = moe.MoEConfig(**ARCH, n_experts=2, top_k=1, capacity_factor=1.0)
    logits = torch.stack([torch.linspace(0.5, 4.0, 16), torch.zeros(16)],
                         dim=1)
    probs = torch.softmax(logits, -1)
    pri, _ = moe.router_dispatch_priority(probs, cfg, capacity=4)
    kept_tokens = np.nonzero(pri.sum((1, 2)).numpy())[0]
    np.testing.assert_array_equal(kept_tokens, np.arange(12, 16))
    pos, _ = moe.router_dispatch(probs, cfg, capacity=4)
    dropped_pri = float(probs.max(-1).values.sum() - pri.sum())
    dropped_pos = float(probs.max(-1).values.sum() - pos.sum())
    assert dropped_pri <= dropped_pos + 1e-6


def test_priority_dispatch_tiny_batch_regression():
    """Two tokens: the capacity floor of 4 is clamped to the token count,
    and both dispatchers agree (nothing can overflow)."""
    cfg = moe.MoEConfig(**ARCH, n_experts=4, top_k=2, dispatch="priority",
                        dtype=torch.float32)
    assert moe._capacity(2, cfg) == 2
    assert moe._capacity(64, cfg) >= 4
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, ARCH["n_embd"], generator=gen)
    params = moe.init_params(cfg, torch.Generator().manual_seed(1))
    block = gpt2.unstack_blocks(params["blocks"], ARCH["n_layer"])[0]["moe"]
    y_pri, _, drop_pri = moe.moe_mlp(block, x, cfg)
    assert torch.isfinite(y_pri).all()
    cfg_pos = moe.MoEConfig(**ARCH, n_experts=4, top_k=2,
                            dispatch="positional", dtype=torch.float32)
    y_pos, _, _ = moe.moe_mlp(block, x, cfg_pos)
    np.testing.assert_allclose(y_pri.numpy(), y_pos.numpy(), atol=1e-5)
    assert float(drop_pri) == pytest.approx(0.0, abs=1e-6)
    toks = torch.randint(0, ARCH["vocab_size"], (1, 2), generator=gen)
    loss = moe.loss_fn(params, {"input": toks,
                                "target": toks.roll(-1, -1)}, cfg)
    assert torch.isfinite(loss)


def test_aux_loss_balance_extremes():
    cfg = moe.MoEConfig(**ARCH, n_experts=4, top_k=1)
    s, e = 256, 4
    collapsed = torch.softmax(torch.tensor([8.0, 0.0, 0.0, 0.0]), -1
                              ).repeat(s, 1)
    _, aux_bad = moe.router_dispatch(collapsed, cfg, capacity=s)
    assert float(aux_bad) > 0.9 * e
    logits = 8.0 * torch.nn.functional.one_hot(torch.arange(s) % e, e)
    _, aux_good = moe.router_dispatch(torch.softmax(logits.float(), -1),
                                      cfg, capacity=s)
    assert float(aux_good) < 1.1


def test_single_expert_equals_dense_mlp():
    cfg = moe.MoEConfig(**ARCH, n_experts=1, top_k=1, capacity_factor=2.0,
                        dtype=torch.float32)
    blocks = moe.init_block_params(cfg, torch.Generator().manual_seed(1))
    block = gpt2.unstack_blocks(blocks, ARCH["n_layer"])[0]["moe"]
    x = torch.randn(2, 16, ARCH["n_embd"],
                    generator=torch.Generator().manual_seed(2))
    got, aux, _ = moe.moe_mlp(block, x, cfg)
    h = x @ block["fc"]["w"][0] + block["fc"]["b"][0]
    ref = torch.nn.functional.gelu(h, approximate="tanh") \
        @ block["proj"]["w"][0] + block["proj"]["b"][0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert float(aux) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_model_trains(dispatch):
    cfg = moe.MoEConfig(**ARCH, n_experts=4, top_k=2, dispatch=dispatch,
                        dtype=torch.float32)
    params = moe.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 16),
                           generator=torch.Generator().manual_seed(1))
    batch = {"input": tokens, "target": tokens.roll(-1, -1)}
    losses = []
    for _ in range(8):
        leaves = [p.requires_grad_() for p in tree_leaves(params)]
        loss = moe.loss_fn(tree_unflatten(params, leaves), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        assert all(torch.isfinite(g).all() for g in grads)
        losses.append(float(loss.detach()))
        params = tree_unflatten(params, [(p - 0.05 * g).detach() for p, g
                                         in zip(leaves, grads)])
        g_fc = grads[tree_leaves_names(params).index("blocks.moe.fc.w")]
        assert g_fc.abs().max() > 0
    assert losses[-1] < losses[0]


def test_factory_moe_bundle():
    bundle = create_model("gpt2-moe", **TINY)
    jbundle = jcreate_model("gpt2-moe", **TINY)
    assert (bundle.kind, bundle.num_blocks, bundle.input_spec) == \
        (jbundle.kind, jbundle.num_blocks, jbundle.input_spec) == \
        ("lm", 2, {"seq_len": 16, "vocab_size": 131})
    params = bundle.init(torch.Generator().manual_seed(0))
    assert bundle.num_params(params) == jmoe.num_params(
        jbundle.init(jax.random.PRNGKey(0))) == moe.num_params(params)
    batch = bundle.example_batch(2, torch.Generator().manual_seed(0))
    assert torch.isfinite(bundle.loss(params, batch))
    logits, feats, mean_logits = bundle.apply_monitor(params, batch["input"])
    assert logits.shape == (2, 16, ARCH["vocab_size"])
    assert feats.shape == (2, 16, ARCH["n_embd"])
    assert mean_logits.shape == (ARCH["vocab_size"],)
    assert set(bundle.loss_monitor(params, batch)[3]) == \
        {"moe_drop_fraction"}


# --------------------------------------------------------------------------
# The trainers
# --------------------------------------------------------------------------


def _trainers(tmp_path, attack=None, **kw):
    """Both packages' trainers on JAX's initial params."""
    from trustworthy_dl_tpu.attacks.adversarial import \
        AdversarialAttacker as JAttacker
    from trustworthy_dl_tpu.engine.trainer import \
        DistributedTrainer as JTrainer

    overrides = kw.pop("overrides")
    jtr = JTrainer(JTrainingConfig(checkpoint_dir=str(tmp_path / "jck"),
                                   **kw),
                   model_overrides=dict(overrides, dtype=jnp.float32))
    jtr.initialize()
    tr = DistributedTrainer(TrainingConfig(
        checkpoint_dir=str(tmp_path / "ck"), **kw),
        model_overrides=dict(overrides, dtype=torch.float32), device="cpu")
    tr.initialize(params=convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jtr.state.params))))
    if attack is not None:
        ja = JAttacker(JAttackConfig(**attack))
        ja.activate_attacks()
        jtr.set_attack_plan(ja.plan(kw["num_nodes"]))
        a = AdversarialAttacker(AttackConfig(**attack))
        a.activate_attacks()
        tr.set_attack_plan(a.plan(kw["num_nodes"]))
    return jtr, tr


def _check_records(jtr, tr, steps):
    jrec = jtr.metrics_collector.batch_metrics
    rec = tr.metrics_collector.batch_metrics
    assert len(rec) == len(jrec) == steps
    for s, (j, t) in enumerate(zip(jrec, rec)):
        assert abs(t["loss"] - j["loss"]) <= 1e-5, s
        assert t["trust_scores"].keys() == j["trust_scores"].keys()
        for node, v in t["trust_scores"].items():
            assert abs(v - j["trust_scores"][node]) <= 1e-5, (s, node)
        assert t["moe_drop_fraction"] == j["moe_drop_fraction"], s
    return [t["moe_drop_fraction"] for t in rec]


def test_capacity_overflow_drop_matches_jax(tmp_path):
    """JAX's ``test_moe_capacity_overflow_drop_is_visible`` geometry: per
    node S = 64 tokens, k = 2, C = ceil(128 / 4 * 0.25) = 8, so E C = 32
    slots for 128 assignments: at least 75 % must drop, and the trainer
    surfaces it, equal to JAX's at every step."""
    geometry = dict(model_name="gpt2-moe", dataset_name="openwebtext",
                    batch_size=8, num_nodes=2, optimizer="adamw",
                    learning_rate=1e-3, checkpoint_interval=10_000,
                    parallelism="data")
    jtr, tr = _trainers(tmp_path, overrides=dict(
        TINY, n_experts=4, capacity_factor=0.25), **geometry)
    loader = dict(batch_size=8, seq_len=16, vocab_size=131, num_examples=16)
    jtr.train_epoch(jget_dataloader("openwebtext", **loader), 0)
    tr.train_epoch(get_dataloader("openwebtext", **loader), 0)
    drops = _check_records(jtr, tr, 2)
    assert all(d >= 0.75 for d in drops), drops


def test_poisoned_four_node_run_matches_jax(tmp_path):
    """The canonical drive on ``gpt2-moe``: 4 nodes, gradient poisoning of
    node 2 at intensity 0.5 from step 8, 16 steps.  Same incidents, same
    per-step verdicts and trajectory."""
    kw = dict(model_name="gpt2-moe", batch_size=8, num_nodes=4,
              optimizer="adamw", learning_rate=3e-3, detector_warmup=4,
              async_host_depth=0)
    attack = dict(attack_types=["gradient_poisoning"], target_nodes=[2],
                  intensity=0.5, start_step=8)
    jtr, tr = _trainers(tmp_path, attack=attack,
                        overrides=dict(TINY, n_experts=4), **kw)
    loader = dict(batch_size=8, seq_len=16, vocab_size=131, num_examples=64)
    jtr.train(jget_dataloader("openwebtext", **loader), num_epochs=2)
    tr.train(get_dataloader("openwebtext", **loader), num_epochs=2)
    _check_records(jtr, tr, 16)

    def incidents(history):
        return [(r["node_id"], r["step"], r["attack_type"])
                for r in history]

    assert incidents(tr.attack_history) == incidents(jtr.attack_history)
    assert [r[0] for r in incidents(tr.attack_history)] == [2]
    gated = [s for s, h in enumerate(tr.batch_history)
             if h["weights"][2] == 0]
    assert gated and gated[0] == 8
    assert all(h["weights"][i] > 0 for h in tr.batch_history
               for i in (0, 1, 3))


def test_non_moe_metrics_have_no_drop_key(tmp_path):
    tr = DistributedTrainer(TrainingConfig(
        model_name="gpt2", batch_size=4, num_nodes=2,
        checkpoint_dir=str(tmp_path / "ck")),
        model_overrides=dict(TINY), device="cpu")
    tr.initialize()
    tr.train_epoch(get_dataloader("openwebtext", batch_size=4, seq_len=16,
                                  vocab_size=131, num_examples=8), 0)
    assert tr.metrics_collector.batch_metrics
    assert all("moe_drop_fraction" not in m
               for m in tr.metrics_collector.batch_metrics)


def test_cli_trains_gpt2_moe_on_the_cpu(capsys, tmp_path):
    from trustworthy_dl_tpu_torch.cli import train_main

    rc = train_main(["--device", "cpu", "--model", "gpt2-moe", "--nodes",
                     "2", "--batch-size", "4", "--seq-len", "16",
                     "--steps-per-epoch", "2", "--epochs", "1",
                     "--checkpoint-dir", str(tmp_path / "ck")],
                    model_overrides=dict(ARCH, n_experts=4))
    assert rc == 0
    out = capsys.readouterr().out
    assert "training gpt2-moe from random init" in out
    assert "Training completed: 2 steps" in out


def test_expert_parallelism_is_refused_naming_slice_4(capsys, tmp_path):
    """Expert parallelism, refused before the port had it, trains as in
    JAX: the trainer builds the (data, expert) mesh (one position by
    default, JAX's one-device layout) and binds it as the expert mesh;
    ``cli train --parallelism expert`` trains."""
    from trustworthy_dl_tpu_torch.models import moe as tmoe

    tr = DistributedTrainer(TrainingConfig(model_name="gpt2-moe",
                                           num_nodes=2,
                                           parallelism="expert",
                                           checkpoint_dir=str(tmp_path)),
                            model_overrides=dict(TINY), device="cpu")
    assert tr.mesh.axis_names == ("data", "expert")
    assert tmoe.get_expert_mesh() is tr.mesh
    from trustworthy_dl_tpu_torch.cli import train_main

    assert train_main(["--device", "cpu", "--model", "gpt2-moe",
                       "--parallelism", "expert", "--nodes", "2",
                       "--batch-size", "4", "--seq-len", "16",
                       "--steps-per-epoch", "1", "--epochs", "1",
                       "--checkpoint-dir", str(tmp_path / "cli")],
                      model_overrides=dict(ARCH, n_experts=4)) == 0
    assert "Training completed: 1 steps" in capsys.readouterr().out
    tmoe.set_expert_mesh(None)
