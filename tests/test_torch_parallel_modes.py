"""Tensor, hybrid and expert parallelism, ZeRO-1 and FSDP placement: the
port's mesh arms (``core/mesh.py``), layout registry
(``core/sharding.py``), ``parallel/tensor_parallel.py``, MoE's expert
mesh and the trainer's modes, against the JAX package's, on the CPU.

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``); the port's
single-controller mesh has 8 positions, all the CPU.  Parameters come
from JAX through ``models/convert.params_from_jax``.  The port keeps a
layout as specs beside dense tensors, so its specs are held to JAX's
``mesh_spec_tree`` leaf for leaf and its bytes a position to JAX's
``shard_shape`` arithmetic, and every mode's trajectory equals the port's
data mode bit for bit (one device, the same step), where JAX's GSPMD
reorders accumulation (JAX's tolerances then hold the port to JAX).

* ``tests/test_mesh.py``: axis order, the hybrid reshape and its errors,
  and the tensor / expert / data arms over the positions given.
* ``tests/test_sharding.py:49-166``: rule tables, ``named_sharding``,
  ``resolve_tree``, the model's logical axes resolving to JAX's TP
  layout, ``zero_shard_spec``, bytes a position; ``:393-469`` DP against
  FSDP and TP (losses and verdicts); ``:506`` specs after an
  evict/readmit cycle equal a fresh trainer's.
* ``tests/test_tensor_parallel.py``: TP specs, forward and backward at
  JAX's rtol 1e-4 / atol 1e-5 against JAX's TP-sharded run, the layout
  mismatch and vision cases, the trusted step in tensor mode and hybrid
  ``{data: 2, model: 4}``.
* ``tests/test_zero1.py``: ZeRO-1 moments name ``data`` as JAX's do;
  against JAX's ZeRO-1 run, losses within rtol 1e-4 and the relative
  parameter distance under 1e-3; the specs kept after an eviction.
* ``tests/test_moe.py:203`` and ``:244``: the expert-parallel forward at
  rtol 2e-4 against JAX's EP-sharded forward, ``moe_ep_specs``, the
  expert trainer end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.core import mesh as jmeshmod
from trustworthy_dl_tpu.core import sharding as jshreg
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.elastic import reassignment as jel
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models import moe as jmoe
from trustworthy_dl_tpu.parallel import tensor_parallel as jtp
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core import mesh as tmesh
from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.elastic import reassignment as el
from trustworthy_dl_tpu_torch.engine.state import zero1_place_opt_state
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models import moe as tmoe
from trustworthy_dl_tpu_torch.models.factory import create_model
from trustworthy_dl_tpu_torch.parallel import tensor_parallel as tp
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

CPU8 = ["cpu"] * 8
ARCH = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32)
TINY = dict(ARCH, seq_len=16)
DATA, MODEL, SEQ, EXPERT, STAGE = "data", "model", "seq", "expert", "stage"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)
    yield
    tmoe.set_expert_mesh(None)
    jmoe.set_expert_mesh(None)


def _spec_leaves(tree):
    """JAX's mesh_spec_tree as a list of tuples, leaf order."""
    is_spec = lambda x: x is None or isinstance(x, P)  # noqa: E731
    return [None if s is None else tuple(s) for s in
            jax.tree_util.tree_leaves(jshreg.mesh_spec_tree(tree),
                                      is_leaf=is_spec)]


def _jparams(seed=0):
    cfg = jgpt2.GPT2Config(dtype=jnp.float32, **ARCH)
    return cfg, jgpt2.init_params(jax.random.PRNGKey(seed), cfg)


def _torch(jtree):
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jtree))


# --------------------------------------------------------------------------
# tests/test_mesh.py
# --------------------------------------------------------------------------

def test_axis_order_outermost_first():
    assert tmesh.AXIS_ORDER == jmeshmod.AXIS_ORDER
    assert tmesh.AXIS_ORDER.index(DATA) < tmesh.AXIS_ORDER.index(MODEL)
    assert tmesh.AXIS_ORDER[-1] == EXPERT


@pytest.mark.parametrize("ici,nodes", [
    ({DATA: 2, MODEL: 4}, None),
    ({DATA: 2, SEQ: 2, EXPERT: 2}, 2),
    ({EXPERT: 2, DATA: 4}, 4),
], ids=["data2-model4", "data-seq-expert", "axis-order"])
def test_hybrid_mesh_matches_jax(eight_devices, ici, nodes):
    """``build_hybrid_mesh`` and ``build_mesh``'s hybrid arm: JAX's axis
    names (in ``AXIS_ORDER``) and shape over 8 positions."""
    if nodes is None:
        mesh = tmesh.build_hybrid_mesh(ici, devices=CPU8)
        jm = jmeshmod.build_hybrid_mesh(ici, devices=eight_devices)
    else:
        mesh = tmesh.build_mesh(nodes, "hybrid", ici, devices=CPU8)
        jm = jmeshmod.build_mesh(nodes, "hybrid", ici,
                                 devices=eight_devices)
    assert mesh.axis_names == tuple(jm.axis_names)
    assert mesh.devices.shape == jm.devices.shape
    # Without positions, as many of the device as the shape names.
    assert tmesh.build_mesh(2, "hybrid", ici).shape == mesh.shape


@pytest.mark.parametrize("args,err,match", [
    (({"bogus": 2},), ValueError, "unknown mesh axes"),
    (({DATA: 4, MODEL: 4},), ValueError, "needs"),
    (({DATA: 4}, {DATA: 4}), ValueError, "needs"),
], ids=["unknown-axis", "oversubscription", "dcn-counts"])
def test_hybrid_errors_match_jax(eight_devices, args, err, match):
    for build, devs in ((tmesh.build_hybrid_mesh, CPU8),
                        (jmeshmod.build_hybrid_mesh, eight_devices)):
        with pytest.raises(err, match=match):
            build(*args, devices=devs)


def test_mode_errors_match_jax_and_dcn_slices_are_refused(eight_devices):
    """hybrid without mesh_shape and a DCN shape outside hybrid raise
    JAX's ValueErrors; a DCN extent above 1 that the positions can hold
    asks for JAX's slice grouping across processes, which the port refuses
    naming its rule: one process a card."""
    for build, devs in ((tmesh.build_mesh, CPU8),
                        (jmeshmod.build_mesh, eight_devices)):
        with pytest.raises(ValueError, match="requires mesh_shape"):
            build(2, "hybrid", devices=devs)
        with pytest.raises(ValueError, match="requires parallelism"):
            build(2, "tensor", devices=devs, dcn_mesh_shape={DATA: 2})
    with pytest.raises(NotImplementedError,
                       match="one process a card: initialize_multihost"):
        tmesh.build_hybrid_mesh({DATA: 2}, {DATA: 2}, devices=CPU8)


def test_cli_hybrid_without_mesh_shape_raises_as_jax(tmp_path):
    """``cli train --parallelism hybrid`` without a config's
    ``mesh_shape`` raises JAX's "requires mesh_shape" error in both
    packages' entry points (JAX's ``main`` raises it too)."""
    from trustworthy_dl_tpu import cli as jcli
    from trustworthy_dl_tpu_torch import cli

    args = ["--parallelism", "hybrid", "--checkpoint-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="requires mesh_shape"):
        jcli.main(args)
    with pytest.raises(ValueError, match="requires mesh_shape"):
        cli.train_main(args + ["--device", "cpu"])


@pytest.mark.parametrize("nodes,mode,positions", [
    (4, "tensor", 8), (2, "tensor", 8), (3, "tensor", 8), (8, "tensor", 4),
    (4, "expert", 8), (2, "expert", 8), (8, "data", 8), (4, "data", 8),
    (6, "data", 4), (4, "tensor", 1), (4, "data", 1)])
def test_mode_arms_match_jax(eight_devices, nodes, mode, positions):
    """The data, tensor and expert arms over the positions given: JAX's
    fit rule, then JAX's names and shape (one position: JAX's one-device
    layout)."""
    mesh = tmesh.build_mesh(nodes, mode, devices=CPU8[:positions])
    jm = jmeshmod.build_mesh(nodes, mode, devices=eight_devices[:positions])
    assert (mesh.axis_names, mesh.devices.shape) == \
        (tuple(jm.axis_names), jm.devices.shape)
    if positions == 1:
        assert tmesh.build_mesh(nodes, mode).shape == mesh.shape


# --------------------------------------------------------------------------
# tests/test_sharding.py:49-166
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["data", "model", "tensor", "sequence",
                                  "expert", "hybrid"])
@pytest.mark.parametrize("fsdp", [False, True])
def test_axis_rules_tables_match_jax(mode, fsdp):
    assert shreg.axis_rules(mode, fsdp=fsdp) == \
        jshreg.axis_rules(mode, fsdp=fsdp)


def test_rules_resolution_and_unknown_axis_is_loud():
    rules, jrules = shreg.rules_for("tensor"), jshreg.rules_for("tensor")
    for axes in [(None, shreg.HIDDEN, shreg.W_TP), ()]:
        assert rules.partition_spec(*axes) == \
            tuple(jrules.partition_spec(*axes))
    with pytest.raises(ValueError, match="unknown logical axis"):
        rules.partition_spec(shreg.BATCH, "hiden")
    with pytest.raises(ValueError, match="batch"):
        rules.mesh_axis("w_pt")
    with pytest.raises(ValueError, match="no sharding rules"):
        shreg.axis_rules("diagonal")


def test_named_sharding_drops_axes_absent_from_mesh(eight_devices):
    mesh = tmesh.build_mesh(8, "data", devices=CPU8)
    jm = JMesh(np.array(eight_devices), (DATA,))
    got = shreg.rules_for("tensor").named_sharding(mesh, shreg.BATCH,
                                                   shreg.W_TP)
    want = jshreg.rules_for("tensor").named_sharding(jm, jshreg.BATCH,
                                                     jshreg.W_TP)
    assert got.spec == tuple(want.spec) == (DATA, None)


def test_resolve_tree_and_logical_axes_match_jax():
    """``resolve_tree`` translates as JAX's; the model's declaration
    resolved under the tensor rules is JAX's TP layout, leaf for leaf."""
    tree = {"qkv": {"w": (None, shreg.HIDDEN, shreg.W_TP),
                    "b": (shreg.W_TP,)},
            "proj": {"w": (None, shreg.W_TP, shreg.HIDDEN)}}
    rules, jrules = shreg.rules_for("tensor"), jshreg.rules_for("tensor")
    got = shreg.resolve_tree(tree, rules)
    want = jshreg.resolve_tree(tree, jrules)
    assert tree_leaves(got) == _spec_leaves_plain(want)
    assert gpt2.logical_axes() == jgpt2.logical_axes()
    specs = tp.gpt2_tp_specs(None)
    assert tree_leaves(specs) == _spec_leaves_plain(jtp.gpt2_tp_specs(None))
    assert specs["blocks"]["attn"]["qkv"]["w"] == (None, None, MODEL)
    assert specs["blocks"]["attn"]["proj"]["w"] == (None, MODEL, None)
    assert specs["wte"] == (None, None)


def _spec_leaves_plain(spec_tree):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("shape,n", [((16, 4), 8), ((3, 24), 8), ((6,), 8),
                                     ((), 8), ((4, 8), 4), ((2, 2), 1)])
def test_zero_shard_spec_matches_jax(shape, n):
    assert shreg.zero_shard_spec(shape, n, DATA) == \
        tuple(jshreg.zero_shard_spec(shape, n, DATA))


def test_place_zero_sharded_bytes_per_position(eight_devices):
    """The bytes a position holds, JAX's ``shard_shape`` arithmetic: 1024
    bytes over 8 and 20 replicated; a one-position mesh holds all."""
    tree = {"w": torch.zeros(16, 16), "b": torch.zeros(5)}
    jtree = {"w": jnp.zeros((16, 16), jnp.float32),
             "b": jnp.zeros((5,), jnp.float32)}
    for n in (8, 1):
        mesh = tmesh.build_mesh(n, "data", devices=CPU8[:n])
        jm = JMesh(np.array(eight_devices[:n]), (DATA,))
        placed, specs = shreg.place_zero_sharded(tree, mesh, DATA)
        jplaced = jshreg.place_zero_sharded(jtree, jm, DATA)
        assert tree_leaves(specs) == _spec_leaves(jplaced)
        assert shreg.tree_bytes_per_device(placed, specs, mesh) == \
            jshreg.tree_bytes_per_device(jplaced) == \
            (1024 // 8 + 20 if n == 8 else 1044)
        assert shreg.mesh_spec_tree(placed, specs) == specs
    # The one per-node-row rule, and no placement over several devices.
    assert shreg.row_spec(DATA, 2) == tuple(jshreg.row_spec(DATA, 2))
    assert shreg.row_placer(mesh, DATA, 8)(torch.ones(8, 3)).device == \
        torch.device("cpu")
    with pytest.raises(NotImplementedError,
                       match="one process a card: initialize_multihost"):
        shreg.replicated_placer(tmesh.build_mesh(
            2, "data", devices=["cpu", "meta"]))
    # Two spellings of one device are one device.
    assert shreg.replicated_placer(tmesh.build_mesh(
        2, "data", devices=["cpu", "cpu:0"]))(torch.ones(1)).device == \
        torch.device("cpu")


# --------------------------------------------------------------------------
# tests/test_tensor_parallel.py
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_meshes(eight_devices):
    """2 data shards (trust nodes) x 4-way TP groups, in both packages."""
    return (tmesh.Mesh(np.array([torch.device("cpu")] * 8,
                                dtype=object).reshape(2, 4), (DATA, MODEL)),
            JMesh(np.array(eight_devices).reshape(2, 4), (DATA, MODEL)))


def test_tp_specs_match_jax_leaf_for_leaf(tp_meshes):
    mesh, jm = tp_meshes
    cfg, jp = _jparams()
    jsharded = jtp.apply_tp_sharding(jp, jm)
    placed, specs = tp.apply_tp_sharding(_torch(jp), mesh)
    assert tree_leaves(specs) == _spec_leaves(jsharded)
    assert tp.tp_group_size(mesh) == jtp.tp_group_size(jm) == 4
    # The shard a position holds: qkv a quarter of its columns, proj a
    # quarter of its rows, embeddings and norms whole, as JAX's shards.
    for path in (("blocks", "attn", "qkv", "w"),
                 ("blocks", "attn", "proj", "w"), ("wte",),
                 ("blocks", "ln_1", "scale")):
        leaf, spec, jleaf = placed, specs, jsharded
        for k in path:
            leaf, spec, jleaf = leaf[k], spec[k], jleaf[k]
        assert shreg.NamedSharding(mesh, spec).shard_shape(leaf.shape) == \
            jleaf.addressable_shards[0].data.shape
    # No model axis: every spec replicated (JAX leaves the params as they
    # are, which its trainer then replicates).
    _, flat = tp.apply_tp_sharding(_torch(jp), tmesh.build_mesh(
        8, "data", devices=CPU8))
    assert all(s == () for s in tree_leaves(flat))


def test_tp_forward_backward_matches_jax(tp_meshes):
    """The port's loss and gradients (the replicated program on one
    device) against JAX's TP-sharded run, at JAX's rtol 1e-4 / atol
    1e-5."""
    mesh, jm = tp_meshes
    cfg, jp = _jparams()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    target = np.roll(tokens, -1, axis=-1)
    jbatch = {"input": jnp.asarray(tokens), "target": jnp.asarray(target)}
    jloss, jgrads = jax.jit(jax.value_and_grad(jgpt2.loss_fn),
                            static_argnums=2)(jtp.apply_tp_sharding(jp, jm),
                                              jbatch, cfg)
    params, _ = tp.apply_tp_sharding(_torch(jp), mesh)
    leaves = [leaf.requires_grad_(True) for leaf in tree_leaves(params)]
    tcfg = gpt2.GPT2Config(dtype=torch.float32, **ARCH)
    loss = gpt2.loss_fn(params, {"input": torch.from_numpy(tokens).long(),
                                 "target": torch.from_numpy(target).long()},
                        tcfg)
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for got, want in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_tp_layout_mismatch_raises_and_vision_replicates(tp_meshes):
    mesh, _ = tp_meshes
    _, jp = _jparams()
    broken = _torch(jp)
    broken["blocks"] = dict(broken["blocks"], rogue=torch.zeros(1))
    with pytest.raises(ValueError, match="rogue"):
        tp.apply_tp_sharding(broken, mesh)
    model = create_model("resnet32", num_classes=10, dtype=torch.float32)
    vision = model.init(torch.Generator().manual_seed(0), "cpu")
    _, specs = tp.apply_tp_sharding(vision, mesh)
    assert all(s == () for s in tree_leaves(specs))


def _trainer(tmp_path, tag, mesh=None, model_overrides=None, **cfg):
    config = TrainingConfig(
        model_name=cfg.pop("model_name", "gpt2"), batch_size=cfg.pop(
            "batch_size", 4), num_nodes=cfg.pop("num_nodes", 2),
        learning_rate=cfg.pop("learning_rate", 3e-3),
        checkpoint_interval=10 ** 9, checkpoint_dir=str(tmp_path / tag),
        **cfg)
    return DistributedTrainer(
        config, mesh=mesh, model_overrides=dict(
            model_overrides or TINY, dtype=torch.float32), device="cpu")


def _epochs(tr, n, examples=48, batch=4, vocab=128, seed=0):
    dl = get_dataloader("openwebtext", batch_size=batch, seq_len=16,
                        vocab_size=vocab, num_examples=examples, seed=seed)
    losses = [tr.train_epoch(dl, e) for e in range(n)]
    hist = tr.batch_history
    return losses, {"loss": [h["loss"] for h in hist],
                    "trust": [h["trust_scores"] for h in hist],
                    "weights": [h["weights"] for h in hist],
                    "attacked": [h["attacked"] for h in hist]}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """JAX's trusted-step case in tensor mode (2 nodes x 4-way TP, 3
    epochs of 12 steps), hybrid ``{data: 2, model: 4}`` (one epoch) and
    the data-mode run on the same params and batches."""
    root = tmp_path_factory.mktemp("tp")
    _, jp = _jparams(seed=3)
    out = {}
    for name, kw, epochs in (
            ("tensor", dict(parallelism="tensor", mesh=tmesh.build_mesh(
                2, "tensor", devices=CPU8)), 3),
            ("hybrid", dict(parallelism="hybrid",
                            mesh_shape={DATA: 2, MODEL: 4}), 1),
            ("data", {}, 3)):
        tr = _trainer(root, name, detector_warmup=4, **kw)
        tr.initialize(params=_torch(jp))
        out[name] = (tr,) + _epochs(tr, epochs)
    return out


def test_tp_composes_with_trusted_step(tp_runs):
    """Tensor mode end to end (JAX's assertions): the node axis rides
    ``data`` while each node's weights lay out over its TP group; losses
    finite and falling, no false positive, trust high."""
    tr, losses, rec = tp_runs["tensor"]
    assert tr.mesh.shape == {DATA: 2, MODEL: 4}
    qkv = tr.state.params["blocks"]["attn"]["qkv"]["w"]
    spec = tr.specs["params"]["blocks"]["attn"]["qkv"]["w"]
    assert shreg.NamedSharding(tr.mesh, spec).shard_shape(qkv.shape)[-1] \
        == qkv.shape[-1] // 4
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(tr.attack_history) == 0
    assert all(tr.trust_manager.get_trust_score(i) > 0.6 for i in range(2))
    _, _, data = tp_runs["data"]
    assert rec == data           # bit for bit: data mode's step


def test_hybrid_mesh_trusted_step_with_tp(tp_runs):
    """hybrid ``{data: 2, model: 4}``: the TP layout on the ``model``
    axis, the trusted step with 2 trust nodes, and data mode's first
    epoch bit for bit."""
    tr, losses, rec = tp_runs["hybrid"]
    assert tr.mesh.shape == {DATA: 2, MODEL: 4}
    assert MODEL in tr.specs["params"]["blocks"]["attn"]["qkv"]["w"]
    assert np.isfinite(losses).all()
    assert tuple(tr.state.trust.scores.shape) == (2,)
    _, _, data = tp_runs["data"]
    n = len(rec["loss"])
    assert rec == {k: v[:n] for k, v in data.items()}
    assert tp_runs["tensor"][0].specs == tr.specs


# --------------------------------------------------------------------------
# tests/test_zero1.py and tests/test_sharding.py:393-469, :506
# --------------------------------------------------------------------------

ZERO = dict(model_name="gpt2", batch_size=16, num_nodes=8,
            learning_rate=3e-3, detector_warmup=4)


def _jtrainer(tmp_path, tag, **kw):
    jtr = JTrainer(JTrainingConfig(
        dataset_name="openwebtext", optimizer="adamw",
        checkpoint_interval=10 ** 9, checkpoint_dir=str(tmp_path / tag),
        **{**ZERO, **kw}), model_overrides=dict(TINY))
    jtr.initialize()
    return jtr


def _port_zero(tmp_path, tag, init, **kw):
    tr = _trainer(tmp_path, tag, mesh=tmesh.build_mesh(8, "data",
                                                       devices=CPU8),
                  **{**ZERO, **kw})
    tr.initialize(params=_torch(init))
    return tr


def _port_opt_specs(tr):
    o = tr.specs["opt_state"]
    return [o["count"]] + o["mu"] + o["nu"]


def _jopt_specs(jtr):
    adam = jtr.state.opt_state[0][0]
    return [tuple(adam.count.sharding.spec)] + _spec_leaves(adam.mu) + \
        _spec_leaves(adam.nu)


@pytest.fixture(scope="module")
def zero_runs(tmp_path_factory):
    """JAX's ZeRO-1 arm (8 nodes on 8 devices, 4 steps of one batch) and
    the port's replicated, ZeRO-1 and FSDP arms from JAX's initial
    params."""
    root = tmp_path_factory.mktemp("zero")
    jtr = _jtrainer(root, "j", shard_opt_state=True)
    jspecs = _jopt_specs(jtr)
    # The step donates its state: the initial params are read first.
    init = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    jbatch = jtr._node_batch(jtr.model.example_batch(16))
    batch = {k: np.asarray(v).reshape((16,) + np.asarray(v).shape[2:])
             for k, v in jbatch.items()}
    state, jlosses = jtr.state, []
    for _ in range(4):
        state, m = jtr._train_step(state, jbatch, jnull_plan(8))
        jlosses.append(float(m.loss))
    jfinal = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        np.asarray, state.params))
    ports = {}
    for tag, kw in (("rep", {}), ("zero", dict(shard_opt_state=True)),
                    ("fsdp", dict(shard_opt_state=True,
                                  shard_params=True))):
        tr = _port_zero(root, tag, init, **kw)
        losses = [tr.train_step(batch, 0)["loss"] for _ in range(4)]
        ports[tag] = (tr, losses)
    return dict(jtr=jtr, jspecs=jspecs, jlosses=jlosses, jfinal=jfinal,
                ports=ports, root=root)


def test_moments_actually_shard(zero_runs):
    """ZeRO-1: the moment specs name ``data``, JAX's leaf for leaf, and a
    position holds less of each sharded moment."""
    tr, _ = zero_runs["ports"]["zero"]
    specs = _port_opt_specs(tr)
    assert specs == zero_runs["jspecs"]
    moments = tr.state.opt_state.mu + tr.state.opt_state.nu
    sharded = 0
    for leaf, spec in zip(moments, specs[1:]):
        if DATA in spec:
            sharded += 1
            assert np.prod(shreg.NamedSharding(tr.mesh, spec).shard_shape(
                leaf.shape)) < leaf.numel()
    assert sharded >= 4
    state, o_specs = zero1_place_opt_state(tr.state.opt_state, tr.mesh)
    assert [o_specs["count"]] + o_specs["mu"] + o_specs["nu"] == specs


def test_zero1_numerics_match_jax_and_replicated(zero_runs):
    """JAX's pair, the ZeRO-1 arm against the replicated one: the port's
    ZeRO-1 and FSDP arms are its replicated run bit for bit (losses, and
    a relative parameter distance of 0 under JAX's 1e-3).  Against JAX's
    ZeRO-1 run: losses within JAX's rtol 1e-4.  The parameters differ
    across the packages only where Adam's first updates (about +-lr
    while nu is near 0) flip sign on gradients at epsilon scale, JAX's
    own note on this test: no coordinate moves more than 2 lr a step
    apart."""
    ports = zero_runs["ports"]
    rep = ports["rep"][1]
    for tag in ("zero", "fsdp"):
        assert ports[tag][1] == rep
        for a, b in zip(tree_leaves(ports[tag][0].state.params),
                        tree_leaves(ports["rep"][0].state.params)):
            assert torch.equal(a, b)
    np.testing.assert_allclose(rep, zero_runs["jlosses"], rtol=1e-4)
    steps, lr = len(rep), ZERO["learning_rate"]
    for a, b in zip(tree_leaves(ports["zero"][0].state.params),
                    zero_runs["jfinal"]):
        assert float(np.abs(a.numpy() - b).max()) <= 2 * lr * steps


def test_fsdp_bytes_and_specs_match_jax(zero_runs, tmp_path):
    """FSDP (``shard_params`` with ``shard_opt_state``): params and
    moments a position near 1/8 of the replicated bytes (JAX's bound: 1/8
    + 0.15), the specs and ratios JAX's."""
    jfs = _jtrainer(tmp_path, "jfs", shard_params=True,
                    shard_opt_state=True)
    tr, _ = zero_runs["ports"]["fsdp"]
    assert tree_leaves(tr.specs["params"]) == _spec_leaves(jfs.state.params)
    assert _port_opt_specs(tr) == _jopt_specs(jfs)
    ratio = shreg.tree_bytes_per_device(
        tr.state.params, tr.specs["params"], tr.mesh) / \
        shreg.tree_bytes_per_device(tr.state.params)
    jratio = jshreg.tree_bytes_per_device(jfs.state.params) / \
        sum(x.nbytes for x in jax.tree_util.tree_leaves(jfs.state.params))
    assert ratio == pytest.approx(jratio) and ratio <= 1.0 / 8 + 0.15
    tree = shreg.opt_state_tree(tr.state.opt_state)
    ratio_opt = shreg.tree_bytes_per_device(
        tree, tr.specs["opt_state"], tr.mesh) / \
        shreg.tree_bytes_per_device(tree)
    assert ratio_opt <= 1.0 / 8 + 0.15


def test_layout_equivalence_dp_vs_fsdp_and_tp_verdicts(tmp_path):
    """The same seeded run under replicated, FSDP and TP layouts under a
    poisoning plan: losses, attacked masks, statuses and trust equal bit
    for bit (JAX holds them within its accumulation tolerance)."""
    _, jp = _jparams(seed=5)
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[1],
        intensity=0.5, start_step=6))
    attacker.activate_attacks()
    arms = {}
    for tag, mesh, kw in (
            ("dp", tmesh.build_mesh(8, "data", devices=CPU8), {}),
            ("fsdp", tmesh.build_mesh(8, "data", devices=CPU8),
             dict(shard_params=True, shard_opt_state=True)),
            ("tp", tmesh.Mesh(np.array([torch.device("cpu")] * 16,
                                       dtype=object).reshape(8, 2),
                              (DATA, MODEL)), dict(parallelism="tensor"))):
        tr = _trainer(tmp_path, tag, mesh=mesh, num_nodes=8, batch_size=16,
                      detector_warmup=4, **kw)
        tr.initialize(params=_torch(jp))
        tr.set_attack_plan(attacker.plan(8))
        _, arms[tag] = _epochs(tr, 1, examples=160, batch=16)
    assert arms["dp"] == arms["fsdp"] == arms["tp"]
    assert any(a[1] for a in arms["dp"]["attacked"])


def test_evict_readmit_reproduces_registry_specs(tmp_path, eight_devices):
    """An evict/readmit cycle lays out through the same spec function as
    a fresh trainer: after readmission the param and moment specs are the
    fresh ones; mid-cycle the 4-position mesh shards with the same rule
    (JAX's specs at each point, from JAX's own migration)."""
    jtr = _jtrainer(tmp_path, "j", shard_params=True, shard_opt_state=True)
    tr = _port_zero(tmp_path, "t", jtr.state.params, shard_params=True,
                    shard_opt_state=True)
    fresh = tr.specs
    for j, fn, arg in ((jel.evict_and_reshard, el.evict_and_reshard,
                        [1, 3, 5, 7]),
                       (jel.readmit_and_reshard, el.readmit_and_reshard,
                        [1, 3, 5, 7])):
        jrec, rec = j(jtr, arg), fn(tr, arg)
        assert rec["new_device_count"] == jrec["new_device_count"]
        assert tree_leaves(tr.specs["params"]) == \
            _spec_leaves(jtr.state.params)
        assert _port_opt_specs(tr) == _jopt_specs(jtr)
        if "evicted_nodes" in rec:
            assert rec["new_device_count"] == 4
            assert any(DATA in s for s in tree_leaves(tr.specs["params"]))
            assert any(DATA in s for s in tr.specs["opt_state"]["mu"])
    assert tr.specs == fresh and tr.mesh.shape == {DATA: 8}
    batch = {k: v.numpy() for k, v in tr.model.example_batch(
        16, torch.Generator().manual_seed(0)).items()}
    assert np.isfinite(tr.train_step(batch, 0)["loss"])


# --------------------------------------------------------------------------
# tests/test_moe.py:203 and :244
# --------------------------------------------------------------------------

def test_expert_parallel_matches_jax(eight_devices):
    """The forward under an 8-position expert mesh against JAX's
    EP-sharded forward at JAX's rtol 2e-4; ``moe_ep_specs`` JAX's leaf for
    leaf, the expert weights an expert a position."""
    jm = JMesh(np.array(eight_devices), (EXPERT,))
    mesh = tmesh.Mesh(np.array([torch.device("cpu")] * 8, dtype=object),
                      (EXPERT,))
    jcfg = jmoe.MoEConfig(**ARCH, n_experts=8, top_k=2, dtype=jnp.float32)
    jp = jmoe.init_params(jax.random.PRNGKey(3), jcfg)
    tokens = np.random.default_rng(4).integers(
        0, ARCH["vocab_size"], (2, 16)).astype(np.int32)
    jspecs = jmoe.moe_ep_specs(jp)
    jsharded = jax.device_put(jp, jax.tree_util.tree_map(
        lambda s: JNamedSharding(jm, s), jspecs,
        is_leaf=lambda x: isinstance(x, P)))
    with jmoe.use_expert_mesh(jm):
        want = jax.jit(jmoe.forward, static_argnums=2)(
            jsharded, jnp.asarray(tokens), jcfg)
    params = _torch(jp)
    specs = tmoe.moe_ep_specs(params)
    assert tree_leaves(specs) == _spec_leaves_plain(jspecs)
    fc, fc_spec = params["blocks"]["moe"]["fc"]["w"], \
        specs["blocks"]["moe"]["fc"]["w"]
    assert shreg.NamedSharding(mesh, fc_spec).shard_shape(
        fc.shape)[1] == 1 == \
        jsharded["blocks"]["moe"]["fc"]["w"].addressable_shards[0].data.shape[1]
    cfg = tmoe.MoEConfig(**ARCH, n_experts=8, top_k=2, dtype=torch.float32)
    with tmoe.use_expert_mesh(mesh):
        assert tmoe._expert_sharding().spec == (EXPERT, None, None)
        got = tmoe.forward(params, torch.from_numpy(tokens).long(), cfg)
    assert tmoe.get_expert_mesh() is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_trainer_expert_parallelism_end_to_end(tmp_path):
    """parallelism='expert' (JAX's case): trust nodes on ``data``, the
    experts' mesh axis ``expert``; finite losses, per-node verdict
    shapes, every step's drop fraction in [0, 1]; and the MoE data-mode
    run bit for bit."""
    over = dict(TINY, n_experts=4)
    runs = {}
    for tag, kw in (("expert", dict(parallelism="expert",
                                    mesh=tmesh.build_mesh(
                                        2, "expert", devices=CPU8))),
                    ("data", {})):
        tr = _trainer(tmp_path, tag, model_name="gpt2-moe",
                      learning_rate=1e-3, model_overrides=over, **kw)
        tr.initialize(seed=0)
        _, rec = _epochs(tr, 1, examples=16)
        runs[tag] = (tr, rec, [h["moe_drop_fraction"]
                               for h in tr.batch_history])
    tr, rec, drops = runs["expert"]
    assert tr.mesh.axis_names == (DATA, EXPERT)
    assert tr.mesh.shape == {DATA: 2, EXPERT: 4}
    assert tmoe.get_expert_mesh() is tr.mesh
    assert rec["loss"] and all(np.isfinite(rec["loss"]))
    assert tuple(tr.state.trust.scores.shape) == (2,)
    assert all(0.0 <= d <= 1.0 for d in drops)
    assert (rec, drops) == runs["data"][1:]
    tmoe.set_expert_mesh(None)


def test_expert_mode_on_a_dense_model_warns(tmp_path, caplog):
    with caplog.at_level("WARNING"):
        tr = _trainer(tmp_path, "dense", parallelism="expert")
    assert any("non-MoE model" in r.getMessage() for r in caplog.records)
    assert tr.mesh.axis_names == (DATA, EXPERT)
    tmoe.set_expert_mesh(None)
