"""The group modes of the port's elastic eviction and readmission
(``elastic/reassignment.py``) against the JAX package's, on the CPU;
mirrors ``tests/test_elastic_modes.py``.

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``); the port's
single-controller mesh has 8 positions, all the CPU.

* Unit tier, against JAX's functions on equivalent meshes: the positions
  a node owns and the survivors of an eviction (group, one-a-node and dev
  mode), ``elastic_supported`` over JAX's eligible and ineligible
  configurations, the TP moment specs following their params (AdamW, and
  Adafactor, whose factored statistics replicate).
* Integration tier, one module-scoped run of each package a mode
  (tensor, sequence, expert on the MoE model, hybrid ``{data: 4, model:
  2}``): tiny GPT-2 in f32, 4 nodes x 2 sequences on a (4, 2) mesh, node
  1 poisoned from step 6: the run evicts its group (the mesh to (3, 2));
  in tensor mode (JAX's re-evicted hostile group) the attack stays while
  the node is readmitted on probation after 4 steps and evicted again;
  then the attack is cleared, node 1 comes back (the mesh to (4, 2)) and
  training goes on at 4 nodes.  Equal to JAX's:
  every step's node count, the incidents, each record (ids, step,
  ``new_device_count``: positions here, devices there), the node map,
  the mesh shapes, the loader's batch sizes.  Within the training
  contract's 1e-5: every step's loss and trust.  JAX's hybrid spelling of
  the tensor layout compiles JAX's tensor program (the same mesh, the
  same specs, checked), so the port's hybrid run is held to JAX's tensor
  run.  Each port mode also equals the port's own data-mode run on the
  same inputs bit for bit (one device, the same step), and after the
  cycle its layout specs equal a fresh trainer's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import \
    AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.core import sharding as jshreg
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.core.mesh import build_mesh as jbuild_mesh
from trustworthy_dl_tpu.data import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.elastic import reassignment as jel
from trustworthy_dl_tpu.engine.trainer import DistributedTrainer as JTrainer
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models import moe as jmoe
from trustworthy_dl_tpu.parallel import sequence as jseq
from trustworthy_dl_tpu.parallel import tensor_parallel as jtp
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.attacks.adversarial import null_plan
from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.core.mesh import build_mesh
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.elastic import reassignment as el
from trustworthy_dl_tpu_torch.engine.optimizer import Optimizer
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.models import moe as tmoe
from trustworthy_dl_tpu_torch.parallel import sequence as tseq
from trustworthy_dl_tpu_torch.parallel import tensor_parallel as tp
from trustworthy_dl_tpu_torch.trust.state import NodeStatus
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

CPU8 = ["cpu"] * 8
ARCH = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32)
TINY = dict(ARCH, seq_len=16)
NODES, BATCH = 4, 8
# No prefetch thread: how many old-size batches it has queued when the
# loader is re-sized depends on the thread's timing (in both packages).
CONFIG = dict(batch_size=BATCH, num_nodes=NODES, learning_rate=3e-3,
              detector_warmup=4, checkpoint_interval=10_000,
              elastic_resharding=True, readmit_after_steps=4,
              prefetch_depth=0)
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[1],
              intensity=0.5, start_step=6)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)
    yield
    # The trainers bind both packages' global sequence and expert meshes.
    for unbind in (tseq.set_sequence_mesh, tmoe.set_expert_mesh,
                   jseq.set_sequence_mesh, jmoe.set_expert_mesh):
        unbind(None)


# ---------------------------------------------------------------------------
# Unit tier
# ---------------------------------------------------------------------------

def test_node_device_group_and_survivors(eight_devices):
    """The positions of a node and the survivors, position for device
    (positions named ``cpu:i`` here to tell them apart): a (4, 2) group
    mesh, one-a-node data mode, and dev mode (the nodes share every
    position: nothing leaves)."""
    named = [f"cpu:{i}" for i in range(8)]

    def ids(devices):
        return [d.index if isinstance(d, torch.device) else d.id
                for d in devices]

    jmesh = jbuild_mesh(4, "tensor", devices=eight_devices)
    mesh = build_mesh(4, "tensor", devices=named)
    assert mesh.devices.shape == jmesh.devices.shape == (4, 2)
    assert ids(mesh.devices.flat) == ids(jmesh.devices.flat)
    assert ids(el.node_device_group(mesh, 4, 1)) == \
        ids(jel.node_device_group(jmesh, 4, 1)) == [2, 3]
    assert ids(el.surviving_devices(mesh, 4, [1])) == \
        ids(jel.surviving_devices(jmesh, 4, [1])) == [0, 1, 4, 5, 6, 7]
    dmesh = build_mesh(8, "data", devices=named)
    jdmesh = jbuild_mesh(8, "data", devices=eight_devices)
    assert dmesh.shape == dict(jdmesh.shape) == {"data": 8}
    assert ids(el.node_device_group(dmesh, 8, 5)) == \
        ids(jel.node_device_group(jdmesh, 8, 5)) == [5]
    assert ids(el.surviving_devices(dmesh, 8, [5])) == \
        ids(jel.surviving_devices(jdmesh, 8, [5]))
    small = build_mesh(2, "data", devices=named[:2])
    jsmall = jbuild_mesh(2, "data", devices=eight_devices[:2])
    assert el.node_device_group(small, 4, 1) == \
        jel.node_device_group(jsmall, 4, 1) == []
    assert ids(el.surviving_devices(small, 4, [1])) == \
        ids(jel.surviving_devices(jsmall, 4, [1])) == [0, 1]


ELIGIBLE = [
    ("hybrid", dict(mesh_shape={"data": 4, "model": 2})),
    ("hybrid", dict(mesh_shape={"data": 2, "model": 2})),
    ("hybrid", dict(mesh_shape={"data": 4, "stage": 2})),
    ("hybrid", dict(mesh_shape={"data": 4, "model": 2},
                    dcn_mesh_shape={"data": 2})),
    ("data", {}), ("tensor", {}), ("sequence", {}), ("expert", {}),
    ("model", {}),
]


@pytest.mark.parametrize("mode,kw", ELIGIBLE)
def test_elastic_supported_predicate(mode, kw):
    """JAX's verdict on every configuration of its test, and the hybrid
    rebuild's shape."""
    cfg = TrainingConfig(model_name="gpt2", num_nodes=4, parallelism=mode,
                         **kw)
    jcfg = JTrainingConfig(model_name="gpt2", num_nodes=4, parallelism=mode,
                           **kw)
    assert el.elastic_supported(cfg) == jel.elastic_supported(jcfg)
    assert el.elastic_mesh_shape(cfg, 3) == jel.elastic_mesh_shape(jcfg, 3)
    assert el.ELASTIC_MODES == jel.ELASTIC_MODES


def _jtp_params(eight_devices):
    jmesh = jbuild_mesh(4, "tensor", devices=eight_devices)
    cfg = jgpt2.GPT2Config(dtype=jnp.float32, **ARCH)
    jparams = jtp.apply_tp_sharding(
        jgpt2.init_params(jax.random.PRNGKey(0), cfg), jmesh)
    params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    return jmesh, jparams, params


def _spec_leaves(tree):
    is_spec = lambda x: x is None or isinstance(  # noqa: E731
        x, jax.sharding.PartitionSpec)
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        jshreg.mesh_spec_tree(tree), is_leaf=is_spec)]


def test_tp_opt_sharding_follows_params(eight_devices):
    """AdamW's moments take their params' TP specs, as JAX's
    ``apply_tp_sharding_to_opt`` lays optax's mirrors; the count
    replicates."""
    jmesh, jparams, params = _jtp_params(eight_devices)
    jplaced = jtp.apply_tp_sharding_to_opt(optax.adamw(1e-3).init(jparams),
                                           jparams, jmesh)
    mesh = build_mesh(4, "tensor", devices=CPU8)
    opt = Optimizer("adamw", 1e-3).init(tree_leaves(params))
    placed, specs = tp.apply_tp_sharding_to_opt(opt, params, mesh)
    assert specs["mu"] == _spec_leaves(jplaced[0].mu)
    assert specs["nu"] == _spec_leaves(jplaced[0].nu)
    assert specs["count"] == () and placed.count.dim() == 0
    assert specs["mu"] == tree_leaves(tp.apply_tp_sharding(params, mesh)[1])


def test_tp_opt_sharding_skips_factored_adafactor_stats(eight_devices):
    """Adafactor: a full second moment takes its param's spec as JAX's
    reshard lays it; a factored row or column statistic replicates, as
    JAX replicates its reduced-rank leaves (n_embd 256: the four block
    weights and wte factor, their two largest dims >= 128)."""
    arch = dict(ARCH, n_embd=256)
    jmesh = jbuild_mesh(4, "tensor", devices=eight_devices)
    cfg = jgpt2.GPT2Config(dtype=jnp.float32, **arch)
    jparams = jtp.apply_tp_sharding(
        jgpt2.init_params(jax.random.PRNGKey(0), cfg), jmesh)
    jplaced = jtp.apply_tp_sharding_to_opt(
        optax.adafactor(learning_rate=1e-3).init(jparams), jparams, jmesh)
    params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
    mesh = build_mesh(4, "tensor", devices=CPU8)
    opt = Optimizer("adafactor", 1e-3).init(tree_leaves(params))
    _, specs = tp.apply_tp_sharding_to_opt(opt, params, mesh)
    # JAX's per-leaf (v_row, v_col, v) slots, v a (1,) placeholder
    # where the leaf factors; the port keeps (v_row, v_col) there and
    # (v,) elsewhere.
    jstate = next(s for s in jax.tree_util.tree_leaves(
        jplaced, is_leaf=lambda x: hasattr(x, "v_row"))
        if hasattr(s, "v_row"))
    port = iter(specs["nu"])
    factored = 0
    for row, col, v, jv in zip(_spec_leaves(jstate.v_row),
                               _spec_leaves(jstate.v_col),
                               _spec_leaves(jstate.v),
                               jax.tree_util.tree_leaves(jstate.v)):
        if tuple(jv.shape) == (1,):
            factored += 1
            assert (next(port), next(port)) == (row, col) == ((), ())
        else:
            assert next(port) == v
    assert factored == 5 and next(port, None) is None
    assert specs["mu"] == [] and specs["count"] == ()


# ---------------------------------------------------------------------------
# Integration tier
# ---------------------------------------------------------------------------

def _mode_kwargs(mode):
    model = "gpt2-moe" if mode == "expert" else "gpt2"
    extra = {"mesh_shape": {"data": 4, "model": 2}} \
        if mode == "hybrid" else {}
    over = dict(TINY, n_experts=4) if mode == "expert" else dict(TINY)
    return model, extra, over


def _drive(trainer, plan, loader_fn, null_fn, cycles):
    """The module's schedule: ``cycles`` evictions under the attack (a
    second one after the readmission of a still-hostile node), then the
    attack cleared until the node is back; returns what both packages are
    held to."""
    trainer.set_attack_plan(plan)
    vocab = TINY["vocab_size"]
    dl = loader_fn("openwebtext", batch_size=BATCH, seq_len=16,
                   vocab_size=vocab, num_examples=48)
    out = {"epochs": []}

    def evictions():
        return [r for r in trainer.reassignment_history
                if "evicted_nodes" in r]

    def epoch_end():
        out["epochs"].append((trainer.config.num_nodes,
                              tuple(trainer.mesh.devices.shape),
                              dl.batch_size, trainer.config.batch_size))

    epoch = 0
    while len(evictions()) < cycles and epoch < 8:
        trainer.train_epoch(dl, epoch)
        epoch_end()
        epoch += 1
    out["evicted_devices"] = {k: len(v) for k, v in
                              trainer._evicted_devices.items()}
    out["mid_mesh"] = tuple(trainer.mesh.devices.shape)
    trainer.set_attack_plan(null_fn(trainer.config.num_nodes))
    while trainer.config.num_nodes < NODES and epoch < 14:
        trainer.train_epoch(dl, epoch)
        epoch_end()
        epoch += 1
    out["final_loss"] = trainer.train_epoch(dl, epoch)
    epoch_end()
    hist = trainer.metrics_collector.batch_metrics
    out.update(
        steps=[h["step"] for h in hist],
        loss=[h["loss"] for h in hist],
        trust=[[h["trust_scores"][k] for k in sorted(h["trust_scores"])]
               for h in hist],
        nodes=[len(h["trust_scores"]) for h in hist],
        incidents=[(r["node_id"], r["step"], r["attack_type"])
                   for r in trainer.attack_history],
        records=[{k: v for k, v in r.items()
                  if k not in ("timestamp", "migration_time_s",
                               "bytes_moved", "measured_gbps")}
                 for r in trainer.reassignment_history],
        node_map=list(trainer.node_map),
        status=trainer.trust_manager.get_node_status(1))
    coord = trainer.node_map.index(1)
    out["readmitted_recovery_rate"] = float(
        np.asarray(trainer.state.trust.recovery_rate)[coord])
    return out


def _cycles(mode):
    """JAX's re-evicted hostile group is its tensor-mode test: two
    eviction cycles there (and in hybrid, its layout), one elsewhere."""
    return 2 if mode in ("tensor", "hybrid") else 1


#: JAX's run of each program, once a module: hybrid {data: 4, model: 2}
#: reads tensor mode's.
_JAX_RUNS = {}


def _jax_run(mode, root):
    mode = "tensor" if mode == "hybrid" else mode
    if mode not in _JAX_RUNS:
        _JAX_RUNS[mode] = _jax_drive(mode, root)
    return _JAX_RUNS[mode]


def _jax_drive(mode, root):
    model, extra, over = _mode_kwargs(mode)
    jtr = JTrainer(JTrainingConfig(
        model_name=model, parallelism=mode,
        checkpoint_dir=str(root / "j"), **CONFIG, **extra),
        model_overrides=dict(over, dtype=jnp.float32))
    jtr.initialize()
    init = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    jatt = JAttacker(JAttackConfig(**ATTACK))
    jatt.activate_attacks()
    mesh_before = tuple(jtr.mesh.devices.shape)
    run = _drive(jtr, jatt.plan(NODES), jget_dataloader, jnull_plan,
                 _cycles(mode))
    run["mesh_before"] = mesh_before
    jseq.set_sequence_mesh(None)
    jmoe.set_expert_mesh(None)
    return init, run


def _port_trainer(mode, root, tag, model_of=None):
    """The port's trainer of ``mode``, on the model of ``model_of``'s run
    (data mode beside expert mode trains the MoE model)."""
    model, _, over = _mode_kwargs(model_of or mode)
    extra = _mode_kwargs(mode)[1]
    mesh = None if mode in ("data", "hybrid") else \
        build_mesh(NODES, mode, devices=CPU8)
    return DistributedTrainer(
        TrainingConfig(model_name=model, parallelism=mode,
                       checkpoint_dir=str(root / tag), **CONFIG, **extra),
        mesh=mesh, model_overrides=dict(over, dtype=torch.float32),
        device="cpu")


def _port_run(mode, root, init, tag="t", model_of=None):
    tr = _port_trainer(mode, root, tag, model_of)
    tr.initialize(params=convert.params_from_jax(init))
    fresh = tr.specs
    att = AdversarialAttacker(AttackConfig(**ATTACK))
    att.activate_attacks()
    mesh_before = tuple(tr.mesh.devices.shape)
    run = _drive(tr, att.plan(NODES), get_dataloader, null_plan,
                 _cycles(model_of or mode))
    run["mesh_before"] = mesh_before
    return tr, fresh, run


@pytest.fixture(scope="module", params=["tensor", "sequence", "expert",
                                        "hybrid"])
def runs(request, tmp_path_factory):
    mode = request.param
    root = tmp_path_factory.mktemp(f"elastic_{mode}")
    init, jrun = _jax_run(mode, root)
    tr, fresh, run = _port_run(mode, root, init)
    tseq.set_sequence_mesh(None)
    tmoe.set_expert_mesh(None)
    _, _, data = _port_run("data", root, init, tag="d", model_of=mode)
    return dict(mode=mode, jrun=jrun, run=run, tr=tr, fresh=fresh,
                data=data, root=root)


def test_group_eviction_and_readmission(runs):
    """JAX's schedule in every group mode: the group leaves with its node
    (the mesh (4, 2) -> (3, 2)), is readmitted on probation, evicted again
    while still hostile, and returns once the attack is cleared."""
    run, jrun = runs["run"], runs["jrun"]
    assert run["mesh_before"] == jrun["mesh_before"] == (4, 2)
    assert run["mid_mesh"] == jrun["mid_mesh"] == (3, 2)
    assert run["evicted_devices"] == jrun["evicted_devices"] == {1: 2}
    assert run["epochs"] == jrun["epochs"]
    assert run["epochs"][-1][:2] == (4, (4, 2))
    assert run["steps"] == jrun["steps"]
    assert run["nodes"] == jrun["nodes"]
    assert run["incidents"] == jrun["incidents"]
    assert {i[0] for i in run["incidents"]} == {1}
    assert run["records"] == jrun["records"]
    evictions = [r for r in run["records"] if "evicted_nodes" in r]
    readmits = [r for r in run["records"] if "readmitted_nodes" in r]
    cycles = _cycles(runs["mode"])
    assert [r["evicted_nodes"] for r in evictions] == [[1]] * cycles
    assert [r["new_device_count"] for r in evictions] == [6] * cycles
    assert [r["new_device_count"] for r in readmits] == [8] * cycles
    assert run["node_map"] == jrun["node_map"] and run["node_map"][-1] == 1
    assert run["readmitted_recovery_rate"] == pytest.approx(0.02)
    assert run["status"] != NodeStatus.COMPROMISED


def test_group_modes_losses_and_trust_match_jax(runs):
    run, jrun = runs["run"], runs["jrun"]
    np.testing.assert_allclose(run["loss"], jrun["loss"], rtol=0, atol=ATOL)
    assert [len(t) for t in run["trust"]] == [len(t) for t in jrun["trust"]]
    np.testing.assert_allclose(sum(run["trust"], []), sum(jrun["trust"], []),
                               rtol=0, atol=ATOL)
    assert np.isfinite(run["final_loss"])


def test_group_modes_equal_the_port_data_mode(runs):
    """The port's tensor, hybrid and expert modes are its data-mode step
    on one device: the whole trajectory bit for bit, only the positions
    differ.  Sequence mode runs ring attention, which merges its chunks
    in another order than full attention: within the contract's 1e-5
    there."""
    run, data = runs["run"], runs["data"]
    if runs["mode"] == "sequence":
        np.testing.assert_allclose(run["loss"], data["loss"], rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(sum(run["trust"], []),
                                   sum(data["trust"], []), rtol=0,
                                   atol=ATOL)
    else:
        assert run["loss"] == data["loss"]
        assert run["trust"] == data["trust"]
    assert run["incidents"] == data["incidents"]
    assert [{k: v for k, v in r.items() if k != "new_device_count"}
            for r in run["records"]] == \
        [{k: v for k, v in r.items() if k != "new_device_count"}
         for r in data["records"]]


def test_layout_after_the_cycle_equals_a_fresh_trainers(runs):
    """Every transition lays the state out through the one spec function:
    after the evict/readmit cycles the specs equal the fresh trainer's,
    and mid-cycle tensor layouts keep qkv column-sharded 2 ways."""
    tr = runs["tr"]
    assert tr.specs == runs["fresh"]
    qkv = tr.state.params["blocks"]["attn"]["qkv"]["w"]
    spec = tr.specs["params"]["blocks"]["attn"]["qkv"]["w"]
    shard = shreg.NamedSharding(tr.mesh, spec).shard_shape(qkv.shape)
    if runs["mode"] in ("tensor", "hybrid"):
        assert spec == (None, None, "model")
        assert shard[-1] == qkv.shape[-1] // 2
    else:
        assert all(s == () for s in tree_leaves(tr.specs["params"]))
    if runs["mode"] == "hybrid":
        assert tr.config.mesh_shape == {"data": 4, "model": 2}


def test_jax_hybrid_is_its_tensor_layout(eight_devices, tmp_path):
    """Why the port's hybrid run is held to JAX's tensor run: JAX's
    hybrid ``{data: 4, model: 2}`` trainer builds the tensor trainer's
    mesh and parameter specs (no step compiles here), and so does the
    port's."""
    model, extra, over = _mode_kwargs("hybrid")
    jh = JTrainer(JTrainingConfig(model_name=model, parallelism="hybrid",
                                  checkpoint_dir=str(tmp_path / "h"),
                                  **CONFIG, **extra),
                  model_overrides=dict(over, dtype=jnp.float32))
    jt = JTrainer(JTrainingConfig(model_name=model, parallelism="tensor",
                                  checkpoint_dir=str(tmp_path / "t"),
                                  **CONFIG),
                  model_overrides=dict(over, dtype=jnp.float32))
    jh.initialize()
    jt.initialize()
    assert dict(jh.mesh.shape) == dict(jt.mesh.shape) == \
        {"data": 4, "model": 2}
    assert _spec_leaves(jh.state.params) == _spec_leaves(jt.state.params)
    h, t = _port_trainer("hybrid", tmp_path, "ph"), \
        _port_trainer("tensor", tmp_path, "pt")
    h.initialize()
    t.initialize()
    assert h.mesh.shape == t.mesh.shape == {"data": 4, "model": 2}
    assert h.specs == t.specs
    assert tree_leaves(h.specs["params"]) == _spec_leaves(jh.state.params)


@pytest.mark.parametrize("mode", ["tensor", "hybrid"])
def test_resume_adopts_the_group_topology_as_jax(mode, tmp_path,
                                                 eight_devices):
    """A checkpoint saved after a group eviction resumes, in a fresh
    trainer built for 4 nodes, onto the saved (3, 2) mesh (hybrid: its
    ``mesh_shape`` data extent 3), with the evicted node's 2 positions
    kept, as JAX's resume does; the layout is a fresh trainer's, and the
    readmission returns the group to (4, 2)."""
    model, extra, over = _mode_kwargs(mode)

    def make(tag):
        if tag == "port":
            return _port_trainer(mode, tmp_path, tag)
        return JTrainer(JTrainingConfig(
            model_name=model, parallelism=mode,
            checkpoint_dir=str(tmp_path / tag), **CONFIG, **extra),
            model_overrides=dict(over, dtype=jnp.float32))

    out = {}
    for tag, elastic in (("jax", jel), ("port", el)):
        tr = make(tag)
        tr.initialize()
        elastic.evict_and_reshard(tr, [1])
        tr.global_step = 5
        tr._evicted_at[1] = 5
        tr.save_checkpoint()
        tr.checkpointer.wait()
        fresh = make(tag)
        fresh.initialize()
        specs = getattr(fresh, "specs", None)
        fresh.load_checkpoint()
        out[tag] = dict(
            nodes=fresh.config.num_nodes, mesh_shape=fresh.config.mesh_shape,
            mesh=tuple(fresh.mesh.devices.shape),
            evicted={k: len(v) for k, v in fresh._evicted_devices.items()},
            node_map=list(fresh.node_map), evicted_at=dict(fresh._evicted_at))
        if tag == "port":
            assert fresh.specs == specs
            rec = el.readmit_and_reshard(fresh, [1])
            assert tuple(fresh.mesh.devices.shape) == (4, 2)
            assert rec["new_device_count"] == 8 and fresh.specs == specs
    assert out["port"] == out["jax"]
    assert out["port"]["mesh"] == (3, 2) and out["port"]["evicted"] == {1: 2}
    assert out["port"]["node_map"] == [0, 2, 3]
