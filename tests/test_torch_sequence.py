"""Sequence parallelism: the port's ring and Ulysses attention
(``parallel/sequence.py``), its ``sequence`` mesh and trainer branch,
against the JAX package's, on the CPU in f32.

JAX runs on its 8 virtual CPU devices (``tests/conftest.py``); the port's
single-controller mesh has 8 positions, all the CPU.  Inputs are made with
numpy from a seed and fed to both packages; GPT-2 parameters come from JAX
through ``models/convert.params_from_jax``.

* JAX's 7 cases of ``tests/test_sequence.py``: ring and Ulysses, forward
  and gradients, causal and not, against JAX's own functions on an 8-way
  ``seq`` mesh (JAX's tolerances: rtol 2e-4 / atol 2e-5 forward, 5e-4 /
  5e-5 gradients); the fallback to full attention with no mesh bound;
  GPT-2 end to end, loss and every gradient, against JAX's full-attention
  reference (rel 1e-4; rtol 2e-3 / atol 2e-4); the flash-chunk body at
  Tl = 64 against JAX's interpret-mode ring at 2 positions (T = 128, the
  smallest mesh with a non-causal chunk) and against full attention at 8
  positions (rtol 3e-4 / atol 3e-5 forward, 1e-3 / 1e-4 gradients).
  JAX's layout-only ``test_ring_attention_output_is_sequence_sharded`` has
  no counterpart: every position of the port's mesh may share one device.
* The calls of each body: R causal and R (R - 1) / 2 non-causal
  ``flash_chunk`` calls for a causal ring of R, R^2 non-causal otherwise;
  the einsum body where the chunk does not tile.
* ``build_mesh(n, "sequence", devices=...)``: JAX's axis names and shape.
* The trainer under attack (JAX's
  ``test_trainer_sequence_parallelism_with_attack``: 4 nodes on a (4, 2)
  mesh, tiny GPT-2, ring and Ulysses; 2 epochs of 8 steps where JAX's test
  runs 3, node 1 poisoned from step 8): losses and trust within 1e-5,
  incidents, gates and statuses equal, mesh names and shape equal.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from trustworthy_dl_tpu.attacks import AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.attacks import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.core.mesh import build_mesh as jbuild_mesh
from trustworthy_dl_tpu.data import get_dataloader as jget_dataloader
from trustworthy_dl_tpu.engine import DistributedTrainer as JTrainer
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.parallel import sequence as jseq
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    TrainingConfig
from trustworthy_dl_tpu_torch.core.mesh import SEQ_AXIS, Mesh, build_mesh
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.ops import flash_attention as fa
from trustworthy_dl_tpu_torch.parallel import sequence as seq
from trustworthy_dl_tpu_torch.trust.state import NodeStatus

pytestmark = pytest.mark.torchport

B, H, T, D = 2, 8, 64, 16   # T and H both divide the 8-way seq axis
IMPLS = {"ring": (seq.ring_attention, jseq.ring_attention),
         "ulysses": (seq.ulysses_attention, jseq.ulysses_attention)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)
    yield
    # The trainers bind both packages' global sequence meshes.
    seq.set_sequence_mesh(None)
    jseq.set_sequence_mesh(None)


def _mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object),
                (SEQ_AXIS,))


@pytest.fixture(scope="module")
def jmesh(eight_devices):
    return JMesh(np.array(eight_devices), ("seq",))


def _arrays(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _torch(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_parallel_matches_jax_forward(jmesh, impl, causal):
    fn, jfn = IMPLS[impl]
    q, k, v = _arrays((B, H, T, D), 0)
    with jseq.use_sequence_mesh(jmesh):
        want = jax.jit(jfn, static_argnums=3)(
            *(jnp.asarray(a) for a in (q, k, v)), causal)
    with seq.use_sequence_mesh(_mesh(8)):
        got = fn(*_torch((q, k, v)), causal)
    _close(got, want, rtol=2e-4, atol=2e-5)
    ref = gpt2.full_attention(*_torch((q, k, v)), causal)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_parallel_matches_jax_grads(jmesh, impl, causal):
    fn, jfn = IMPLS[impl]
    q, k, v = _arrays((B, H, T, D), 1)
    # Nonuniform cotangent so transpose errors cannot cancel out.
    weight = np.arange(T, dtype=np.float32)[None, None, :, None]

    def jscalar(q, k, v):
        return jnp.sum(jfn(q, k, v, causal) * weight)

    with jseq.use_sequence_mesh(jmesh):
        want = jax.jit(jax.grad(jscalar, argnums=(0, 1, 2)))(
            *(jnp.asarray(a) for a in (q, k, v)))
    args = _torch((q, k, v), grad=True)
    with seq.use_sequence_mesh(_mesh(8)):
        out = fn(*args, causal)
    got = torch.autograd.grad((out * torch.from_numpy(weight)).sum(), args)
    for g, w in zip(got, want):
        _close(g, w, rtol=5e-4, atol=5e-5)


def test_ring_attention_no_mesh_falls_back():
    # A trainer in sequence mode binds the global mesh; this test is
    # about the unbound state.
    seq.set_sequence_mesh(None)
    q, k, v = _torch(_arrays((B, H, T, D), 2))
    ref = gpt2.full_attention(q, k, v, True)
    assert torch.equal(seq.ring_attention(q, k, v, True), ref)
    assert torch.equal(seq.ulysses_attention(q, k, v, True), ref)
    # A mesh whose ring does not divide T falls back too.
    with seq.use_sequence_mesh(_mesh(3)):
        assert torch.equal(seq.ring_attention(q, k, v, True), ref)
    # A mesh without a seq axis is no sequence mesh.
    seq.set_sequence_mesh(build_mesh(4, "data"))
    assert seq.get_sequence_mesh() is None
    seq.set_sequence_mesh(None)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_attention_refuses_positions_off_the_inputs_device(impl):
    """A mesh whose positions lie on the card while the inputs lie on the
    CPU (or the reverse) is refused before anything moves: following it
    would run the attention on the wrong device unseen."""
    q, k, v = _torch(_arrays((B, H, T, D), 2))
    mesh = Mesh(np.array([torch.device("cuda")] * 4, dtype=object),
                (SEQ_AXIS,))
    with seq.use_sequence_mesh(mesh):
        with pytest.raises(ValueError, match="sequence mesh position"):
            IMPLS[impl][0](q, k, v, True)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt2_seq_parallel_end_to_end(impl):
    """Tiny GPT-2: the port's sequence-parallel loss and every parameter
    gradient against JAX's full-attention reference on JAX's params."""
    jbase = jgpt2.GPT2Config(vocab_size=128, n_positions=T, n_layer=2,
                             n_embd=32, n_head=8, dtype=jnp.float32,
                             attn_impl="full")
    jparams = jgpt2.init_params(jax.random.PRNGKey(1), jbase)
    tokens = np.random.default_rng(3).integers(0, 128, (B, T))
    batch = {"input": tokens, "target": np.roll(tokens, -1, axis=-1)}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jgpt2.loss_fn),
                                  static_argnums=2)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jbase)

    cfg = gpt2.GPT2Config(vocab_size=128, n_positions=T, n_layer=2,
                          n_embd=32, n_head=8, dtype=torch.float32,
                          attn_impl=impl)
    params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaves = [x.requires_grad_() for x in leaves]
    tparams = jax.tree_util.tree_unflatten(treedef, leaves)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with seq.use_sequence_mesh(_mesh(8)):
        loss = gpt2.loss_fn(tparams, tbatch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-4)
    jleaves = jax.tree_util.tree_leaves(
        convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       ref_grads)))
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunk_body_matches_jax_interpret_ring(eight_devices, causal):
    """At Tl = 64 the ring body routes each chunk through ``flash_chunk``
    and merges by logsumexp: against JAX's ring, whose chunks run the
    Pallas kernels in interpret mode, on 2 positions (T = 128: one causal
    chunk and one non-causal below it per causal ring), forward and
    gradients, the lse-cotangent term included."""
    t = 128
    assert fa.supports_flash(64, 16) and jseq._use_flash_chunks(64, 16)
    q, k, v = _arrays((1, 2, t, 16), 11)
    weight = np.arange(t, dtype=np.float32)[None, None, :, None] / t
    jmesh2 = JMesh(np.array(eight_devices[:2]), ("seq",))

    def jscalar(q, k, v):
        return jnp.sum(jseq.ring_attention(q, k, v, causal) * weight)

    jargs = [jnp.asarray(a) for a in (q, k, v)]
    with jseq.use_sequence_mesh(jmesh2):
        want = jax.jit(jseq.ring_attention, static_argnums=3)(*jargs, causal)
        want_g = jax.jit(jax.grad(jscalar, argnums=(0, 1, 2)))(*jargs)
    args = _torch((q, k, v), grad=True)
    with seq.use_sequence_mesh(_mesh(2)):
        got = seq.ring_attention(*args, causal)
    got_g = torch.autograd.grad((got * torch.from_numpy(weight)).sum(), args)
    _close(got, want, rtol=3e-4, atol=3e-5)
    for g, w in zip(got_g, want_g):
        _close(g, w, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunk_body_matches_full_attention(causal):
    """8 positions at Tl = 64 (JAX's ``test_ring_attention_flash_chunk_
    path``): forward and gradients against full attention."""
    t = 8 * 64
    q, k, v = _arrays((1, 2, t, 16), 12)
    weight = torch.arange(t, dtype=torch.float32)[None, None, :, None] / t
    args = _torch((q, k, v), grad=True)
    ref_in = _torch((q, k, v), grad=True)
    with seq.use_sequence_mesh(_mesh(8)):
        got = seq.ring_attention(*args, causal)
    ref = gpt2.full_attention(*ref_in, causal)
    torch.testing.assert_close(got, ref, rtol=3e-4, atol=3e-5)
    got_g = torch.autograd.grad((got * weight).sum(), args)
    ref_g = torch.autograd.grad((ref * weight).sum(), ref_in)
    for g, r in zip(got_g, ref_g):
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("ring,causal", [(4, True), (4, False), (3, True),
                                         (1, True)])
def test_ring_body_calls(monkeypatch, ring, causal):
    """One ``flash_chunk`` call per (position, rotation) that JAX's body
    attends: R causal and R (R - 1) / 2 non-causal calls for a causal
    ring, R^2 non-causal otherwise; the einsum body where the chunk does
    not tile, and not the other way round."""
    calls = collections.Counter()
    real_chunk, real_einsum = fa.flash_chunk, seq._ring_einsum

    def counted_chunk(q, k, v, chunk_causal):
        calls["causal" if chunk_causal else "full"] += 1
        return real_chunk(q, k, v, chunk_causal)

    def counted_einsum(*a, **kw):
        calls["einsum"] += 1
        return real_einsum(*a, **kw)

    monkeypatch.setattr(fa, "flash_chunk", counted_chunk)
    monkeypatch.setattr(seq, "_ring_einsum", counted_einsum)
    q, k, v = _torch(_arrays((1, 2, ring * 64, 16), 13))
    with seq.use_sequence_mesh(_mesh(ring)):
        seq.ring_attention(q, k, v, causal)
        want = ({"causal": ring, "full": ring * (ring - 1) // 2} if causal
                else {"full": ring * ring})
        assert calls == collections.Counter(want)
        calls.clear()
        # Tl = 8 does not tile: the einsum body, once a call.
        small = _torch(_arrays((1, 2, ring * 8, 16), 14))
        seq.ring_attention(*small, causal)
        assert calls == collections.Counter({"einsum": 1})


@pytest.mark.parametrize("nodes,positions", [(4, 1), (4, 8), (4, 16),
                                             (3, 8)])
def test_sequence_mesh_matches_jax(eight_devices, nodes, positions):
    mesh = build_mesh(nodes, "sequence",
                      devices=[torch.device("cpu")] * positions)
    if positions <= len(eight_devices):
        jmesh = jbuild_mesh(nodes, "sequence",
                            devices=eight_devices[:positions])
        want = (tuple(jmesh.axis_names), tuple(jmesh.devices.shape))
    else:
        # JAX's rule, (nodes, positions // nodes), past this machine's 8.
        want = (("data", "seq"), (nodes, positions // nodes))
    assert (mesh.axis_names, mesh.devices.shape) == want
    assert mesh.positions(SEQ_AXIS) == [torch.device("cpu")] * want[1][1]


# --------------------------------------------------------------------------
# The trainer under attack
# --------------------------------------------------------------------------

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=263, n_positions=32,
            seq_len=16)
CONFIG = dict(model_name="gpt2", dataset_name="openwebtext", batch_size=8,
              num_nodes=4, optimizer="adamw", learning_rate=3e-3,
              checkpoint_interval=10_000, parallelism="sequence",
              detector_warmup=4)
ATTACK = dict(attack_types=["gradient_poisoning"], target_nodes=[1],
              intensity=0.5, start_step=8)
EPOCHS = 2


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


def _drive(trainer, plan, loader_fn, gates=None):
    trainer.set_attack_plan(plan)
    dl = loader_fn("openwebtext", batch_size=8, seq_len=16,
                   vocab_size=TINY["vocab_size"], num_examples=64)
    epoch_losses = [trainer.train_epoch(dl, e) for e in range(EPOCHS)]
    hist = trainer.metrics_collector.batch_metrics
    gates = hist if gates is None else gates
    return dict(
        epoch_losses=epoch_losses,
        weights=[[w > 0 for w in g["weights"]] for g in gates],
        attacked=[[bool(a) for a in g["attacked"]] for g in gates],
        loss=[h["loss"] for h in hist],
        trust=[list(h["trust_scores"]) for h in hist],
        incidents=[(r["node_id"], r["step"], r["attack_type"])
                   for r in trainer.attack_history],
        status={i: trainer.trust_manager.get_node_status(i).name
                for i in range(4)})


@pytest.fixture(scope="module", params=["ring", "ulysses"])
def trainers(request, tmp_path_factory):
    impl = request.param
    root = tmp_path_factory.mktemp(f"seq_{impl}")
    jtr = JTrainer(JTrainingConfig(checkpoint_dir=str(root / "j"), **CONFIG),
                   model_overrides=dict(TINY, attn_impl=impl,
                                        dtype=jnp.float32))
    jtr.initialize()
    init = jax.tree_util.tree_map(np.asarray, jtr.state.params)
    jatt = JAttacker(JAttackConfig(**ATTACK))
    jatt.activate_attacks()
    jrun = _drive(jtr, jatt.plan(4), jget_dataloader,
                  gates=_capture_jax_gates(jtr))

    tr = DistributedTrainer(
        TrainingConfig(checkpoint_dir=str(root / "t"), **CONFIG),
        mesh=build_mesh(4, "sequence", devices=["cpu"] * 8),
        model_overrides=dict(TINY, attn_impl=impl, dtype=torch.float32),
        device="cpu")
    tr.initialize(params=convert.params_from_jax(init))
    att = AdversarialAttacker(AttackConfig(**ATTACK))
    att.activate_attacks()
    run = _drive(tr, att.plan(4), get_dataloader)
    return dict(impl=impl, jtr=jtr, tr=tr, jrun=jrun, run=run)


def test_trainer_sequence_mesh_and_model_match_jax(trainers):
    tr, jtr = trainers["tr"], trainers["jtr"]
    assert tr.mesh.axis_names == tuple(jtr.mesh.axis_names) == \
        ("data", "seq")
    assert tr.mesh.devices.shape == jtr.mesh.devices.shape == (4, 2)
    assert tr.model.config.attn_impl == jtr.model.config.attn_impl == \
        trainers["impl"]
    assert seq.get_sequence_mesh() is tr.mesh


def test_trainer_sequence_losses_and_trust_match_jax(trainers):
    run, jrun = trainers["run"], trainers["jrun"]
    assert len(run["loss"]) == len(jrun["loss"]) == 8 * EPOCHS
    np.testing.assert_allclose(run["loss"], jrun["loss"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(run["trust"], jrun["trust"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(run["epoch_losses"], jrun["epoch_losses"],
                               rtol=0, atol=1e-5)
    assert all(math.isfinite(x) for x in run["loss"])


def test_trainer_sequence_detects_the_attack_as_jax(trainers):
    run, jrun, tr = trainers["run"], trainers["jrun"], trainers["tr"]
    assert run["incidents"] == jrun["incidents"]
    assert {i[0] for i in run["incidents"]} == {1}
    assert run["status"] == jrun["status"]
    assert tr.trust_manager.get_node_status(1) == NodeStatus.COMPROMISED
    for node in (0, 2, 3):
        assert tr.trust_manager.get_trust_score(node) > 0.5
    assert tuple(tr.state.trust.scores.shape) == (4,)
    assert run["attacked"] == jrun["attacked"]
    assert run["weights"] == jrun["weights"]
    # Node 1 gated from its first attacked step, nothing before.
    assert [ws[1] for ws in run["weights"]] == \
        [step < ATTACK["start_step"] for step in range(8 * EPOCHS)]


def test_trainer_sequence_defaults_and_refusals(tmp_path):
    """``attn_impl`` defaults to ``"ring"`` in sequence mode (a ring of 1
    without a mesh, JAX's one-device layout); elastic eviction there,
    refused until the group modes of ``elastic/`` were ported, now
    constructs (``tests/test_torch_elastic_modes.py`` evicts)."""
    tr = DistributedTrainer(
        TrainingConfig(checkpoint_dir=str(tmp_path), **CONFIG),
        model_overrides=dict(TINY, dtype=torch.float32), device="cpu")
    assert tr.model.config.attn_impl == "ring"
    assert tr.mesh.devices.shape == (1, 1)
    assert seq.get_sequence_mesh() is tr.mesh
    from trustworthy_dl_tpu_torch.elastic.reassignment import \
        elastic_supported

    elastic = DistributedTrainer(
        TrainingConfig(checkpoint_dir=str(tmp_path),
                       elastic_resharding=True, **CONFIG),
        model_overrides=dict(TINY, dtype=torch.float32), device="cpu")
    assert elastic_supported(elastic.config)
    seq.set_sequence_mesh(None)


@pytest.mark.parametrize("parallelism,mesh,match", [
    ("sequence", lambda: build_mesh(4, "sequence", devices=["cuda"] * 8),
     "mesh position on cuda"),
    ("sequence", lambda: build_mesh(4, "data"), "'seq' axis"),
    ("model", lambda: build_mesh(2, "model", devices=["cuda"]),
     "mesh position on cuda"),
], ids=["sequence-on-another-device", "sequence-without-seq",
        "model-on-another-device"])
def test_trainer_refuses_a_foreign_mesh(tmp_path, parallelism, mesh, match):
    """A given mesh is refused at construction where it would quietly
    change what runs: positions off the trainer's device (attention or a
    stage would leave it), or a sequence-mode mesh without a ``seq`` axis
    (full attention instead of the ring)."""
    config = dict(CONFIG, parallelism=parallelism)
    with pytest.raises(ValueError, match=match):
        DistributedTrainer(
            TrainingConfig(checkpoint_dir=str(tmp_path), **config),
            mesh=mesh(), model_overrides=dict(TINY, dtype=torch.float32),
            device="cpu")
    seq.set_sequence_mesh(None)
