"""Tensor-parallel serving replicas on one device, against the JAX package
on the CPU (f32): ``core.sharding.serve_tp_mesh`` / ``place_serve_tp``,
the engine's ``tp_size``, the HBM headroom gate's per-device bytes, and
the fleet's scale-up to a doubled TP group.

* ``serve_tp_mesh``'s contract is JAX's (``tests/test_sharding.py``'s
  ``test_serve_tp_mesh_contract``, on JAX's 8 devices and 8 CPU positions),
  and without devices every position is the engine's device (JAX takes
  the first local devices: a deliberate difference);
* a TP-2 engine's param specs equal JAX's ``mesh_spec_tree(place_serve_tp(
  params, serve_tp_mesh(2, devices)))`` leaf for leaf;
* JAX's ``test_fleet_tp_scale_up_arrives_with_wider_shards`` runs on both
  fleets with their fake engines: one scale-up, one ``tp_scale_ups``, the
  third replica at TP 2, ``chips_in_service`` 2 -> 4, equal scale events;
* the substance of JAX's slow ``test_serve_tp_streams_bit_identical_with_
  compile_once`` at its sizes (vocab 149, 2 layers, width 32, 5 seeded
  requests): the port's TP-1 and TP-2 greedy streams are bit-identical to
  each other and to JAX's single-device ``generate()``.  The port has no
  compile cache, so both arms are held to calling the same kernels (their
  plain twins here) the same number of times instead;
* the headroom gate divides KV bytes a token by the distinct devices of
  the TP group: JAX's ``bytes // tp`` over two cards, the whole pool where
  the positions share one, so both widths on one device admit the same
  blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from trustworthy_dl_tpu.core import sharding as jshreg
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models.generate import generate as jgenerate
from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.core.config import ServeConfig
from trustworthy_dl_tpu_torch.core.mesh import MODEL_AXIS, Mesh
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
from trustworthy_dl_tpu_torch.serve import engine as tengine
from trustworthy_dl_tpu_torch.serve.fleet import ReplicaObs
from trustworthy_dl_tpu_torch.serve.kv_slots import kv_bytes_per_token
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves
from test_torch_fleet import SIDES, Api, FakeEngine, RecordingTrace

pytestmark = pytest.mark.torchport

# JAX's slow test's geometry (vocab 149 there too).
JCFG = jgpt2.GPT2Config(vocab_size=149, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=149, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=3, max_seq=48, queue_limit=16, device="cpu")
PLAIN_TWINS = ("paged_attention_plain", "paged_prefill_attention_plain",
               "logit_trust_stats_plain")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _requests():
    rng = np.random.default_rng(7)
    reqs = []
    for _ in range(5):
        plen = int(rng.integers(3, 10))
        new = int(rng.integers(2, 8))
        reqs.append((rng.integers(0, CFG.vocab_size, plen).tolist(), new))
    return reqs


def test_serve_tp_mesh_contract_matches_jax(eight_devices):
    mesh = shreg.serve_tp_mesh(4, ["cpu"] * 8)
    jmesh = jshreg.serve_tp_mesh(4, eight_devices)
    assert mesh.axis_names == tuple(jmesh.axis_names) == (MODEL_AXIS,)
    assert mesh.devices.shape == jmesh.devices.shape == (4,)
    for build, devs in ((shreg.serve_tp_mesh, ["cpu"] * 8),
                        (jshreg.serve_tp_mesh, eight_devices)):
        with pytest.raises(ValueError, match=">= 1"):
            build(0)
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            build(16, devs)
    # Without devices every position is the given device: a group's
    # positions share the engine's card.
    shared = shreg.serve_tp_mesh(4, device="cpu")
    assert list(shared.devices) == [torch.device("cpu")] * 4
    assert shreg.distinct_devices(shared) == 1


def test_tp2_engine_specs_equal_jax_mesh_spec_tree(params, eight_devices):
    jparams, tparams = params
    jspecs = jshreg.mesh_spec_tree(jshreg.place_serve_tp(
        jparams, jshreg.serve_tp_mesh(2, eight_devices)))
    want = [None if s is None else tuple(s) for s in jax.tree_util.
            tree_leaves(jspecs, is_leaf=lambda x: x is None
                        or isinstance(x, P))]
    engine = ServingEngine(tparams, CFG, tp_size=2, **ENGINE)
    assert engine.tp_mesh.shape == {MODEL_AXIS: 2}
    assert tree_leaves(engine.tp_specs) == want
    assert any(want)                    # the TP layout, not replication
    placed, specs = shreg.place_serve_tp(
        tparams, shreg.serve_tp_mesh(2, device="cpu"))
    assert shreg.mesh_spec_tree(placed, specs) == engine.tp_specs
    # A one-position engine carries no TP layout, as JAX's.
    assert ServingEngine(tparams, CFG, **ENGINE).tp_mesh is None
    # Positions on another device than the engine's are refused.
    with pytest.raises(ValueError, match="must be its device"):
        ServingEngine(tparams, CFG, tp_size=2, tp_devices=["cpu", "meta"],
                      **ENGINE)


def test_fleet_tp_scale_up_arrives_with_wider_shards_as_jax():
    """JAX's scenario on both fleets: occupancy pressure with an empty
    queue scales UP (the new replica at a doubled width), counted in
    ``chips_in_service`` and in ``tp_scale_ups``; the scale events are
    equal."""
    views = []
    for side in SIDES:
        api = Api(side)
        serve = __import__("trustworthy_dl_tpu_torch.serve" if api.port
                           else "trustworthy_dl_tpu.serve",
                           fromlist=["AutoscalerConfig"])
        fakes = {}

        def factory(index, _api=api, **kwargs):
            fakes[index] = FakeEngine(index, _api, **kwargs)
            fakes[index].scheduler = type(  # compute-bound, empty queue
                "S", (), {"occupancy": 1.0, "max_seq": 64, "buckets": (64,),
                          "tokens_in_flight": 0})()
            return fakes[index]

        extra = dict(device="cpu") if api.port else {}
        trace = RecordingTrace()
        fleet = api.ServingFleet(
            fleet_config=api.FleetConfig(
                num_replicas=2, tp_size=1, tp_max=4,
                autoscale=serve.AutoscalerConfig(
                    min_replicas=2, max_replicas=4,
                    scale_up_queue_per_replica=4.0,
                    scale_down_queue_per_replica=-1.0,
                    scale_up_occupancy=0.9, scale_down_occupancy=-1.0,
                    scale_up_cooldown_ticks=1, scale_down_cooldown_ticks=1,
                    scale_down_idle_ticks=10 ** 6)),
            engine_factory=factory, registry=api.MetricsRegistry(),
            trace=trace, **extra)
        chips = [fleet.chips_in_service()]
        fleet.step()
        chips.append(fleet.chips_in_service())
        assert fleet.counters["scale_ups"] == 1
        assert fleet.counters["tp_scale_ups"] == 1
        assert len(fleet.replicas) == 3
        assert fleet.replicas[2].tp == 2 and fakes[2].tp_size == 2
        assert chips == [2, 4]
        # Sticky across a rebuild (a crash restart keeps the width).
        rep = fleet.replicas[2]
        fleet._build_replica(2, prev=rep)
        assert rep.tp == 2 and fakes[2].tp_size == 2
        events = [{k: v for k, v in e.items() if k != "t"}
                  for e in trace.of("fleet_scale")]
        assert len(events) == 1
        views.append((dict(fleet.counters), events, chips,
                      fleet.replica_trace))
    assert views[0] == views[1]


def _serve(tparams, tp, calls):
    engine = ServingEngine(tparams, CFG, tp_size=tp, **ENGINE)
    rids = [engine.submit(ServeRequest(prompt=p, max_new_tokens=n))
            for p, n in _requests()]
    calls.clear()
    results = engine.run_until_idle()
    summary = engine.metrics_summary()
    return ([results[r].tokens for r in rids], dict(calls),
            {k: summary[k] for k in ("decode_ticks", "prefill_chunks",
                                     "local_prefills")})


def test_tp2_streams_bit_identical_to_tp1_and_jax_generate(params,
                                                          monkeypatch):
    jparams, tparams = params
    calls = {}
    for name in PLAIN_TWINS:
        twin = getattr(pattn, name)

        def counted(*a, _twin=twin, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _twin(*a, **kw)

        monkeypatch.setattr(pattn, name, counted)
    one = _serve(tparams, 1, calls)
    two = _serve(tparams, 2, calls)
    assert one == two
    assert one[1]["paged_attention_plain"] == \
        CFG.n_layer * one[2]["decode_ticks"]
    assert one[1]["logit_trust_stats_plain"] >= one[2]["decode_ticks"]
    for tokens, (prompt, new) in zip(one[0], _requests()):
        ref = np.asarray(jgenerate(
            jparams, JCFG, jnp.asarray([prompt], jnp.int32), new,
            temperature=0.0))[0, len(prompt):].tolist()
        assert tokens == ref


class _DenyingHBM:
    """A headroom monitor that denies every request and reports
    ``headroom`` bytes free."""

    def __init__(self, headroom):
        self.last_headroom = headroom
        self.asked = []

    def admit(self, requested, what=""):
        self.asked.append((what, requested))
        return False


def test_hbm_gate_divides_by_distinct_devices(params):
    bpt = kv_bytes_per_token(CFG)
    two_cards = Mesh(np.array([torch.device("cuda:0"),
                               torch.device("cuda:1")], dtype=object),
                     (MODEL_AXIS,))
    one_card = Mesh(np.array([torch.device("cuda:0"),
                              torch.device("cuda", 0)], dtype=object),
                    (MODEL_AXIS,))
    assert shreg.distinct_devices(two_cards) == 2
    assert shreg.distinct_devices(one_card) == 1
    # Two cards: JAX's max(bpt // tp, 1); one card: the whole pool.
    assert tengine.per_device_kv_bytes(bpt, two_cards) == max(bpt // 2, 1)
    assert tengine.per_device_kv_bytes(bpt, one_card) == bpt
    assert tengine.per_device_kv_bytes(bpt, None) == bpt
    assert tengine.per_device_kv_bytes(1, two_cards) == 1
    # Both widths on one device ask for, and are shrunk to, the same pool.
    _, tparams = params
    blocks = {}
    for tp in (1, 2):
        hbm = _DenyingHBM(headroom=10 * 16 * bpt)
        engine = ServingEngine(tparams, CFG, tp_size=tp,
                               obs=ReplicaObs(hbm=hbm), **ENGINE)
        blocks[tp] = (engine.scheduler.num_blocks, hbm.asked)
    assert blocks[1] == blocks[2]
    assert blocks[1][0] == 10


def test_serve_config_tp_size_reaches_the_engine(params):
    _, tparams = params
    config = ServeConfig(max_slots=3, max_seq=48, queue_limit=16,
                         tp_size=2)
    engine = ServingEngine.from_config(tparams, CFG, config, device="cpu")
    assert engine.tp_size == 2 and engine.tp_mesh.shape == {MODEL_AXIS: 2}


@pytest.mark.parametrize("knobs", [
    dict(weight_dtype="int8"), dict(spec_k=2),
    dict(kv_dtype="int8", kv_parity_check=False),
    dict(adapter_rank=2, adapter_map={"t": "ad-0"})],
    ids=["int8_weights", "spec_k", "int8_kv", "adapters"])
def test_tp2_engine_serves_every_tier_as_tp1(params, knobs):
    """The TP placement comes first, as in JAX (before the pool, the
    quant view, the draft and the adapter pool are built), so a TP-2
    engine serves each tier as the TP-1 engine does."""
    _, tparams = params
    streams = {}
    for tp in (1, 2):
        engine = ServingEngine(tparams, CFG, tp_size=tp, **ENGINE, **knobs)
        tenant = "t" if "adapter_map" in knobs else None
        rids = [engine.submit(ServeRequest(prompt=p, max_new_tokens=n,
                                           tenant=tenant))
                for p, n in _requests()]
        results = engine.run_until_idle()
        streams[tp] = [results[r].tokens for r in rids]
        assert (engine.tp_specs is not None) == (tp > 1)
    assert streams[1] == streams[2]
    assert all(streams[1])
