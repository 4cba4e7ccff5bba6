"""The public names the port added to match the JAX package, held to JAX's
own cases on the same numpy inputs from a seed (CPU, f32).

* ``detect.verifier``: ``verify_gradients_array`` and ``GradientVerifier``
  (``tests/test_detector.py``'s verifier cases), verdicts bitwise, the
  Welford state within rtol 1e-6; the trainer holds one.
* ``detect.detector.push_then_detect`` (``tests/test_detector.py``'s
  outlier and warm-up cases): verdicts bitwise, scores within rtol 1e-5;
  ``BaselineState.num_nodes`` / ``.window``.
* ``trust.state.select_best_nodes`` (``tests/test_trust.py``'s case, then
  ties and k past the assignable count): indices bitwise.
* ``trust.manager``: the ``TrustScore`` / ``NodeMetrics`` records and the
  six methods, on one sequence of calls with the wall clock injected:
  records, recommendations and the exported JSON equal.
* ``serve.kv_slots.paged_pool_blocks`` and ``PagedKV.bytes_per_block``
  (``tests/test_paged_kv.py``'s sizing case), bf16 and int8: exact.
* ``ServingEngine.attn_kernel_path`` (``tests/test_paged_attention.py``'s
  contract): the port's "kernel" where JAX's engine says "pallas" or
  "interpret", "plain" where it says "jnp".
* ``NodeConfig.gpu_id``, ``models.gpt2.num_params``,
  ``engine.state.fleet_scalar_fields``, ``cli.build_parser`` (JAX's
  ``test_cli_parser_accepts_supervisor_and_chaos_flags``),
  ``elastic.reassignment.row_placer``,
  ``serve.adapters.adapter_partition_specs`` and the ``models.layers``
  initialisers.
"""

import dataclasses
import json
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu.core.config import NodeConfig as JNodeConfig
from trustworthy_dl_tpu.detect import baseline as jbl
from trustworthy_dl_tpu.detect import detector as jdet
from trustworthy_dl_tpu.detect import verifier as jver
from trustworthy_dl_tpu.detect.stats import NUM_GRADIENT_STATS
from trustworthy_dl_tpu.engine import state as jstate
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models import layers as jlayers
from trustworthy_dl_tpu.serve import adapters as jadapters
from trustworthy_dl_tpu.serve import kv_slots as jkv
from trustworthy_dl_tpu.trust import manager as jmanager
from trustworthy_dl_tpu.trust import state as jts
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.core.config import NodeConfig
from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.detect import detector as det
from trustworthy_dl_tpu_torch.detect import verifier as ver
from trustworthy_dl_tpu_torch.engine import state as tstate
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.models import layers
from trustworthy_dl_tpu_torch.serve import adapters
from trustworthy_dl_tpu_torch.serve import kv_slots as kv
from trustworthy_dl_tpu_torch.trust import manager
from trustworthy_dl_tpu_torch.trust import state as ts

pytestmark = pytest.mark.torchport

T = torch.from_numpy


def _assert_verifier_state(port, jax_state):
    """count exact; mean and m2 within rtol 1e-6 or 1e-9 absolute: XLA's
    and torch's f32 ``log`` differ by an ulp on about a quarter of inputs
    (an ulp of a log-norm near 0.02 is ~2e-9), and a mean of log-norms of
    norms near 1 is a sum of terms that cancel to near 0."""
    np.testing.assert_array_equal(port.count.numpy(),
                                  np.asarray(jax_state.count))
    for name in ("mean", "m2"):
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   np.asarray(getattr(jax_state, name)),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# detect.verifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_verify_gradients_array_matches_jax(masked):
    """tests/test_detector.py:168: 20 clean steps, then a 1000x inflated
    norm on node 1 and a non-finite node 2; with ``masked`` node 3 sits
    out every step (its baseline never moves and it is never valid)."""
    n = 4
    rng = np.random.default_rng(6)
    mask = np.array([True, True, True, not masked])
    pstate, jstate_ = ver.init_verifier_state(n), jver.init_verifier_state(n)
    steps = [(rng.normal(1.0, 0.02, size=n).astype(np.float32),
              np.ones(n, bool)) for _ in range(20)]
    steps.append((np.array([1.0, 1000.0, 1.0, 1.0], np.float32),
                  np.array([True, True, False, True])))
    for norms, finite in steps:
        jmask = jnp.asarray(mask) if masked else None
        pmask = T(mask) if masked else None
        jstate_, jvalid, jsus = jver.verify_gradients_array(
            jstate_, jnp.asarray(norms), jnp.asarray(finite),
            update_mask=jmask)
        pstate, pvalid, psus = ver.verify_gradients_array(
            pstate, T(norms), T(finite), update_mask=pmask)
        np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(psus.numpy(), np.asarray(jsus))
        _assert_verifier_state(pstate, jstate_)
    assert pvalid.tolist() == [True, False, False, not masked]
    assert bool(psus[1]) and not bool(psus[0])


def test_gradient_verifier_matches_jax_on_arrays_and_tensors():
    """tests/test_detector.py:207: a clean history, then a 1e6 gradient
    and a NaN gradient are refused; the port is given torch tensors where
    JAX is given the same numpy arrays, and ``reset_node`` starts the
    node's warm-up over in both."""
    rng = np.random.default_rng(8)
    jv, pv = jver.GradientVerifier(), ver.GradientVerifier()
    grads = [[rng.normal(0, 0.1, size=(8,)).astype(np.float32),
              rng.normal(0, 0.1, size=(2, 3)).astype(np.float32)]
             for _ in range(15)]
    grads += [[np.full((8,), 1e6, np.float32)],
              [np.full((8,), np.nan, np.float32)]]
    verdicts = []
    for step, g in enumerate(grads):
        want = jv.verify_gradients(g, node_id=3, step=step)
        got = pv.verify_gradients([T(a) for a in g], node_id=3, step=step)
        assert got == want
        verdicts.append(got)
        _assert_verifier_state(pv._state, jv._state)
    assert verdicts == [True] * 15 + [False, False]
    assert not pv.verify_gradients([], node_id=0, step=0)
    jv.reset_node(3)
    pv.reset_node(3)
    _assert_verifier_state(pv._state, jv._state)
    assert int(pv._state.count[3]) == 0
    huge = [np.full((8,), 1e6, np.float32)]
    assert pv.verify_gradients(huge, 3, 99) == jv.verify_gradients(huge, 3,
                                                                   99)


def test_trainer_holds_a_gradient_verifier():
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    tr = DistributedTrainer(
        TrainingConfig(model_name="gpt2", batch_size=4, num_nodes=2),
        model_overrides=dict(n_layer=1, n_embd=16, n_head=2, vocab_size=64,
                             n_positions=16, seq_len=8), device="cpu")
    assert isinstance(tr.gradient_verifier, ver.GradientVerifier)
    assert tr.gradient_verifier._state.count.device.type == "cpu"


# ---------------------------------------------------------------------------
# detect.detector.push_then_detect, BaselineState
# ---------------------------------------------------------------------------


def _push_both(pstate, jstate_, stats, mask=None):
    jstate_, jv = jdet.push_then_detect(
        jstate_, jnp.asarray(stats),
        None if mask is None else jnp.asarray(mask))
    pstate, pv = det.push_then_detect(pstate, T(stats),
                                      None if mask is None else T(mask))
    np.testing.assert_array_equal(pv.is_attack.numpy(),
                                  np.asarray(jv.is_attack))
    np.testing.assert_allclose(pv.score.numpy(), np.asarray(jv.score),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pstate.count.numpy(),
                                  np.asarray(jstate_.count))
    return pstate, jstate_, pv


def _baselines(n, window=100):
    return (bl.init_baseline_state(n, window, NUM_GRADIENT_STATS,
                                   device="cpu"),
            jbl.init_baseline_state(n, window=window))


def test_push_then_detect_fires_on_the_outlier_as_jax():
    """tests/test_detector.py:84: 20 benign steps, then node 2 shifted by
    10; a masked step keeps node 0 out of both the push and the verdict."""
    n = 4
    pstate, jstate_ = _baselines(n)
    assert (pstate.num_nodes, pstate.window) == (jstate_.num_nodes,
                                                 jstate_.window) == (4, 100)
    rng = np.random.default_rng(3)
    for _ in range(20):
        stats = rng.normal(1.0, 0.1, (n, NUM_GRADIENT_STATS)).astype(
            np.float32)
        pstate, jstate_, v = _push_both(pstate, jstate_, stats)
    assert not bool(v.is_attack.any())
    attacked = rng.normal(1.0, 0.1, (n, NUM_GRADIENT_STATS)).astype(
        np.float32)
    attacked[2] += 10.0
    attacked[0] += 10.0
    mask = np.array([False, True, True, True])
    pstate, jstate_, v = _push_both(pstate, jstate_, attacked, mask)
    assert v.is_attack.tolist() == [False, False, True, False]
    assert float(v.confidence[2]) > 0.8


def test_push_then_detect_warmup_suppresses_as_jax():
    """tests/test_detector.py:105: a blatant outlier inside the 10-step
    warm-up is never an attack."""
    n = 2
    pstate, jstate_ = _baselines(n)
    rng = np.random.default_rng(4)
    for _ in range(9):
        stats = rng.normal(size=(n, NUM_GRADIENT_STATS)).astype(np.float32)
        stats[1] += 100.0
        pstate, jstate_, v = _push_both(pstate, jstate_, stats)
        assert not bool(v.is_attack.any())


# ---------------------------------------------------------------------------
# trust.state.select_best_nodes
# ---------------------------------------------------------------------------


def _trust_pair(scores, compromised):
    jstate_ = jts.init_trust_state(len(scores))._replace(
        scores=jnp.asarray(scores))
    jstate_ = jts.mark_compromised(jstate_, jnp.asarray(compromised))
    pstate = ts.init_trust_state(len(scores))._replace(scores=T(scores))
    pstate = ts.mark_compromised(pstate, T(compromised))
    return pstate, jstate_


def test_select_best_nodes_matches_jax():
    """tests/test_trust.py:131: node 3 (the best) compromised."""
    pstate, jstate_ = _trust_pair(
        np.array([0.9, 0.95, 0.8, 0.99], np.float32),
        np.array([False, False, False, True]))
    got = ts.select_best_nodes(pstate, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jts.select_best_nodes(jstate_,
                                                                   2)))
    assert got.tolist() == [1, 0]


@pytest.mark.parametrize("seed", range(4))
def test_select_best_nodes_ties_and_padding_match_jax(seed):
    """Scores from a set of four values (many ties, broken toward the
    lower index) and a third of the nodes compromised, for every k from 0
    to n: more than the assignable count pads with -1."""
    n = 12
    rng = np.random.default_rng(seed)
    scores = rng.choice(np.array([0.5, 0.75, 0.9, 1.0], np.float32), n)
    compromised = rng.random(n) < 0.34
    pstate, jstate_ = _trust_pair(scores, compromised)
    for k in range(n + 1):
        got = ts.select_best_nodes(pstate, k).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jts.select_best_nodes(jstate_, k)))
    assert (got == -1).sum() == compromised.sum()


# ---------------------------------------------------------------------------
# trust.manager
# ---------------------------------------------------------------------------


def _drive_managers(monkeypatch, tmp_path):
    """One sequence of calls on both managers, the wall clock injected and
    stepped between calls."""
    clock = [1.7e9]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    pair = (jmanager.TrustManager(num_nodes=4),
            manager.TrustManager(num_nodes=4))
    calls = [
        ("update_trust_score", (0, 0.1, 0.9), {"error_rate": 0.2}),
        ("update_trust_score", (1, 0.4, 0.5), {"uptime": 0.8}),
        ("mark_compromised", (2, "gradient_poisoning"), {}),
        ("update_trust_score", (3, 0.9, 0.1), {}),
        ("update_trust_score", (3, 0.9, 0.1), {}),
        ("initialize_node", (1,), {}),
        ("initiate_recovery", (2,), {}),
        ("update_trust_score", (5, 0.2, 0.8), {}),   # grows to 6 nodes
        ("reset_node_trust", (0,), {}),
        ("initialize_node", (7,), {}),               # grows to 8 nodes
    ] + [("mark_compromised", (i % 3 + 4, "byzantine"), {})
         for i in range(10)]
    records = ([], [])
    for name, args, kwargs in calls:
        clock[0] += 2.5
        for rec, tm in zip(records, pair):
            getattr(tm, name)(*args, **kwargs)
            rec.append((
                [tm.get_score_record(i) for i in range(tm.num_nodes + 1)],
                [tm._snapshot_metrics(i) for i in range(tm.num_nodes)],
                [tm.select_best_nodes(k) for k in (1, 3, 20)],
                tm.get_recommendations()))
    paths = []
    for tag, tm in zip(("jax", "port"), pair):
        paths.append(tmp_path / f"{tag}.json")
        tm.export_trust_data(str(paths[-1]))
    return pair, records, paths


def test_trust_manager_records_and_export_match_jax(monkeypatch, tmp_path):
    (jtm, ptm), (jrec, prec), (jpath, ppath) = _drive_managers(monkeypatch,
                                                               tmp_path)
    assert ptm.num_nodes == jtm.num_nodes == 8
    for (jscores, jmetrics, jbest, jhints), (pscores, pmetrics, pbest,
                                             phints) in zip(jrec, prec):
        assert [None if r is None else dataclasses.asdict(r)
                for r in pscores] == [None if r is None
                                      else dataclasses.asdict(r)
                                      for r in jscores]
        assert [dataclasses.asdict(m) for m in pmetrics] == \
            [dataclasses.asdict(m) for m in jmetrics]
        assert pbest == jbest
        assert phints == jhints
    assert type(prec[-1][0][0]).__name__ == "TrustScore"
    # Compromised nodes, mean trust below 0.6, >30% compromised, a long
    # attack log.
    assert len(prec[-1][3]) == 4
    assert ppath.read_text() == jpath.read_text()
    data = json.loads(ppath.read_text())
    assert data["node_status"]["2"] == "recovering"
    assert data["node_status"]["4"] == "compromised"


# ---------------------------------------------------------------------------
# serve.kv_slots, serve.engine
# ---------------------------------------------------------------------------

SIZES = dict(vocab_size=64, n_positions=64, n_layer=2, n_embd=32, n_head=4)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_paged_pool_sizing_matches_jax(dtype):
    """tests/test_paged_kv.py:362: a budget of exactly N blocks' bytes
    buys N - 1 usable blocks (the trash block is counted); the int8 pool
    counts its f32 scales."""
    jcfg = jgpt2.GPT2Config(**SIZES, dtype=jnp.bfloat16)
    pcfg = gpt2.GPT2Config(**SIZES, dtype=torch.bfloat16)
    jkd = jnp.int8 if dtype == "int8" else None
    pkd = torch.int8 if dtype == "int8" else None
    bpt = kv.kv_bytes_per_token(pcfg, pkd)
    assert bpt == jkv.kv_bytes_per_token(jcfg, jkd)
    for block in (1, 8, 16):
        for budget in (0, block * bpt, 6 * block * bpt, 6 * block * bpt - 1,
                       1 << 20, 3 << 30):
            want = jkv.paged_pool_blocks(jcfg, budget, block, jkd)
            assert kv.paged_pool_blocks(pcfg, budget, block, pkd) == want
    assert kv.paged_pool_blocks(pcfg, 6 * 16 * bpt, 16, pkd) == 5
    with pytest.raises(ValueError):
        kv.paged_pool_blocks(pcfg, 1 << 20, 0, pkd)
    jpool = jkv.init_paged_pool(jcfg, 5, 16, kv_dtype=jkd)
    ppool = kv.init_paged_pool(pcfg, 5, 16, kv_dtype=pkd)
    assert ppool.pool_bytes == jpool.pool_bytes == 6 * 16 * bpt
    assert ppool.bytes_per_block == jpool.bytes_per_block == 16 * bpt
    assert ppool.bytes_per_block * (ppool.num_blocks + 1) == ppool.pool_bytes
    assert kv.paged_pool_blocks(pcfg, ppool.pool_bytes, 16, pkd) == 5


#: The port's path for each of JAX's: JAX's Pallas kernel, compiled or
#: interpreted, is the port's kernel path (the kernels on the card, their
#: plain twins on CPU tensors); JAX's jnp path is the port's plain path.
PORT_PATH = {"pallas": "kernel", "interpret": "kernel", "jnp": "plain"}


@pytest.mark.parametrize("jax_impl", ["interpret", "jnp"])
def test_attn_kernel_path_contract_matches_jax(jax_impl):
    """tests/test_paged_attention.py:395: an engine built for JAX's path
    serves on the port's counterpart; the decode path equals the paths'
    decode entry and the summary's key, and the gauge marks it.  The
    stripe pool is always the plain path (JAX: jnp)."""
    from trustworthy_dl_tpu.serve import engine as jeng
    from trustworthy_dl_tpu_torch.models import convert
    from trustworthy_dl_tpu_torch.models.generate import ATTN_IMPLS
    from trustworthy_dl_tpu_torch.obs.session import ObsSession
    from trustworthy_dl_tpu_torch.serve.engine import PAGED_PROGRAMS, \
        ServeRequest, ServingEngine

    jcfg = jgpt2.GPT2Config(**SIZES, dtype=jnp.float32)
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), jcfg)
    jengine = jeng.ServingEngine(jparams, jcfg, max_slots=2, max_seq=32,
                                 block_size=8, attn_impl=jax_impl)
    path = PORT_PATH[jengine.attn_kernel_path]
    pcfg = gpt2.GPT2Config(**SIZES, dtype=torch.float32)
    params = convert.params_from_jax(jparams)
    obs = ObsSession(None)
    engine = ServingEngine(params, pcfg, max_slots=2, max_seq=32,
                           block_size=8, attn_impl=path, obs=obs,
                           device="cpu")
    engine.submit(ServeRequest(prompt=[3, 1, 4], max_new_tokens=3))
    engine.run_until_idle()
    assert engine.attn_kernel_path == engine.attn_kernel_paths["decode"] \
        == path
    summary = engine.metrics_summary()
    assert summary["attn_kernel_path"] == path
    assert summary["attn_kernel_paths"] == engine.attn_kernel_paths
    gauge = obs.registry.get("tddl_serve_attn_kernel")
    for program in PAGED_PROGRAMS:
        for name in ATTN_IMPLS:
            assert gauge.value(path=name, program=program) == (
                1.0 if name == path else 0.0)
    stripe = ServingEngine(params, pcfg, max_slots=2, max_seq=32,
                           paged=False, obs=ObsSession(None), device="cpu")
    jstripe = jeng.ServingEngine(jparams, jcfg, max_slots=2, max_seq=32,
                                 paged=False)
    assert stripe.attn_kernel_path == PORT_PATH[jstripe.attn_kernel_path] \
        == "plain"
    assert stripe.metrics_summary()["attn_kernel_path"] == "plain"


# ---------------------------------------------------------------------------
# The rest: config, models, engine state, cli, elastic, adapters
# ---------------------------------------------------------------------------


def test_node_config_matches_jax():
    kw = dict(node_id=1, rank=1, world_size=4, device_id=3,
              model_partition="shard_1")
    jnode, pnode = JNodeConfig(**kw), NodeConfig(**kw)
    assert pnode.gpu_id == jnode.gpu_id == 3
    assert dataclasses.asdict(pnode) == dataclasses.asdict(jnode)


def test_num_params_matches_jax():
    from trustworthy_dl_tpu_torch.models.factory import create_model

    jcfg = jgpt2.GPT2Config(**SIZES)
    pcfg = gpt2.GPT2Config(**SIZES)
    params = gpt2.init_params(pcfg, torch.Generator().manual_seed(0))
    want = jgpt2.num_params(jgpt2.init_params(jax.random.PRNGKey(0), jcfg))
    assert gpt2.num_params(params) == want
    bundle = create_model("gpt2", **SIZES)
    assert bundle.num_params(params) == want


@pytest.mark.parametrize("with_fleet", [True, False])
def test_fleet_scalar_fields_match_jax(with_fleet):
    norm = ts.init_trust_state(1) if with_fleet else None
    fields = dict(fleet_norm=norm, fleet_raw_streak=torch.zeros(1))
    ours = tstate.fleet_scalar_fields(types.SimpleNamespace(**fields))
    theirs = jstate.fleet_scalar_fields(types.SimpleNamespace(**fields))
    assert list(ours) == list(theirs)
    assert all(ours[k] is fields[k] for k in ours)


def test_build_parser_accepts_supervisor_and_chaos_flags_as_jax():
    """tests/test_chaos.py:283, on the port's ``cli train`` parser."""
    argv = ["--supervise", "--chaos-seed", "5", "--chaos-rate", "0.1",
            "--max-retries", "1", "--rollback-after", "2",
            "--max-restarts", "4"]
    for parser in (cli.build_parser(), jcli.build_parser()):
        args = parser.parse_args(argv)
        assert args.supervise and args.chaos_seed == 5
        assert (args.max_retries, args.rollback_after, args.max_restarts,
                args.chaos_rate) == (1, 2, 4, 0.1)
        defaults = parser.parse_args([])
        assert not defaults.supervise and defaults.chaos_seed is None
    assert cli.build_parser().prog == cli.build_train_parser().prog


def test_row_placer_at_the_elastic_path():
    from trustworthy_dl_tpu_torch.core import sharding
    from trustworthy_dl_tpu_torch.core.mesh import DATA_AXIS, build_mesh
    from trustworthy_dl_tpu_torch.elastic.reassignment import row_placer

    assert row_placer is sharding.row_placer
    rows = torch.arange(4.0)
    placed = row_placer(build_mesh(4, "data", device="cpu"), DATA_AXIS,
                        4)(rows)
    assert placed.device == rows.device and torch.equal(placed, rows)


def test_adapter_partition_specs_match_jax():
    ours, theirs = (adapters.adapter_partition_specs(),
                    jadapters.adapter_partition_specs())
    assert len(ours) == len(theirs) == 2
    assert [tuple(s) for s in ours] == [tuple(s) for s in theirs] == [(), ()]


def test_layer_initialisers_match_jax():
    np.testing.assert_array_equal(
        layers.layernorm_init(24)["scale"].numpy(),
        np.asarray(jlayers.layernorm_init(24)["scale"]))
    np.testing.assert_array_equal(
        layers.layernorm_init(24)["bias"].numpy(),
        np.asarray(jlayers.layernorm_init(24)["bias"]))
    key = jax.random.PRNGKey(0)
    for ours, theirs, std in (
            (layers.uniform_scaling_init(torch.Generator().manual_seed(0),
                                         (256, 128), 0.5),
             jlayers.uniform_scaling_init(key, (256, 128), 0.5), 0.5),
            (layers.embedding_init(torch.Generator().manual_seed(0), 512,
                                   64),
             jlayers.embedding_init(key, 512, 64), 0.02)):
        theirs = np.asarray(theirs)
        assert tuple(ours.shape) == theirs.shape
        assert ours.dtype == torch.float32 and theirs.dtype == np.float32
        assert float(ours.std()) == pytest.approx(std, rel=0.02)
        assert float(theirs.std()) == pytest.approx(std, rel=0.02)
    again = layers.embedding_init(torch.Generator().manual_seed(0), 512, 64)
    assert torch.equal(again, layers.embedding_init(
        torch.Generator().manual_seed(0), 512, 64))
