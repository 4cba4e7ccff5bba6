"""The port's legacy stripe pool (``ServeConfig(paged=False)``) against the
JAX package's stripe engine, and against the port's own paged engine and
``generate()``, on the CPU in f32.

Tiny GPT-2 (2 layers, 32 wide, 4 heads, vocab 277: a size no other test
file uses, so this file's JAX programs are its own), weights made on the
JAX side and converted with ``models/convert.params_from_jax``.

* Greedy streams of the port's stripe engine equal JAX's stripe engine's
  and ``generate()``'s; every token's entropy and margin within 1e-4 of
  JAX's (PR 1's contract), with JAX's margins checked above 1e-3 first.
* Stripe, paged and ``generate()`` streams agree: greedy all three, and
  sampled the stripe and paged engines with the same seeds (mirrors JAX's
  ``tests/test_paged_kv.py:569`` and ``tests/test_spec_decode.py:293``).
* The int8 KV stripe pool's values are bit-equal to JAX's after the same
  traffic and its scales within 1e-6 relative (the f32 rows going into
  the quantizer differ by an f32 step); on the same rows the slot write's
  values and scales are bit-equal to JAX's ``quantize_kv``.  The
  int8-weight stripe stream equals JAX's; a failed int8 parity probe
  shrinks the stripe pool by slots, as in JAX.
* ``ServeConfig(paged=False)`` warns for each paged knob set away from its
  default and not for the defaults; ``spec_k`` and ``adapter_rank`` > 0
  are refused on it with JAX's messages; an admission that cannot bucket
  leaks no slot.
* The stripe engine's surface: layout ``stripe`` in the summary and the
  attribution records, 0 blocks, the kernel gauge on ``plain``, the HBM
  gate's ``serve_stripe_pool`` shrink equal to JAX's, and the cost ledger's
  ``serve.prefill`` / ``serve.decode`` equal to what ``count_flops``
  counts over one run of each program.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.core.config import ServeConfig as JServeConfig
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.obs import ObsSession as JSession
from trustworthy_dl_tpu.obs import hbm as jhbm
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu_torch.core.config import ServeConfig
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models.generate import generate
from trustworthy_dl_tpu_torch.obs import ObsSession
from trustworthy_dl_tpu_torch.obs import hbm as thbm
from trustworthy_dl_tpu_torch.obs.attribution import AttributionLedger
from trustworthy_dl_tpu_torch.serve import (ServeRequest, ServingEngine,
                                            scheduler as tsched)
from trustworthy_dl_tpu_torch.serve.scheduler import (
    ContinuousBatchingScheduler, SlotTask, choose_bucket, default_buckets)

pytestmark = pytest.mark.torchport

V = 277
JCFG = jgpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                        n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
STRIPE = dict(max_slots=3, max_seq=48, queue_limit=32)
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _traffic(seed=4, n=7):
    """Prompts of 2-30 tokens (every bucket of (16, 32, 48)), two sharing
    a 16-token prefix, more requests than slots."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, V, 16).tolist()
    out = []
    for i in range(n):
        if i in (2, 5):
            prompt = common + rng.integers(0, V, 3 + i).tolist()
        else:
            prompt = rng.integers(0, V, int(rng.integers(2, 31))).tolist()
        out.append((prompt, int(rng.integers(3, 10))))
    return out


def _serve(engine, request_cls, traffic, **kw):
    for prompt, new in traffic:
        assert engine.submit(request_cls(prompt=prompt, max_new_tokens=new,
                                         **kw)) is not None
    return engine.run_until_idle()


def _jax_signals(engine):
    """The JAX engine keeps the signals on its tasks only: read them as
    its scheduler retires each one."""
    seen = {}
    original = engine.scheduler.retire

    def keep(task, quarantine=False):
        seen[task.request_id] = (list(task.entropies), list(task.margins))
        return original(task, quarantine=quarantine)

    engine.scheduler.retire = keep
    return seen


@pytest.fixture(scope="module")
def jax_stripe(params):
    jparams, _ = params
    engine = JEngine(jparams, JCFG, paged=False, enable_monitor=False,
                     **STRIPE)
    signals = _jax_signals(engine)
    results = _serve(engine, JRequest, _traffic())
    return results, signals


def _ref(tparams, prompt, new):
    out = generate(tparams, CFG, torch.tensor([prompt]), new)
    return out[0, len(prompt):].tolist()


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_stripe_streams_match_jax_and_generate(params, jax_stripe,
                                               attn_impl):
    _, tparams = params
    jres, jsig = jax_stripe
    engine = ServingEngine(tparams, CFG, paged=False, enable_monitor=False,
                           attn_impl=attn_impl, device="cpu", **STRIPE)
    streamed = {}
    results = _serve(engine, ServeRequest, _traffic(), on_token=lambda r, t:
                     streamed.setdefault(r, []).append(t))
    assert streamed == {rid: r.tokens for rid, r in results.items()}
    assert sorted(results) == sorted(jres) == list(range(7))
    for rid, ref in jres.items():
        got = results[rid]
        assert got.status == ref.status == "completed"
        assert got.tokens == list(ref.tokens), rid
        prompt, new = _traffic()[rid]
        assert got.tokens == _ref(tparams, prompt, new), rid
        ent, mar = jsig[rid]
        assert min(mar) > 1e-3
        np.testing.assert_allclose(got.entropies, ent, atol=ATOL, rtol=0)
        np.testing.assert_allclose(got.margins, mar, atol=ATOL, rtol=0)
    s = engine.metrics_summary()
    assert s["layout"] == "stripe" and s["local_prefills"] == 7
    assert "blocks_in_use" not in s and "prefix_hits" not in s
    assert s["attn_kernel_paths"] == {p: "plain" for p in
                                      ("decode", "prefill", "verify",
                                       "adapter")}
    assert s["attn_impl"] == attn_impl
    assert engine.in_service_capacity == 3


def test_stripe_paged_and_generate_agree_greedy_and_sampled(params):
    """Greedy: stripe == paged == generate(); sampled (same seeds): the
    stripe stream equals the paged one, request by request."""
    _, tparams = params
    outputs = {}
    for label, kw in (("stripe", dict(paged=False)),
                      ("paged", dict(block_size=8, prefill_chunk=16))):
        engine = ServingEngine(tparams, CFG, device="cpu",
                               enable_monitor=False, seed=5,
                               **STRIPE, **kw)
        greedy = _serve(engine, ServeRequest, _traffic())
        sampled = _serve(engine, ServeRequest, _traffic(seed=9),
                         temperature=0.8)
        outputs[label] = ({r: x.tokens for r, x in greedy.items()
                           if r < 7},
                          {r: x.tokens for r, x in sampled.items()
                           if r >= 7})
    assert outputs["stripe"] == outputs["paged"]
    for rid, (prompt, new) in enumerate(_traffic()):
        assert outputs["stripe"][0][rid] == _ref(tparams, prompt, new)
    # The sampled draws really sampled: not the greedy streams.
    greedy_of_sampled = [_ref(tparams, p, n) for p, n in _traffic(seed=9)]
    assert list(outputs["stripe"][1].values()) != greedy_of_sampled


def test_int8_kv_stripe_pool_matches_jax(params):
    """After the same traffic the int8 stripe pools hold the same int8
    values, every slot and position (inactive slots' stale writes
    included), and scales within 1e-6 relative: the f32 K/V rows going
    into the quantizer differ by the rounding of the qkv product, which
    moves max|row| / 127 by an f32 step.  On the same rows the slot write
    is bit-equal (``test_stripe_slot_write_quantizes_as_jax``)."""
    jparams, tparams = params
    jengine = JEngine(jparams, JCFG, paged=False, kv_dtype="int8",
                      enable_monitor=False, **STRIPE)
    jres = _serve(jengine, JRequest, _traffic())
    engine = ServingEngine(tparams, CFG, paged=False, kv_dtype="int8",
                           enable_monitor=False, device="cpu", **STRIPE)
    res = _serve(engine, ServeRequest, _traffic())
    assert engine.kv_fallback_reason is None
    assert {r: x.tokens for r, x in res.items()} == \
        {r: list(x.tokens) for r, x in jres.items()}
    jkv, kv = jengine.scheduler.kv, engine.scheduler.kv
    assert kv.k.dtype == torch.int8 and kv.k_scale.dtype == torch.float32
    for name in ("k", "v"):
        np.testing.assert_array_equal(getattr(kv, name).numpy(),
                                      np.asarray(getattr(jkv, name)), name)
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(kv, name).numpy(),
                                   np.asarray(getattr(jkv, name)),
                                   rtol=1e-6, atol=0, err_msg=name)
    assert kv.pool_bytes == jkv.pool_bytes
    assert kv.bytes_per_slot == jkv.bytes_per_slot


def test_stripe_slot_write_quantizes_as_jax(params):
    """The stripe prefill quantizes the full-precision local rows once, at
    the slot write: the pool's values and scales there are bit-equal to
    JAX's ``quantize_kv`` of the same rows."""
    from trustworthy_dl_tpu.quant import int8 as jq8
    from trustworthy_dl_tpu_torch.models import generate as gen
    from trustworthy_dl_tpu_torch.serve.kv_slots import init_slots

    _, tparams = params
    view = gen._decode_view(tparams, CFG)
    prompt = torch.tensor(_traffic()[0][0] + [0] * 3)
    p = len(_traffic()[0][0])
    _, k_rows, v_rows, _, _ = tsched._local_prefill(CFG, view, prompt, p)
    pool = init_slots(CFG, 2, 48, kv_dtype=torch.int8)
    tsched._prefill_impl(CFG, pool, view, prompt, p, 1, 0, 1.0, True,
                         "kernel")
    w = prompt.shape[0]
    for rows, vals, scales in ((k_rows, pool.k, pool.k_scale),
                               (v_rows, pool.v, pool.v_scale)):
        jv, js = jq8.quantize_kv(jnp.asarray(rows.numpy()))
        np.testing.assert_array_equal(vals[:, 1:2, :, :w].numpy(),
                                      np.asarray(jv))
        np.testing.assert_array_equal(scales[:, 1:2, :, :w].numpy(),
                                      np.asarray(js))
        assert not vals[:, 0].any() and not vals[:, 1, :, w:].any()


def test_int8_weight_stripe_stream_matches_jax(params):
    jparams, tparams = params
    traffic = _traffic()[:4]
    jengine = JEngine(jparams, JCFG, paged=False, weight_dtype="int8",
                      enable_monitor=False, **STRIPE)
    jres = _serve(jengine, JRequest, traffic)
    engine = ServingEngine(tparams, CFG, paged=False, weight_dtype="int8",
                           enable_monitor=False, device="cpu", **STRIPE)
    res = _serve(engine, ServeRequest, traffic)
    assert {r: x.tokens for r, x in res.items()} == \
        {r: list(x.tokens) for r, x in jres.items()}


def test_failed_probe_shrinks_the_stripe_pool_by_slots(params,
                                                       monkeypatch):
    """JAX's ``tests/test_quant.py`` fallback on the stripe pool: 2 int8
    slots' bytes buy 1 model-dtype slot (the floor)."""
    _, tparams = params
    monkeypatch.setattr("trustworthy_dl_tpu_torch.quant.int8."
                        "kv_parity_probe", lambda *a, **k: False)
    engine = ServingEngine(tparams, CFG, max_slots=2, max_seq=48,
                           kv_dtype="int8", paged=False, device="cpu")
    assert engine.kv_fallback_reason == "kv_parity_probe_failed"
    assert engine.kv_dtype == "model"
    assert engine.scheduler.kv.max_slots == 1
    rid = engine.submit(ServeRequest(prompt=[1, 2, 3], max_new_tokens=2))
    assert engine.run_until_idle()[rid].status == "completed"


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knob", [dict(block_size=32), dict(num_blocks=12),
                                  dict(prefix_cache=False),
                                  dict(prefill_chunk=32),
                                  dict(attn_impl="plain")])
def test_paged_false_warns_for_each_paged_knob(knob):
    """JAX's ``tests/test_paged_kv.py:396-407``; the port's ``attn_impl``
    default is "kernel", so "plain" is the knob set away from it."""
    with pytest.warns(UserWarning, match="ignores paged-pool knob") as got:
        ServeConfig(paged=False, **knob)
    name = next(iter(knob))
    assert name in str(got[0].message)
    if name != "attn_impl":
        with pytest.warns(UserWarning, match="ignores paged-pool knob") \
                as jgot:
            JServeConfig(paged=False, **knob)
        assert str(jgot[0].message) == str(got[0].message)


def test_paged_false_defaults_are_silent_and_refusals_match_jax(params):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ServeConfig(paged=False)
        ServeConfig()
    # A paged geometry is not validated on the stripe pool (JAX's too).
    ServeConfig(paged=False, max_seq=40, block_size=16)
    with pytest.raises(ValueError, match="multiple of block_size"):
        ServeConfig(max_seq=40, block_size=16)
    for kw in (dict(spec_k=2), dict(adapter_rank=4)):
        with pytest.raises(ValueError) as got:
            ServeConfig(paged=False, **kw)
        with pytest.raises(ValueError) as want:
            JServeConfig(paged=False, **kw)
        assert str(got.value) == str(want.value)
        assert "requires the paged KV pool" in str(got.value)
        with pytest.raises(ValueError) as eng:
            ServingEngine(params[1], CFG, max_seq=32, paged=False,
                          device="cpu", **kw)
        assert str(eng.value) == str(want.value)
    assert ServeConfig(paged=False).paged is False
    assert ServeConfig().paged is JServeConfig().paged is True


def test_an_admission_that_cannot_bucket_leaks_no_slot(params):
    """The bucket resolves before the slot is claimed (JAX
    ``scheduler.py:621-626``); the engine refuses such a prompt at
    submit, as JAX's does."""
    _, tparams = params
    assert default_buckets(48) == (16, 32, 48)
    assert default_buckets(16) == (16,)
    assert choose_bucket((16, 32, 48), 17) == 32
    sched = ContinuousBatchingScheduler(tparams, CFG, 2, 48,
                                        torch.device("cpu"), buckets=(8,))
    task = SlotTask(request_id=0, prompt=np.arange(10, dtype=np.int32),
                    max_new_tokens=2, temperature=0.0)
    with pytest.raises(ValueError, match="largest prefill bucket 8"):
        sched.admit(task)
    assert sched.allocator.free_count == 2 and not sched.tasks
    with pytest.raises(ValueError, match="prefill bucket exceeds max_seq"):
        ContinuousBatchingScheduler(tparams, CFG, 2, 32,
                                    torch.device("cpu"), buckets=(64,))
    engine = ServingEngine(tparams, CFG, max_slots=2, max_seq=48,
                           paged=False, buckets=(8, 16), device="cpu")
    with pytest.raises(ValueError, match="largest prefill bucket 16"):
        engine.submit(ServeRequest(prompt=list(range(20)),
                                   max_new_tokens=2))
    assert engine.load == 0
    with pytest.raises(ValueError, match="stripe pool's prefill widths"):
        ServingEngine(tparams, CFG, max_slots=2, max_seq=48,
                      buckets=(8, 16), device="cpu")


# ---------------------------------------------------------------------------
# Telemetry on the stripe pool
# ---------------------------------------------------------------------------


def test_stripe_hbm_gate_shrinks_slots_as_jax(params, monkeypatch):
    """Budget 30,000 bytes: 3 slots of 48 positions at 512 bytes each
    (73,728 bytes in f32) shrink to the 1 slot the headroom buys."""
    jparams, tparams = params
    built = {}
    for side, hbm, factory in (("jax", jhbm, JSession),
                               ("port", thbm, ObsSession)):
        monkeypatch.setattr(hbm, "live_buffer_bytes", lambda: {"dev:0": 0})
        session = factory(None)
        monitor = session.enable_hbm(budget_bytes=30_000)
        if side == "jax":
            engine = JEngine(jparams, JCFG, paged=False, hbm=session.hbm,
                             **STRIPE)
        else:
            engine = ServingEngine(tparams, CFG, paged=False, device="cpu",
                                   obs=session, **STRIPE)
        built[side] = (engine.scheduler.kv.max_slots,
                       monitor.pressure_denials, monitor.last_headroom)
    assert built["port"] == built["jax"] == (1, 1, 30_000)


def test_stripe_attribution_and_cost_ledger(params, monkeypatch):
    """Attribution records say ``stripe`` with no block ids and verify
    clean; the ledger's ``serve.prefill`` (a prompt at the largest
    bucket) and ``serve.decode`` equal ``count_flops`` over one run."""
    _, tparams = params
    counted = {"prefill": [], "decode": []}
    for name in ("prefill", "decode"):
        real = getattr(tsched, f"_{name}_impl")

        def wrapped(*args, _real=real, _name=name, **kwargs):
            with thbm.count_flops() as cost:
                out = _real(*args, **kwargs)
            counted[_name].append((args[3].shape[0], cost))
            return out

        monkeypatch.setattr(tsched, f"_{name}_impl", wrapped)
    ledger = AttributionLedger()
    engine = ServingEngine(tparams, CFG, paged=False, device="cpu",
                           **STRIPE)
    engine.ledger = ledger
    _serve(engine, ServeRequest, _traffic()[:4] + [(list(range(40)), 3)])
    records = ledger.records()
    assert len(records) == 5
    assert {r["layout"] for r in records} == {"stripe"}
    assert all(r["block_ids"] == [] for r in records)
    assert engine.verify_attribution() == (True, [])
    costs = engine.analyze_programs(thbm.CostLedger()).programs
    assert set(costs) == {"serve.prefill", "serve.decode"}
    assert costs["serve.decode"]["rows"] == 3
    assert costs["serve.decode"]["keys"] == 48
    assert {c["flops"] for _, c in counted["decode"]} == \
        {costs["serve.decode"]["flops"]}
    widest = [c for width, c in counted["prefill"] if width == 48]
    assert widest and {c["flops"] for c in widest} == \
        {costs["serve.prefill"]["flops"]}
