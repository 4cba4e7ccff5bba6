"""Live KV block migration between two of the port's engines
(``serve/migrate.py``, the paged scheduler's migration surface and the
engine's ``export_request`` / ``adopt_request`` / ``cancel``), on the CPU
in f32: the "capability gate" and "two-phase protocol" rings of JAX's
``tests/test_migrate.py:79-247``.

Tiny GPT-2 (2 layers, 32 wide, 4 heads, vocab 337: a size no other test
file uses), weights made on the JAX side and converted with
``models/convert.params_from_jax``; the engines of JAX's file (2 slots, 48
positions, blocks of 8, 24 blocks).

* ``can_migrate``: self, stripe on either end, a geometry mismatch, a tier
  mismatch, int8 to int8, fakes; ``export_request(999) is None``.
* Migrated streams equal the unmigrated stream, greedy and sampled (the
  seed travels, the next draw index is ``len(emitted)``); greedy streams
  equal JAX's ``generate()``; the streamed tokens have no duplicate and
  no gap across the hand-off; over int8 pools the scales travel too.
* A destination with no free row refuses: both free counts unchanged, the
  source finishes the request.  A claim that is aborted returns every
  block, the row and the adapter page.
* ``quarantine_src`` impounds the source blocks.
* An adapter request re-acquires its page on the destination and keeps
  the unmigrated adapter stream (which differs from the base model's).
* A speculative source unwinds its draft claims before the snapshot: every
  source block is back, and the continuation equals ``generate()``.
* ``verify_attribution()`` holds on both engines, the destination's record
  carrying ``migrated_from``; the source's says ``migrated``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models.generate import generate as jgenerate
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs.attribution import AttributionLedger
from trustworthy_dl_tpu_torch.serve import (ServeRequest, ServingEngine,
                                            can_migrate, migrate_request)

pytestmark = pytest.mark.torchport

V = 337
JCFG = jgpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                        n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
PROMPT = [5, 17, 3, 88, 41, 2]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _jref(jparams, prompt, new):
    out = jgenerate(jparams, JCFG, jnp.asarray([prompt], jnp.int32), new)
    return np.asarray(out)[0, len(prompt):].tolist()


def _paged(tparams, **kw):
    engine = ServingEngine(tparams, CFG, **{
        **dict(max_slots=2, max_seq=48, queue_limit=4, block_size=8,
               num_blocks=24, device="cpu"), **kw})
    engine.ledger = AttributionLedger()
    return engine


def _decode_until(engine, rid, n_tokens):
    """Step the source until the request has emitted ``n_tokens``: it is
    mid-decode, the state a migration snapshots."""
    for _ in range(64):
        pair = engine._inflight.get(rid)
        if pair is not None and len(pair[0].emitted) >= n_tokens:
            return
        engine.step()
    raise AssertionError(f"request {rid} never reached {n_tokens} tokens")


# ---------------------------------------------------------------------------
# The capability gate
# ---------------------------------------------------------------------------


def test_can_migrate_structural_gate(params):
    _, tparams = params
    a, b = _paged(tparams), _paged(tparams)
    assert can_migrate(a, b) and can_migrate(b, a)
    assert not can_migrate(a, a)
    stripe = ServingEngine(tparams, CFG, max_slots=2, max_seq=48,
                           queue_limit=4, paged=False, device="cpu")
    assert not can_migrate(stripe, b) and not can_migrate(a, stripe)
    small = _paged(tparams, num_blocks=12)
    assert not can_migrate(a, small)
    i8 = _paged(tparams, kv_dtype="int8")
    assert i8.scheduler.kv.quantized
    assert not can_migrate(a, i8) and not can_migrate(i8, a)
    assert can_migrate(i8, _paged(tparams, kv_dtype="int8"))
    assert not can_migrate(object(), b) and not can_migrate(a, object())
    assert a.export_request(999) is None
    # The stripe engine exports nothing, and a queued request neither.
    rid = stripe.submit(ServeRequest(prompt=PROMPT, max_new_tokens=4))
    assert stripe.export_request(rid) is None
    rid = a.submit(ServeRequest(prompt=PROMPT, max_new_tokens=4))
    assert a.export_request(rid) is None and a.queued_ids == [rid]


# ---------------------------------------------------------------------------
# The two-phase protocol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_migrated_streams_equal_the_unmigrated_ones(params, kv_dtype):
    """Greedy and sampled: the continuation on the destination is the
    stream the source would have produced (the int8 tier's scales travel
    with its values); greedy streams equal JAX's ``generate()``; every
    token is streamed exactly once across the hand-off."""
    jparams, tparams = params
    new = 8
    for temp in (0.0, 0.8):
        knobs = dict(kv_dtype=kv_dtype, seed=3)
        ref_engine = _paged(tparams, **knobs)
        ref_id = ref_engine.submit(ServeRequest(
            prompt=PROMPT, max_new_tokens=new, temperature=temp))
        want = ref_engine.run_until_idle()[ref_id].tokens
        if temp == 0.0:
            assert want == _jref(jparams, PROMPT, new)
        src, dst = _paged(tparams, **knobs), _paged(tparams, **knobs)
        streamed = []
        rid = src.submit(ServeRequest(
            prompt=PROMPT, max_new_tokens=new, temperature=temp,
            on_token=lambda r, t: streamed.append(t)))
        _decode_until(src, rid, 3)
        assert src.decode_ready_ids == [rid] and src.inflight_ids == [rid]
        src_free = src.scheduler.blocks.free_count
        moved = migrate_request(src, dst, rid,
                                on_token=lambda r, t: streamed.append(t))
        assert moved is not None and moved["blocks"] >= 1
        assert rid not in src._inflight and src.load == 0
        assert src.results[rid].status == "migrated"
        assert src.scheduler.blocks.free_count == src_free + moved["blocks"]
        assert dst.load == 1
        out = dst.run_until_idle()[moved["local_id"]]
        assert out.status == "completed"
        assert out.tokens == want, f"temp={temp} stream diverged"
        assert streamed == want
        for engine in (src, dst):
            assert engine.verify_attribution() == (True, [])
        record = [r for r in dst.ledger.records()
                  if r["request_id"] == moved["local_id"]][0]
        assert record["migrated_from"]["block_ids"] == \
            [r for r in src.ledger.records()
             if r["request_id"] == rid][0]["block_ids"]


def test_destination_refusal_leaves_both_untouched(params):
    jparams, tparams = params
    prompt, new = [5, 17, 3], 6
    src = _paged(tparams, max_slots=1, max_seq=64, queue_limit=8)
    dst = _paged(tparams, max_slots=1, max_seq=64, queue_limit=8)
    dst.submit(ServeRequest(prompt=list(range(1, 40)), max_new_tokens=20))
    for _ in range(3):
        dst.step()
    rid = src.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
    _decode_until(src, rid, 2)
    src_free = src.scheduler.blocks.free_count
    dst_free = dst.scheduler.blocks.free_count
    refused = []
    assert migrate_request(src, dst, rid, on_refuse=refused.append) is None
    assert refused == ["claim_refused"]
    assert rid in src._inflight
    assert src.scheduler.blocks.free_count == src_free
    assert dst.scheduler.blocks.free_count == dst_free
    out = src.run_until_idle()[rid]
    assert out.status == "completed"
    assert out.tokens == _jref(jparams, prompt, new)
    assert migrate_request(src, dst, rid, on_refuse=refused.append) is None
    assert refused[-1] == "src_not_migratable"


def test_an_aborted_claim_returns_everything(params):
    _, tparams = params
    dst = _paged(tparams, adapter_rank=2, adapter_pool_pages=2)
    free = (dst.scheduler.blocks.free_count,
            dst.scheduler.allocator.free_count)
    claim = dst.scheduler.claim_migration(3, "ad-x")
    assert claim is not None and len(claim["block_ids"]) == 3
    assert claim["adapter_page"] != 0
    assert dst.adapter_pool.alloc.refcount(claim["adapter_page"]) == 2
    dst.scheduler.abort_migration(claim)
    assert (dst.scheduler.blocks.free_count,
            dst.scheduler.allocator.free_count) == free
    assert dst.adapter_pool.alloc.refcount(claim["adapter_page"]) == 1
    # An adapterless destination refuses an adapter request, unwound.
    plain = _paged(tparams)
    assert plain.scheduler.claim_migration(3, "ad-x") is None
    assert plain.scheduler.blocks.free_count == 24


def test_quarantined_source_impounds_blocks(params):
    jparams, tparams = params
    new = 10
    src, dst = _paged(tparams), _paged(tparams)
    rid = src.submit(ServeRequest(prompt=PROMPT, max_new_tokens=new))
    _decode_until(src, rid, 3)
    snap_ids = list(src.export_request(rid)["block_ids"])
    free_before = src.scheduler.blocks.free_count
    moved = migrate_request(src, dst, rid, quarantine_src=True)
    assert moved is not None
    assert set(snap_ids) <= src.scheduler.blocks.quarantined
    assert src.scheduler.blocks.free_count == free_before
    assert src.in_service_capacity == 1
    out = dst.run_until_idle()[moved["local_id"]]
    assert out.tokens == _jref(jparams, PROMPT, new)
    assert src.verify_attribution() == (True, [])


def test_adapter_page_reacquired_on_destination(params):
    jparams, tparams = params
    new = 8

    def eng():
        e = _paged(tparams, adapter_rank=4, adapter_pool_pages=2,
                   adapter_map={"tx": "ad-x"})
        e.adapter_pool.init_scale = 0.5
        return e

    ref = eng()
    ref_id = ref.submit(ServeRequest(prompt=PROMPT, max_new_tokens=new,
                                     tenant="tx"))
    want = ref.run_until_idle()[ref_id].tokens
    assert want != _jref(jparams, PROMPT, new)
    src, dst = eng(), eng()
    rid = src.submit(ServeRequest(prompt=PROMPT, max_new_tokens=new,
                                  tenant="tx"))
    _decode_until(src, rid, 3)
    moved = migrate_request(src, dst, rid)
    assert moved is not None
    out = dst.run_until_idle()[moved["local_id"]]
    assert out.adapter == "ad-x"
    assert out.tokens == want
    assert "ad-x" in dst.adapter_pool.resident
    for engine in (src, dst):
        assert engine.verify_attribution() == (True, [])


def test_spec_claims_unwound_before_migration(params):
    jparams, tparams = params
    new = 16
    src, dst = _paged(tparams, spec_k=2), _paged(tparams, spec_k=2)
    free0 = src.scheduler.blocks.free_count
    rid = src.submit(ServeRequest(prompt=PROMPT, max_new_tokens=new))
    _decode_until(src, rid, 2)
    moved = migrate_request(src, dst, rid)
    assert moved is not None
    assert not src.scheduler._spec_claims
    assert src.scheduler.blocks.free_count == free0
    out = dst.run_until_idle()[moved["local_id"]]
    assert out.tokens == _jref(jparams, PROMPT, new)
