"""The port's per-tenant adapter tier (serve/adapters.py, lowrank_delta, the
plain twin of kernel B9, the adapter path through the scheduler and the
engine, serve/workload.py) against the JAX package, on the CPU in f32, at
a tiny GPT-2 (2 layers, 32 wide, 4 heads).

Host contracts are held exactly: config validation, the page row, pool
bytes, the pool's pages and counters under one acquire/release/quarantine
sequence, the materialised and quantized weights and their upload (bf16
rounding included), and the seeded workload draws.  B9's plain twin agrees
with the JAX kernel in interpret mode within 2e-5 (f32 sums in another
order), with exact zeros on zero-page rows.  Greedy streams equal the JAX
engine's with two adapter tenants and a base request on both adapter
tiers; their prompts share no prefix, since the port scopes prefix reuse
by adapter and the JAX cache does not (ROADMAP Queue C).  The scoping has
tests of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.core.config import validate_adapters as jvalidate
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.ops import paged_attention as jpa
from trustworthy_dl_tpu.ops.fused_dequant_matmul import \
    lowrank_delta as jlowrank
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu.serve import adapters as jad
from trustworthy_dl_tpu.serve import workload as jwl
from trustworthy_dl_tpu_torch.cli import serve_main
from trustworthy_dl_tpu_torch.core.config import (ServeConfig,
                                                  validate_adapters)
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models.generate import generate
from trustworthy_dl_tpu_torch.ops import paged_attention as pa
from trustworthy_dl_tpu_torch.ops.fused_dequant_matmul import lowrank_delta
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
from trustworthy_dl_tpu_torch.serve import adapters as tad
from trustworthy_dl_tpu_torch.serve import workload as twl

pytestmark = pytest.mark.torchport

# vocab 241: no other test file uses it, so the JAX engines' programs are
# this file's own in the process-global jit cache.
JCFG = jgpt2.GPT2Config(vocab_size=241, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=241, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=2, max_seq=48, block_size=8, prefill_chunk=16)
ADAPTER_MAP = {"ta": "ad-a", "tb": "ad-b"}
INIT_SCALE = 0.5        # the default 0.02 moves no greedy token here


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    pa.reset_launch_counts()
    yield
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# Host contracts
# --------------------------------------------------------------------------


@pytest.mark.parametrize("args", [
    (0, None, "model", False, 0), (4, 4, "int8", True, 0),
    (-1, None, "model", True, 0), (4, 4, "model", False, 0),
    (4, 4, "model", True, 2), (4, 4, "fp4", True, 0),
    (4, 0, "model", True, 0)],
    ids=["off", "int8", "negative", "stripe", "spec", "fp4", "no-pages"])
def test_validate_adapters_matches_jax(args):
    outcomes = []
    for fn in (jvalidate, validate_adapters):
        try:
            fn(*args)
            outcomes.append("ok")
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


def test_serve_config_rejects_adapters_with_spec():
    ServeConfig(adapter_rank=4, adapter_dtype="int8")
    with pytest.raises(ValueError, match="spec_k"):
        ServeConfig(adapter_rank=4, spec_k=2)
    with pytest.raises(ValueError, match="adapter_dtype"):
        ServeConfig(adapter_rank=4, adapter_dtype="fp4")


def test_adapter_page_row_matches_jax():
    for page_by_slot, slots in (({1: 3, 2: 1}, 4), ({}, 2), ({0: 5}, 1)):
        got = tad.adapter_page_row(page_by_slot, slots)
        ref = jad.adapter_page_row(page_by_slot, slots)
        assert got.dtype == ref.dtype == np.int32
        assert got.tolist() == ref.tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_bytes_match_jax(dtype):
    jcfg = jgpt2.GPT2Config(vocab_size=241, n_positions=64, n_layer=3,
                            n_embd=32, n_head=4, dtype=getattr(jnp, dtype))
    cfg = gpt2.GPT2Config(vocab_size=241, n_positions=64, n_layer=3,
                          n_embd=32, n_head=4, dtype=getattr(torch, dtype))
    for pages, rank, tier in ((4, 8, "model"), (4, 8, "int8"),
                              (1, 16, "model"), (7, 2, "int8")):
        assert tad.adapter_pool_bytes(cfg, pages, rank, tier) == \
            jad.adapter_pool_bytes(jcfg, pages, rank, tier)
        assert tad.adapter_bytes_per_page(cfg, rank, tier) == \
            jad.adapter_bytes_per_page(jcfg, rank, tier)


def test_pool_lifecycle_matches_jax():
    """One acquire/release/quarantine sequence (hits, misses, a refused
    acquire, LRU eviction of a cold page, a deferred impound, readmission)
    gives the same pages and the same metrics() after every step."""
    pools = (jad.AdapterPool(JCFG, rank=2, pages=2),
             tad.AdapterPool(CFG, rank=2, pages=2))
    ops = [("acquire", "A"), ("acquire", "B"), ("acquire", "C"),
           ("release", "A"), ("acquire", "C"), ("acquire", "B"),
           ("quarantine", "B"), ("acquire", "B"), ("release", "B"),
           ("release", "B"), ("acquire", "D"), ("release", "C"),
           ("acquire", "D"), ("unquarantine", "B"), ("acquire", "B"),
           ("quarantine", "C"), ("acquire", "A")]
    logs = []
    for pool in pools:
        log = []
        for op, name in ops:
            log.append((op, name, getattr(pool, op)(name), pool.metrics(),
                        pool.resident, pool.pages_in_use,
                        sorted(pool.alloc.quarantined)))
        logs.append(log)
    assert logs[0] == logs[1]
    assert pools[1].metrics()["evictions"] >= 1


def test_materialize_and_quantize_bitwise():
    for name, rank, scale in (("tenant-x", 4, 0.02), ("ad-b", 3, 0.5)):
        ja, jb = jad.materialize_adapter(name, JCFG, rank, scale)
        ta, tb = tad.materialize_adapter(name, CFG, rank, scale)
        assert ta.dtype == np.float32
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tb, jb)
        for got, ref in zip(tad.quantize_adapter(ta, tb),
                            jad.quantize_adapter(ja, jb)):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("tier", ["model", "int8"])
def test_pool_upload_bitwise(tier):
    """The page the port uploads equals the JAX pool's bit for bit: bf16
    rounding of the f32 weights on the model tier of a bf16 model, int8
    values and scales on the int8 tier."""
    jcfg = jgpt2.GPT2Config(vocab_size=241, n_positions=64, n_layer=2,
                            n_embd=32, n_head=4, dtype=jnp.bfloat16)
    cfg = gpt2.GPT2Config(vocab_size=241, n_positions=64, n_layer=2,
                          n_embd=32, n_head=4, dtype=torch.bfloat16)
    jpool = jad.AdapterPool(jcfg, rank=4, pages=2, adapter_dtype=tier,
                            init_scale=0.3)
    tpool = tad.AdapterPool(cfg, rank=4, pages=2, adapter_dtype=tier,
                            init_scale=0.3)
    for name in ("ad-a", "ad-b"):
        assert jpool.acquire(name) == tpool.acquire(name)
    jargs, targs = jpool.device_args(), tpool.device_args()
    for j, t in zip(jargs, targs):
        assert (j is None) == (t is None)
        if t is None:
            continue
        ref = np.asarray(j)
        if t.dtype == torch.bfloat16:
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  ref.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), ref)
    assert float(targs[0][:, 0].abs().max()) == 0.0      # the zero page


@pytest.mark.parametrize("cfg", [
    dict(seed=1, num_requests=12),
    dict(seed=1, num_requests=12, num_adapters=4),
    dict(seed=5, num_requests=30, num_adapters=9, adapter_zipf=1.4,
         prompt_bimodal_frac=0.25, prompt_long_median=30, max_output=6)],
    ids=["base", "adapters", "bimodal"])
def test_workload_draws_match_jax(cfg):
    names = [t.name for t in jwl.make_tenant_population(8)]
    tnames = [t.name for t in twl.make_tenant_population(8)]
    assert names == tnames
    assert twl.zipf_adapter_assignments(tnames, 8, seed=cfg["seed"]) == \
        jwl.zipf_adapter_assignments(names, 8, seed=cfg["seed"])
    tenants = jwl.make_tenant_population(8)
    ref = jwl.generate_workload(jwl.WorkloadConfig(tenants=tenants, **cfg),
                                vocab_size=241, max_seq=48)
    got = twl.generate_workload(
        twl.WorkloadConfig(tenants=twl.make_tenant_population(8), **cfg),
        vocab_size=241, max_seq=48)
    assert [vars(i) for i in got] == [vars(i) for i in ref]


def test_closed_loop_driver_serves_a_workload(params):
    """``drive_closed_loop`` over the port's engine: every accepted item
    completes, adapter tenants through their adapters."""
    _, tparams = params
    engine = ServingEngine(tparams, CFG, device="cpu", adapter_rank=2,
                           adapter_pool_pages=2, queue_limit=4,
                           adapter_map=twl.zipf_adapter_assignments(
                               ["bulk", "interactive", "premium"], 3),
                           **ENGINE)
    items = twl.generate_workload(twl.WorkloadConfig(seed=2,
                                                     num_requests=8),
                                  vocab_size=241, max_seq=48)
    accepted = twl.drive_closed_loop(
        engine, items, lambda it: ServeRequest(
            prompt=list(it.prompt), max_new_tokens=it.max_new_tokens,
            tenant=it.tenant), inflight_target=3)
    results = engine.results
    assert accepted == len(results) == 8
    assert all(r.status == "completed" for r in results.values())
    assert {r.adapter for r in results.values()} <= set(
        engine.adapter_map.values())
    assert not engine.busy and engine.open_requests == 0


def test_open_loop_replay_serves_a_workload(params):
    """``replay_workload`` submits each item at its arrival time and steps
    the engine until it drains (a fast arrival rate keeps the test short)."""
    _, tparams = params
    engine = ServingEngine(tparams, CFG, device="cpu", **ENGINE)
    items = twl.generate_workload(
        twl.WorkloadConfig(seed=4, num_requests=6, mean_rps=500.0),
        vocab_size=241, max_seq=48)
    accepted = twl.replay_workload(
        engine, items, lambda it: ServeRequest(
            prompt=list(it.prompt), max_new_tokens=it.max_new_tokens))
    assert accepted == 6
    assert sorted(r.status for r in engine.results.values()) == \
        ["completed"] * 6


# --------------------------------------------------------------------------
# lowrank_delta and B9's plain twin vs the JAX kernel in interpret mode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("t", [3, 20])
@pytest.mark.parametrize("tier", ["model", "int8"])
def test_adapter_delta_plain_matches_jax_kernel(tier, t):
    """The cases of the JAX package's own kernel test (zero page, duplicate
    pages), on an f32 and an int8 pool with per-page scales, at T = 3 and
    a ragged T = 20.  Zero-page rows are exactly 0.0."""
    rng = np.random.default_rng(4)
    npg, rk, d, r = 5, 4, 32, 4
    x = rng.normal(size=(r, t, d)).astype(np.float32)
    pages = np.asarray([0, 2, 2, 4], np.int32)
    if tier == "int8":
        a_pool = rng.integers(-127, 128, size=(npg, d, rk)).astype(np.int8)
        b_pool = rng.integers(-127, 128, size=(npg, rk, d)).astype(np.int8)
        sa = rng.uniform(0.001, 0.01, npg).astype(np.float32)
        sb = rng.uniform(0.001, 0.01, npg).astype(np.float32)
    else:
        a_pool = rng.normal(size=(npg, d, rk)).astype(np.float32)
        b_pool = rng.normal(size=(npg, rk, d)).astype(np.float32)
        sa = sb = None
    a_pool[0] = 0
    b_pool[0] = 0

    def j(a):
        return None if a is None else jnp.asarray(a)

    def tt(a):
        return None if a is None else _t(a)

    ref = np.asarray(jpa.adapter_delta(j(x), j(a_pool), j(b_pool), j(pages),
                                       a_scale=j(sa), b_scale=j(sb),
                                       interpret=True))
    got = pa.adapter_delta(tt(x), tt(a_pool), tt(b_pool), tt(pages),
                           tt(sa), tt(sb))
    plain = pa.adapter_delta_plain(tt(x), tt(a_pool), tt(b_pool), tt(pages),
                                   tt(sa), tt(sb))
    assert got.dtype == torch.float32 and torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert bool((got[0] == 0.0).all())
    # lowrank_delta over the gathered pages, against the JAX spelling.
    gathered = [None if a is None else a[pages]
                for a in (a_pool, b_pool, sa, sb)]
    jref = np.asarray(jlowrank(j(x), *[j(a) for a in gathered]))
    np.testing.assert_allclose(
        lowrank_delta(tt(x), *[tt(a) for a in gathered]).numpy(), jref,
        rtol=2e-5, atol=2e-5)


def test_adapter_delta_reads_strided_site_views():
    """The engine hands B9 one site of one layer, ``a[l][:, site]``, a
    strided view: the plain twin over it equals the contiguous copy's."""
    rng = np.random.default_rng(5)
    a = _t(rng.normal(size=(2, 4, 2, 16, 3)).astype(np.float32))
    b = _t(rng.normal(size=(2, 4, 2, 3, 16)).astype(np.float32))
    x = _t(rng.normal(size=(3, 2, 16)).astype(np.float32))
    pages = torch.tensor([1, 3, 0], dtype=torch.int32)
    view_a, view_b = a[1][:, 1], b[1][:, 1]
    assert not view_a.is_contiguous()
    assert torch.equal(pa.adapter_delta(x, view_a, view_b, pages),
                       pa.adapter_delta(x, view_a.contiguous(),
                                        view_b.contiguous(), pages))


# --------------------------------------------------------------------------
# Serving against the JAX engine
# --------------------------------------------------------------------------


def _traffic():
    """Two adapter tenants and a base request; no two prompts share a
    full block (so the JAX cache's unscoped reuse never triggers); tenant
    "ta" twice, so its page is hit."""
    rng = np.random.default_rng(5)
    lens = [20, 9, 12, 25, 6]
    tenants = ["ta", "tb", None, "ta", "tb"]
    return [(rng.integers(0, 241, n).tolist(), tenant, 6)
            for n, tenant in zip(lens, tenants)]


@pytest.fixture(scope="module")
def jax_results(params):
    """The JAX engine's results on both adapter tiers, built once."""
    jparams, _ = params
    out = {}
    for tier in ("model", "int8"):
        engine = JEngine(jparams, JCFG, paged=True, attn_impl="jnp",
                         adapter_rank=4, adapter_pool_pages=2,
                         adapter_dtype=tier, adapter_map=ADAPTER_MAP,
                         **ENGINE)
        engine.adapter_pool.init_scale = INIT_SCALE
        for prompt, tenant, new in _traffic():
            engine.submit(JRequest(prompt=prompt, max_new_tokens=new,
                                   tenant=tenant))
        out[tier] = (engine.run_until_idle(),
                     engine.metrics_summary()["adapters"])
    return out


def _port_engine(tparams, tier, attn_impl="kernel", **kw):
    engine = ServingEngine(tparams, CFG, device="cpu", attn_impl=attn_impl,
                           adapter_rank=4, adapter_pool_pages=2,
                           adapter_dtype=tier, adapter_map=ADAPTER_MAP,
                           **{**ENGINE, **kw})
    engine.adapter_pool.init_scale = INIT_SCALE
    return engine


def _serve(engine, traffic):
    rids = [engine.submit(ServeRequest(prompt=p, max_new_tokens=n,
                                       tenant=tenant))
            for p, tenant, n in traffic]
    results = engine.run_until_idle()
    return [results[rid] for rid in rids]


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
@pytest.mark.parametrize("tier", ["model", "int8"])
def test_served_streams_match_jax(params, jax_results, tier, attn_impl):
    _, tparams = params
    engine = _port_engine(tparams, tier, attn_impl)
    got = _serve(engine, _traffic())
    ref, ref_adapters = jax_results[tier]
    for rid, res in enumerate(got):
        assert res.status == ref[rid].status == "completed"
        assert res.tokens == ref[rid].tokens, rid
        assert res.adapter == ref[rid].adapter
    summary = engine.metrics_summary()
    assert summary["adapters"] == ref_adapters
    assert summary["local_prefills"] == 1        # the base request only
    sched = engine.scheduler
    assert sched.blocks_in_use == len(sched.prefix)
    pool = engine.adapter_pool
    assert all(pool.alloc.refcount(p) == 1 for p in pool.resident.values())


def test_adapters_move_the_streams(params, jax_results):
    """Against the base model (rank 0), the adapter tenants' greedy
    streams differ, the base request's does not."""
    _, tparams = params
    base = _serve(ServingEngine(tparams, CFG, device="cpu", **ENGINE),
                  [(p, None, n) for p, _, n in _traffic()])
    ref, _ = jax_results["model"]
    moved = [base[rid].tokens != ref[rid].tokens
             for rid in range(len(base))]
    assert moved == [tenant is not None for _, tenant, _ in _traffic()]


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_rank0_and_zero_page_streams_equal_generate(params, attn_impl):
    """Rank 0 (no pool) and rank > 0 with every request on the zero page
    serve the same streams as ``generate()``, on both KV tiers."""
    _, tparams = params
    traffic = [(p, None, n) for p, _, n in _traffic()]
    refs = [generate(tparams, CFG, torch.tensor([p]), n)[0, len(p):]
            .tolist() for p, _, n in traffic]
    for kv_dtype in ("model", "int8"):
        streams = []
        for rank in (0, 3):
            engine = ServingEngine(tparams, CFG, device="cpu",
                                   attn_impl=attn_impl, adapter_rank=rank,
                                   kv_dtype=kv_dtype, kv_parity_check=False,
                                   **ENGINE)
            streams.append([r.tokens for r in _serve(engine, traffic)])
        assert streams[0] == streams[1]
        if kv_dtype == "model":
            assert streams[0] == refs


def test_two_wave_churn_counters_match_jax(params):
    """Two waves of adapter traffic through 2 pages (six adapters, the
    second wave never seen before): the pool's counters equal the JAX
    engine's after each wave, with evictions in both waves."""
    jparams, tparams = params
    adapter_map = {f"t{i}": f"ad{i}" for i in range(6)}
    kw = dict(adapter_rank=2, adapter_pool_pages=2, adapter_map=adapter_map,
              queue_limit=16, **ENGINE)
    jengine = JEngine(jparams, JCFG, paged=True, attn_impl="jnp", **kw)
    tengine = ServingEngine(tparams, CFG, device="cpu", **kw)
    for wave in (["t0", "t1", "t2", "t0"], ["t3", "t4", "t5", "t3", "t1"]):
        rng = np.random.default_rng(len(wave))
        prompts = [rng.integers(0, 241, 5 + i).tolist()
                   for i in range(len(wave))]
        for prompt, tenant in zip(prompts, wave):
            jengine.submit(JRequest(prompt=prompt, max_new_tokens=4,
                                    tenant=tenant))
            tengine.submit(ServeRequest(prompt=prompt, max_new_tokens=4,
                                        tenant=tenant))
        jres, tres = jengine.run_until_idle(), tengine.run_until_idle()
        assert {k: r.tokens for k, r in tres.items()} == \
            {k: r.tokens for k, r in jres.items()}
        assert tengine.metrics_summary()["adapters"] == \
            jengine.metrics_summary()["adapters"]
    assert tengine.adapter_pool.evictions >= 2


# --------------------------------------------------------------------------
# Prefix reuse scoped by adapter
# --------------------------------------------------------------------------


def _layer1_prefix_k(engine, prompt, scope):
    """Layer 1's K in the full prompt blocks cached under ``scope``."""
    prefix = engine.scheduler.prefix
    blocks = prefix.lookup(prompt, len(prompt) // 8, scope=scope)
    for b in blocks:
        engine.scheduler.blocks.release(b)
    return engine.scheduler.kv.k[1, blocks].clone()


def test_adapter_request_never_reuses_base_prefix(params):
    """A base request publishes a 24-token prompt's blocks; the same
    prompt under adapter "ad-a" gets no prefix hit, and its stream and its
    layer-1 prefix K equal its run on a fresh engine.  Layer 1's K of the
    two models differ there (the reuse would have been wrong)."""
    _, tparams = params
    prompt = np.random.default_rng(9).integers(0, 241, 24).tolist()
    shared = _port_engine(tparams, "model")
    base = _serve(shared, [(prompt, None, 6)])[0]
    hits = shared.metrics_summary()["prefix_hits"]
    mine = _serve(shared, [(prompt, "ta", 6)])[0]
    assert shared.metrics_summary()["prefix_hits"] == hits
    alone = _port_engine(tparams, "model")
    ref = _serve(alone, [(prompt, "ta", 6)])[0]
    assert mine.tokens == ref.tokens != base.tokens
    k_mine = _layer1_prefix_k(shared, prompt, "ad-a")
    k_alone = _layer1_prefix_k(alone, prompt, "ad-a")
    k_base = _layer1_prefix_k(shared, prompt, None)
    assert k_mine.shape[0] == 3 and torch.equal(k_mine, k_alone)
    assert float((k_mine - k_base).abs().max()) > 1e-3


def test_same_adapter_requests_share_prefix(params):
    _, tparams = params
    rng = np.random.default_rng(10)
    head = rng.integers(0, 241, 16).tolist()
    engine = _port_engine(tparams, "int8")
    first = _serve(engine, [(head + [1, 2, 3], "ta", 4)])[0]
    second = _serve(engine, [(head + [7, 8], "ta", 4),
                             (head + [7, 8], "tb", 4)])
    summary = engine.metrics_summary()
    assert summary["prefix_hits"] == 1              # "ta" only
    assert summary["prefix_tokens_reused"] == 16
    alone = _serve(_port_engine(tparams, "int8"), [(head + [7, 8], "ta", 4)])
    assert second[0].tokens == alone[0].tokens
    assert first.status == "completed"


def test_prefix_cache_scopes_stay_apart():
    from trustworthy_dl_tpu_torch.serve.kv_slots import (BlockAllocator,
                                                         PrefixCache)

    blocks = BlockAllocator(8)
    cache = PrefixCache(4, blocks)
    tokens = list(range(12))
    a = blocks.alloc(3)
    assert cache.insert(tokens, a, scope="x") == a
    assert cache.lookup(tokens, 3) == []
    assert cache.lookup(tokens, 3, scope="y") == []
    assert cache.lookup(tokens, 3, scope="x") == a
    b = blocks.alloc(3)
    assert cache.insert(tokens, b) == b             # the base scope
    assert cache.lookup(tokens, 2) == b[:2]
    assert len(cache) == 6
    assert cache.purge({a[0]}) == 3 and len(cache) == 3


# --------------------------------------------------------------------------
# Engine surface
# --------------------------------------------------------------------------


def test_admission_unwinds_when_every_page_is_live(params):
    """One page, two adapters: the second request waits (its blocks and
    row released, nothing leaked) until the first retires, then its
    adapter evicts the cold page."""
    _, tparams = params
    engine = ServingEngine(tparams, CFG, device="cpu", adapter_rank=2,
                           adapter_pool_pages=1, adapter_map=ADAPTER_MAP,
                           **ENGINE)
    sched = engine.scheduler
    a = engine.submit(ServeRequest(prompt=[1, 2, 3], max_new_tokens=3,
                                   tenant="ta"))
    b = engine.submit(ServeRequest(prompt=[4, 5, 6], max_new_tokens=3,
                                   tenant="tb"))
    engine.step()
    assert len(sched.tasks) == 1 and sched.allocator.free_count == 1
    assert sched.blocks_in_use == 1
    results = engine.run_until_idle()
    assert results[a].status == results[b].status == "completed"
    assert engine.adapter_pool.metrics()["evictions"] == 1
    assert sched.blocks_in_use == len(sched.prefix)


def test_adapter_quarantine_impounds_and_sheds(params):
    _, tparams = params
    engine = _port_engine(tparams, "model")
    first = engine.submit(ServeRequest(prompt=[1, 2, 3], max_new_tokens=4,
                                       tenant="ta"))
    engine.step()
    engine.quarantine_adapter("ad-a")             # live: impound deferred
    assert engine.quarantined_adapters == {"ad-a"}
    results = engine.run_until_idle()
    assert results[first].status == "completed"
    assert "ad-a" not in engine.adapter_pool.resident
    assert engine.adapter_pool.pages_in_use == 1          # impounded
    late = engine.submit(ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                      tenant="ta"))
    assert engine.run_until_idle()[late].status == "no_capacity"
    engine.unquarantine_adapter("ad-a")
    again = engine.submit(ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                       tenant="ta"))
    assert engine.run_until_idle()[again].status == "completed"
    assert engine.quarantined_slots == set()


def test_engine_rejects_adapters_it_cannot_serve(params):
    _, tparams = params
    engine = ServingEngine(tparams, CFG, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="adapter tier is off"):
        engine.submit(ServeRequest(prompt=[1], max_new_tokens=1,
                                   adapter="ad-a"))
    with pytest.raises(ValueError, match="spec_k"):
        ServingEngine(tparams, CFG, device="cpu", adapter_rank=2, spec_k=2,
                      **ENGINE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(tparams, CFG, adapter_rank=2, **ENGINE)
    explicit = _port_engine(tparams, "model")
    rid = explicit.submit(ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                       tenant="ta", adapter="ad-z"))
    assert explicit.run_until_idle()[rid].adapter == "ad-z"


def test_cli_serves_tenants_through_adapters_on_cpu(capsys, tmp_path):
    rc = serve_main(["--device", "cpu", "--num-requests", "6",
                     "--checkpoint-dir", str(tmp_path / "none"),
                     "--max-seq", "32", "--max-new-tokens", "4",
                     "--prompt-len", "6", "--block-size", "8",
                     "--adapter-rank", "2", "--adapter-pool-pages", "2",
                     "--adapter-dtype", "int8"],
                    model_overrides=dict(n_layer=1, n_embd=16, n_head=2,
                                         vocab_size=64, n_positions=32,
                                         dtype=torch.float32))
    out = capsys.readouterr().out
    assert rc == 0
    assert "requests_completed: 6" in out
    assert "adapters: rank=2 dtype=int8 pages=2" in out


def test_kernel_path_calls_b9_twice_a_layer_per_forward(params, monkeypatch):
    """The count ``chip_smoke.py`` asserts from the launch counters on the
    card, checked here by counting wrapper calls: B9 twice a layer for
    every chunk and every decode tick (adapterless rows ride the zero
    page), never on the dense local prefill (the base request's)."""
    _, tparams = params
    calls = {"adapter_delta": 0, "paged_attention": 0,
             "paged_prefill_attention": 0, "logit_trust_stats": 0}

    def counting(name):
        fn = getattr(pa, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(pa, name, counting(name))
    engine = _port_engine(tparams, "model")
    results = _serve(engine, _traffic())
    s = engine.metrics_summary()
    assert all(r.status == "completed" for r in results)
    assert s["local_prefills"] == 1
    forwards = s["decode_ticks"] + s["prefill_chunks"]
    assert calls == {
        "adapter_delta": 2 * CFG.n_layer * forwards,
        "paged_attention": CFG.n_layer * s["decode_ticks"],
        "paged_prefill_attention": CFG.n_layer * s["prefill_chunks"],
        "logit_trust_stats": len(results) + s["decode_ticks"]}
