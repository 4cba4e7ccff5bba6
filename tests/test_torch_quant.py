"""The port's int8 tiers (trustworthy_dl_tpu_torch/quant/int8.py, the B4
plain twin, the int8 dense cache and the engine's int8 knobs) against the
JAX package on the same numpy inputs and converted weights, on the CPU.

Tolerances: int8 values and scales bitwise equal (the same f32 division
and round-half-to-even); the round-trip errors equal; the dequant matmul
within 1e-5 of the JAX Pallas kernel in interpret mode (f32 sums in
another order); int8-cache logits within 1e-5 (f32); greedy streams
identical.  On CPU tensors no kernel launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import generate as jgen
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.ops import fused_dequant_matmul as jfdm
from trustworthy_dl_tpu.quant import int8 as jq8
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu.serve import kv_slots as jkv
from trustworthy_dl_tpu_torch import ops
from trustworthy_dl_tpu_torch.core.config import ServeConfig
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models import generate as gen
from trustworthy_dl_tpu_torch.ops import fused_dequant_matmul as fdm
from trustworthy_dl_tpu_torch.quant import int8 as q8
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
from trustworthy_dl_tpu_torch.serve import kv_slots as tkv

pytestmark = pytest.mark.torchport

# vocab 233: no other test file uses it, so the JAX engine's programs are
# this file's own in the process-wide jit cache.
JCFG = jgpt2.GPT2Config(vocab_size=233, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=233, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=2, max_seq=48, block_size=8, queue_limit=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    ops.reset_launch_counts()
    yield
    assert all(n == 0 for n in ops.launch_counts().values())


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(3), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("axis", [-1, -2])
def test_quantize_int8_bitwise_equal(axis):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 16, 24)) * rng.uniform(0.01, 5.0, (3, 1, 24))
         ).astype(np.float32)
    x[1, :, 5] = 0.0                                   # an all-zero channel
    x[2, :, :] = np.round(x[2] * 4) / 4                # many exact halves
    jq, js = jq8.quantize_int8(jnp.asarray(x), axis=axis)
    tq, ts = q8.quantize_int8(_t(x), axis=axis)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = q8.dequantize_int8(tq, ts, axis=axis)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jq8.dequantize_int8(jq, js, axis=axis)))


def test_quantize_decode_view_bitwise_and_roundtrip_errors(params):
    """Every layer's four int8 matrices and scales equal the JAX view's
    stacked ones bit for bit, and so do the round-trip errors."""
    jparams, tparams = params
    jview = jq8.quantize_decode_view(jparams, JCFG)
    tview = q8.quantize_decode_view(tparams, CFG)
    for layer, tl in enumerate(tview["layers"]):
        for group, name in (("attn", "qkv"), ("attn", "proj"),
                            ("mlp", "fc"), ("mlp", "proj")):
            jd = jview["blocks"][group][name]
            td = tl[group][name]
            assert q8.is_quantized_dense(td) and td["w_q"].dtype == torch.int8
            np.testing.assert_array_equal(td["w_q"].numpy(),
                                          np.asarray(jd["w_q"][layer]))
            np.testing.assert_array_equal(td["scale"].numpy(),
                                          np.asarray(jd["scale"][layer]))
    jerr = jq8.weight_roundtrip_errors(jparams, JCFG)
    assert q8.weight_roundtrip_errors(tparams, CFG) == jerr
    assert q8.weight_roundtrip_errors(tparams, CFG, qview=tview) == jerr
    assert max(jerr) <= 1 / 254 + 1e-6
    assert q8.draft_decode_view(tparams, CFG, qview=tview) is tview


@pytest.mark.parametrize("m", [8, 15, 64])
def test_dequant_matmul_plain_matches_interpret_kernel(m):
    rng = np.random.default_rng(1)
    k, n = 128, 256
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, scale = jq8.quantize_int8(jnp.asarray(
        rng.normal(size=(k, n)).astype(np.float32) * 0.05), axis=0)
    ref = jfdm._dq_matmul_pallas(jnp.asarray(x), wq, scale, interpret=True)
    got = fdm.dequant_matmul(_t(x), _t(wq), _t(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # qdense: the product rounded to the compute dtype, then the bias.
    d = {"w_q": _t(wq), "scale": _t(scale), "b": torch.ones(n)}
    y = q8.qdense(d, _t(x)[None], torch.float32)
    jy = jq8.qdense({"w_q": wq, "scale": scale, "b": jnp.ones(n)},
                    jnp.asarray(x)[None], jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("m", [1, 8, 15])
def test_dequant_matmul_plain_matches_jax_at_d96(m):
    """n_embd 96's qkv (K = 96, N = 288): shapes the JAX Pallas tile does
    not take, so JAX runs its jnp contraction; the port's twin (and, on the
    card, B4, which takes K and N multiples of 16) within 1e-5."""
    rng = np.random.default_rng(2)
    k, n = 96, 288
    assert not jfdm.dequant_matmul_tiles(m, k, n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wq, scale = jq8.quantize_int8(jnp.asarray(
        rng.normal(size=(k, n)).astype(np.float32) * 0.05), axis=0)
    ref = jfdm.dequant_matmul(jnp.asarray(x), wq, scale)
    got = fdm.dequant_matmul(_t(x), _t(wq), _t(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_d96_int8_weight_engine_greedy_streams_match_jax():
    """A GPT-2 at n_embd 96 with 2 heads (its block matrices multiples of
    16, not of 64) on the weight-only int8 tier: the port's greedy streams
    on both attention paths equal the JAX engine's."""
    jcfg = jgpt2.GPT2Config(vocab_size=233, n_positions=64, n_layer=2,
                            n_embd=96, n_head=2, dtype=jnp.float32)
    cfg = gpt2.GPT2Config(vocab_size=233, n_positions=64, n_layer=2,
                          n_embd=96, n_head=2, dtype=torch.float32)
    jparams = jgpt2.init_params(jax.random.PRNGKey(4), jcfg)
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    knobs = dict(weight_dtype="int8", kv_parity_check=False)
    jengine = JEngine(jparams, jcfg, paged=True, attn_impl="jnp",
                      enable_monitor=False, **knobs, **ENGINE)
    for prompt, new in _traffic():
        jengine.submit(JRequest(prompt=prompt, max_new_tokens=new))
    ref = jengine.run_until_idle()
    for impl in ("kernel", "plain"):
        engine = ServingEngine(tparams, cfg, attn_impl=impl, device="cpu",
                               enable_monitor=False, **knobs, **ENGINE)
        for prompt, new in _traffic():
            engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
        got = engine.run_until_idle()
        assert engine.metrics_summary()["weight_dtype"] == "int8"
        assert {r: v.tokens for r, v in got.items()} \
            == {r: v.tokens for r, v in ref.items()}


def test_int8_dense_cache_logits_match_jax(params):
    """A prompt then three greedy decode steps through an int8 KV cache:
    logits within 1e-5, cache values and scales (dequantized) within one
    int8 step of each other."""
    jparams, tparams = params
    jview = jgen._decode_view(jparams, JCFG)
    tview = gen._decode_view(tparams, CFG)
    prompt = np.asarray([[5, 17, 3, 99, 42, 7]], np.int32)
    jc = jgen.init_cache(JCFG, 1, 12, kv_dtype=jnp.int8)
    tc = gen.init_cache(CFG, 1, 12, kv_dtype=torch.int8)
    assert tc.k.dtype == torch.int8 and tc.k_scale.shape == (2, 1, 4, 12)
    tok_j, tok_t = jnp.asarray(prompt), _t(prompt).long()
    for _ in range(4):
        jl, jc = jgen._apply_with_cache(jview, tok_j, jc, JCFG)
        tl, tc = gen._apply_with_cache(tview, tok_t, tc, CFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                                   atol=1e-5)
        nxt = int(np.argmax(np.asarray(jl)[0]))
        assert int(tl[0].argmax()) == nxt
        tok_j = jnp.asarray([[nxt]], jnp.int32)
        tok_t = torch.tensor([[nxt]])
    for a, b, sa, sb in ((tc.k, jc.k, tc.k_scale, jc.k_scale),
                         (tc.v, jc.v, tc.v_scale, jc.v_scale)):
        np.testing.assert_allclose(sa.numpy(), np.asarray(sb), rtol=1e-5)
        deq_t = a.float().numpy() * sa.numpy()[..., None]
        deq_j = np.asarray(b, np.float32) * np.asarray(sb)[..., None]
        assert np.all(np.abs(deq_t - deq_j)
                      <= np.asarray(sb)[..., None] * 1.0001)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_parity_probe_same_verdict(params, dtype):
    jparams, tparams = params
    jcfg = jgpt2.GPT2Config(vocab_size=233, n_positions=64, n_layer=2,
                            n_embd=32, n_head=4, dtype=getattr(jnp, dtype))
    tcfg = gpt2.GPT2Config(vocab_size=233, n_positions=64, n_layer=2,
                           n_embd=32, n_head=4, dtype=getattr(torch, dtype))
    verdict = jq8.kv_parity_probe(jgen._decode_view(jparams, jcfg), jcfg)
    report = q8.kv_parity_report(gen._decode_view(tparams, tcfg), tcfg)
    assert len(report) == 4
    assert q8.kv_parity_probe(gen._decode_view(tparams, tcfg), tcfg) \
        == verdict


def test_dtype_knobs_validate_and_size_like_jax():
    for kv, w in (("int4", "model"), ("model", "fp8")):
        with pytest.raises(ValueError) as jerr:
            jq8.validate_dtypes(kv, w)
        with pytest.raises(ValueError) as terr:
            q8.validate_dtypes(kv, w)
        assert str(terr.value) == str(jerr.value)
        with pytest.raises(ValueError):
            ServeConfig(kv_dtype=kv, weight_dtype=w)
    assert q8.resolve_kv_dtype("int8", CFG) == torch.int8
    assert q8.resolve_kv_dtype("model", CFG) == CFG.dtype
    full = gpt2.GPT2Config.from_name("gpt2")
    jfull = jgpt2.GPT2Config.from_name("gpt2")
    for jd, td in ((jnp.int8, torch.int8), (None, None),
                   (jnp.float32, torch.float32)):
        assert tkv.kv_bytes_per_token(full, td) \
            == jkv.kv_bytes_per_token(jfull, jd)
    pool = tkv.init_paged_pool(CFG, 5, 8, kv_dtype=torch.int8)
    assert pool.quantized and pool.k_scale.shape == (2, 6, 4, 8)
    assert pool.k_scale.data_ptr() != pool.v_scale.data_ptr()


def _traffic():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 233, 16).tolist()
    prompts = [rng.integers(0, 233, 12).tolist(), shared + [4, 9],
               rng.integers(0, 233, 20).tolist(), shared + [61]]
    return list(zip(prompts, [7, 6, 9, 5]))


@pytest.mark.parametrize("kv_dtype,weight_dtype", [("model", "int8"),
                                                   ("int8", "model"),
                                                   ("int8", "int8")])
def test_int8_engine_greedy_streams_match_jax(params, kv_dtype,
                                              weight_dtype):
    """The weight-only int8 tier, the int8 pool and both together: the
    port's greedy streams on both attention paths equal the JAX engine's."""
    jparams, tparams = params
    knobs = dict(kv_dtype=kv_dtype, weight_dtype=weight_dtype,
                 kv_parity_check=False)
    jengine = JEngine(jparams, JCFG, paged=True, attn_impl="jnp",
                      enable_monitor=False, **knobs, **ENGINE)
    for prompt, new in _traffic():
        jengine.submit(JRequest(prompt=prompt, max_new_tokens=new))
    ref = jengine.run_until_idle()
    for impl in ("kernel", "plain"):
        engine = ServingEngine(tparams, CFG, attn_impl=impl, device="cpu",
                               enable_monitor=False, **knobs, **ENGINE)
        for prompt, new in _traffic():
            engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
        got = engine.run_until_idle()
        summary = engine.metrics_summary()
        assert summary["kv_dtype"] == kv_dtype
        assert summary["weight_dtype"] == weight_dtype
        assert summary["prefix_hits"] >= 1
        assert {r: v.tokens for r, v in got.items()} \
            == {r: v.tokens for r, v in ref.items()}
        assert engine.scheduler.kv.quantized == (kv_dtype == "int8")


def test_parity_failure_falls_back_to_shrunk_model_pool(params,
                                                        monkeypatch):
    _, tparams = params
    monkeypatch.setattr(q8, "kv_parity_probe", lambda view, cfg: False)
    engine = ServingEngine(tparams, CFG, device="cpu", kv_dtype="int8",
                           **ENGINE)
    assert engine.kv_fallback_reason == "kv_parity_probe_failed"
    assert engine.kv_dtype == "model"
    assert not engine.scheduler.kv.quantized
    requested = 2 * (48 // 8)
    assert engine.scheduler.num_blocks == max(
        48 // 8, requested * tkv.kv_bytes_per_token(CFG, torch.int8)
        // tkv.kv_bytes_per_token(CFG))
    assert engine.metrics_summary()["kv_fallback_reason"] \
        == "kv_parity_probe_failed"
    monkeypatch.undo()
    ok = ServingEngine(tparams, CFG, device="cpu", kv_dtype="int8", **ENGINE)
    assert ok.kv_fallback_reason is None and ok.scheduler.kv.quantized
    assert ok.scheduler.chunk == 48          # whole-prompt prefill default
