"""The port's serving kernels' plain versions (trustworthy_dl_tpu_torch/
ops/paged_attention.py) against the JAX Pallas kernels run in interpret
mode, on the same numpy inputs, and the paged generation path against
the JAX one.

Tolerances: attention outputs in f32 within rtol = atol = 2e-5 (the
interpret-mode kernel's online softmax and the plain full softmax sum in
different orders); the trust margin exactly equal (max/min only), the
entropy within 1e-5.  On CPU tensors no kernel launches, so every launch
counter stays 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import generate as jgen
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.ops import paged_attention as jpa
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models import generate as gen
from trustworthy_dl_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.torchport


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    pa.reset_launch_counts()
    yield
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)


def _ragged_case(seed=0):
    rng = np.random.default_rng(seed)
    nb, h, bsz, dh, r, nbps = 9, 3, 8, 16, 4, 4
    pool_k = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    pool_v = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    table = rng.integers(0, nb, size=(r, nbps)).astype(np.int32)
    return rng, pool_k, pool_v, table


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("t", [1, 3, 8])
def test_decode_plain_matches_interpret_kernel_ragged(t):
    rng, pool_k, pool_v, table = _ragged_case()
    start = np.asarray([0, 5, 13, 30], np.int32)
    q = rng.normal(size=(4, 3, t, 16)).astype(np.float32)
    ref = jpa.paged_attention(jnp.asarray(q), jnp.asarray(pool_k),
                              jnp.asarray(pool_v), jnp.asarray(table),
                              jnp.asarray(start), interpret=True)
    got = pa.paged_attention(_t(q), _t(pool_k), _t(pool_v), _t(table),
                             _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_decode_plain_matches_interpret_kernel_scalar_start():
    rng, pool_k, pool_v, table = _ragged_case(1)
    q = rng.normal(size=(1, 3, 5, 16)).astype(np.float32)
    ref = jpa.paged_attention(jnp.asarray(q), jnp.asarray(pool_k),
                              jnp.asarray(pool_v), jnp.asarray(table[:1]),
                              jnp.asarray(8, jnp.int32), interpret=True)
    got = pa.paged_attention(_t(q), _t(pool_k), _t(pool_v), _t(table[:1]), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_prefill_plain_matches_interpret_kernel():
    """A T = 20 chunk starting mid-block (start 12): three query tiles,
    each with its own causal block bound."""
    rng = np.random.default_rng(2)
    nb, h, bsz, dh, nbps = 12, 2, 8, 16, 6
    pool_k = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    pool_v = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    table = rng.permutation(nb)[:nbps][None].astype(np.int32)
    q = rng.normal(size=(1, h, 20, dh)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table), jnp.asarray(12, jnp.int32), interpret=True)
    got = pa.paged_prefill_attention(_t(q), _t(pool_k), _t(pool_v),
                                     _t(table), 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bsz", [48, 128])
@pytest.mark.parametrize("t", [20, 70])
def test_prefill_plain_matches_interpret_kernel_at_large_blocks(bsz, t):
    """Block sizes the card's bf16 prefill takes and its old CUDA-core
    template did not (48 does not divide the kernel's 64-key stages; 128
    is past the template's shared memory at Dh = 64): a ragged chunk over
    three rows, one starting at 0, one mid-block, one whose last rows run
    past its 3-block table (both sides see the whole table there)."""
    rng = np.random.default_rng(14)
    nbps, h, dh, r = 3, 2, 16, 3
    cap = nbps * bsz
    nb = r * nbps + 1
    pool_k = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    pool_v = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    table = (rng.permutation(r * nbps) + 1).reshape(r, nbps).astype(np.int32)
    start = np.asarray([0, bsz + bsz // 2 - 3, cap - t + 5], np.int32)
    q = rng.normal(size=(r, h, t, dh)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(table), jnp.asarray(start), interpret=True)
    got = pa.paged_prefill_attention(_t(q), _t(pool_k), _t(pool_v),
                                     _t(table), _t(start))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_trust_plain_matches_interpret_kernel():
    """B = 5 rows, V = 700 (not a multiple of the TPU vocab tile), row 2
    with a duplicated maximum: margins exactly equal, entropy 1e-5."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(5, 700)) * 3).astype(np.float32)
    x[2, 17] = x[2, 650] = x[2].max() + 1.0
    x[4] *= 20.0                                  # a collapsed distribution
    ent_ref, mar_ref = jpa.logit_trust_stats(jnp.asarray(x), interpret=True)
    ent, mar = pa.logit_trust_stats(_t(x))
    np.testing.assert_array_equal(mar.numpy(), np.asarray(mar_ref))
    assert float(mar[2]) == 0.0
    np.testing.assert_allclose(ent.numpy(), np.asarray(ent_ref), rtol=0,
                               atol=1e-5)


def test_wrappers_reject_unsupported_devices():
    q = torch.zeros(1, 1, 1, 4, device="meta")
    table = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        pa.paged_attention(q, q, q, table, 0)
    with pytest.raises(ValueError):
        pa.logit_trust_stats(torch.zeros(2, 3, device="meta"))


# ---------------------------------------------------------------------------
# The paged generation path (models/generate.py), both attention paths,
# against the JAX gather path over the same seeded pools.
# ---------------------------------------------------------------------------

JCFG = jgpt2.GPT2Config(vocab_size=199, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=199, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)


@pytest.mark.parametrize("t,lengths", [(1, [1, 11, 26]), (12, [0, 8, 16])])
def test_apply_with_cache_paged_matches_jax(t, lengths):
    """Decode (T = 1, ragged lengths, history across a block boundary)
    and a 12-wide chunk (the prefill kernel's route): logits within
    2e-4 and pool writes within 1e-5 on both port paths."""
    rng = np.random.default_rng(4)
    jparams = jgpt2.init_params(jax.random.PRNGKey(1), JCFG)
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
    shape = (2, 13, 4, 8, 8)
    k0 = (rng.normal(size=shape) * 0.3).astype(np.float32)
    v0 = (rng.normal(size=shape) * 0.3).astype(np.float32)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                       np.int32)
    tokens = rng.integers(0, 199, size=(3, t)).astype(np.int32)
    start = np.asarray(lengths, np.int32)
    logits, jk, jv, _, _ = jgen._apply_with_cache_paged(
        jgen._decode_view(jparams, JCFG), jnp.asarray(tokens),
        jnp.asarray(k0), jnp.asarray(v0), None, None, jnp.asarray(table),
        jnp.asarray(start), JCFG, attn_impl="jnp")
    view = gen._decode_view(tparams, CFG)
    for impl in gen.ATTN_IMPLS:
        pk, pv = _t(k0.copy()), _t(v0.copy())
        got = gen._apply_with_cache_paged(view, _t(tokens).long(), pk, pv,
                                          _t(table), _t(start), CFG,
                                          attn_impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(pk.numpy(), np.asarray(jk), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# The int8 branches of B5/B6 and the fused verify tail (B8): plain twins
# against the JAX kernels in interpret mode, and the int8 paged path.
# ---------------------------------------------------------------------------


def _int8_pools(rng, nb, h, bsz, dh):
    from trustworthy_dl_tpu.quant import int8 as jq8

    k = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    v = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
    kq, ks = jq8.quantize_kv(jnp.asarray(k))
    vq, vs = jq8.quantize_kv(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


@pytest.mark.parametrize("t", [1, 5])
def test_int8_decode_plain_matches_interpret_kernel_ragged(t):
    rng = np.random.default_rng(5)
    kq, vq, ks, vs = _int8_pools(rng, 9, 3, 8, 16)
    table = rng.integers(0, 9, size=(4, 4)).astype(np.int32)
    start = np.asarray([0, 5, 13, 26], np.int32)
    q = rng.normal(size=(4, 3, t, 16)).astype(np.float32)
    ref = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kq),
                              jnp.asarray(vq), jnp.asarray(table),
                              jnp.asarray(start), k_scale=jnp.asarray(ks),
                              v_scale=jnp.asarray(vs), interpret=True)
    got = pa.paged_attention_int8(_t(q), _t(kq), _t(vq), _t(table),
                                  _t(start), _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("pool", ["model", "int8"])
@pytest.mark.parametrize("t,starts", [
    (1, [0, 7, 15, 31]),     # a one-key window; windows ending on a block
    (5, [3, 5, 12, 27]),     # across a block boundary; ending on one
    (8, [0, 1, 8, 24]),
])
def test_decode_plain_matches_interpret_kernel_at_window_edges(pool, t,
                                                               starts):
    """The window edges B5's split-K kernel meets on the card, over both
    pools: a one-key window (start 0, T = 1), windows whose last position
    is a block's last (7, 15, 31 at T = 1; 27 + 5 - 1 = 31), and T = 5 and
    8 windows across block boundaries, each query ending at its own key,
    8-position blocks, 4-block tables."""
    rng = np.random.default_rng(9)
    nb, h, bsz, dh = 9, 3, 8, 16
    if pool == "int8":
        kq, vq, ks, vs = _int8_pools(rng, nb, h, bsz, dh)
        jscales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tscales = (_t(ks), _t(vs))
        wrapper = pa.paged_attention_int8
    else:
        kq = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
        vq = rng.normal(size=(nb, h, bsz, dh)).astype(np.float32)
        jscales, tscales, wrapper = {}, (), pa.paged_attention
    table = rng.integers(0, nb, size=(4, 4)).astype(np.int32)
    start = np.asarray(starts, np.int32)
    q = rng.normal(size=(4, h, t, dh)).astype(np.float32)
    ref = jpa.paged_attention(jnp.asarray(q), jnp.asarray(kq),
                              jnp.asarray(vq), jnp.asarray(table),
                              jnp.asarray(start), interpret=True, **jscales)
    got = wrapper(_t(q), _t(kq), _t(vq), _t(table), _t(start), *tscales)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_int8_prefill_plain_matches_interpret_kernel_ragged():
    """Two rows of a T = 20 chunk starting mid-block (ragged starts 3 and
    12), three query tiles each."""
    rng = np.random.default_rng(6)
    kq, vq, ks, vs = _int8_pools(rng, 12, 2, 8, 16)
    table = np.stack([rng.permutation(12)[:6],
                      rng.permutation(12)[:6]]).astype(np.int32)
    start = np.asarray([3, 12], np.int32)
    q = rng.normal(size=(2, 2, 20, 16)).astype(np.float32)
    ref = jpa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(table),
        jnp.asarray(start), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        interpret=True)
    got = pa.paged_prefill_attention_int8(_t(q), _t(kq), _t(vq), _t(table),
                                          _t(start), _t(ks), _t(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_verify_tail_plain_matches_interpret_kernel(dtype):
    """B = 10 rows, odd V = 1001 (the TPU kernel pads its vocab tile), a
    duplicated maximum in row 3.  f32: logits within 1e-5, margin exactly
    top-2 of the logits, entropy within 1e-5.  bf16 (the rounding
    contract: the product rounds to bf16): logits within one bf16 step of
    the JAX ones (the f32 sums run in another order before the rounding),
    margins and entropies within those steps."""
    rng = np.random.default_rng(7)
    normed = rng.normal(size=(10, 32)).astype(np.float32)
    head = (rng.normal(size=(1001, 32)) * 0.3).astype(np.float32)
    head[1000] = head[17]
    normed[3] = head[17] * 30.0
    jt, tt = getattr(jnp, dtype), getattr(torch, dtype)
    jl, je, jm = jpa.fused_verify_tail(jnp.asarray(normed, jt),
                                       jnp.asarray(head, jt), interpret=True)
    tl, te, tm = pa.fused_verify_tail(_t(normed).to(tt), _t(head).to(tt))
    jl = np.asarray(jl)
    assert tl.dtype == torch.float32 and tl.shape == (10, 1001)
    step = np.abs(jl) * (2.0 ** -7 if dtype == "bfloat16" else 0.0) + 1e-5
    assert np.all(np.abs(tl.numpy() - jl) <= step)
    top2 = torch.topk(tl, 2, dim=-1).values
    assert torch.equal(tm, top2[:, 0] - top2[:, 1])
    assert float(tm[3]) == 0.0 and float(np.asarray(jm)[3]) == 0.0
    tol = 1e-5 if dtype == "float32" else 0.1
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=tol)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("t,lengths", [(1, [1, 11, 26]), (5, [0, 8, 19]),
                                       (12, [0, 8, 16])])
def test_apply_with_cache_paged_int8_matches_jax(t, lengths):
    """The int8 pool through both port paths against the JAX gather path:
    decode (T = 1), a verify-width window (T = 5, the decode kernel) and a
    12-wide chunk (the prefill kernel).  Logits within 2e-4; the written
    scales within 1e-5 and the int8 values within one step."""
    from trustworthy_dl_tpu.quant import int8 as jq8

    rng = np.random.default_rng(8)
    jparams = jgpt2.init_params(jax.random.PRNGKey(1), JCFG)
    tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             jparams))
    shape = (2, 13, 4, 8, 8)
    kq, ks = (np.asarray(a) for a in jq8.quantize_kv(jnp.asarray(
        (rng.normal(size=shape) * 0.3).astype(np.float32))))
    vq, vs = (np.asarray(a) for a in jq8.quantize_kv(jnp.asarray(
        (rng.normal(size=shape) * 0.3).astype(np.float32))))
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]],
                       np.int32)
    tokens = rng.integers(0, 199, size=(3, t)).astype(np.int32)
    start = np.asarray(lengths, np.int32)
    logits, jk, jv, jks, jvs = jgen._apply_with_cache_paged(
        jgen._decode_view(jparams, JCFG), jnp.asarray(tokens),
        jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(table), jnp.asarray(start), JCFG, attn_impl="jnp")
    view = gen._decode_view(tparams, CFG)
    for impl in gen.ATTN_IMPLS:
        pk, pv, pks, pvs = (_t(a.copy()) for a in (kq, vq, ks, vs))
        got = gen._apply_with_cache_paged(view, _t(tokens).long(), pk, pv,
                                          _t(table), _t(start), CFG,
                                          attn_impl=impl, pool_ks=pks,
                                          pool_vs=pvs)
        np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                   rtol=2e-4, atol=2e-4)
        for a, b, sa, sb in ((pk, jk, pks, jks), (pv, jv, pvs, jvs)):
            np.testing.assert_allclose(sa.numpy(), np.asarray(sb),
                                       rtol=1e-5, atol=1e-7)
            assert np.abs(a.numpy().astype(np.int32)
                          - np.asarray(b).astype(np.int32)).max() <= 1
