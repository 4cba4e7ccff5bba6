"""The port's vocab-chunked fused head (``ops/fused_ce.py``) against the
JAX package's on the CPU, and the GPT-2 head that dispatches to it.

Vocab 100, so every chunk width tried (16, 32, 64, 128) leaves a ragged
or padded last block; chunk 16 and GPT-2's vocab at chunk 32 are widths
below the 64-row padding, where a block starting past the vocab would let
padded columns into the softmax.  Tolerances:
  * f32 compute: loss within 1e-5, dx and dW within 1e-5 of their max
    |value| (measured: loss within 5e-7, grads within 6e-7 of their max);
  * bf16 compute: loss within 1e-4, dx and dW within 2^-7 of their max
    |value| (a one-ulp difference in ``probs`` may flip the bf16 rounding
    of one ``dlogits`` entry; measured: loss within 5e-7, grads within
    4e-7);
  * accuracy exactly equal (the same argmax over the same f32 logits);
  * GPT-2's loss, features, mean logits and every gradient (``wte``'s
    sums the fused head's dW and the embedding lookup's) within 1e-5 in
    f32, through the fused head and through the materialised one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu.ops import fused_ce as jfused
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models import layers as L
from trustworthy_dl_tpu_torch.ops import fused_ce
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=100, n_positions=32)
B, T, D, V = 4, 16, 32, 100
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-4, 2.0 ** -7)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _inputs(seed=0, n=B * T, vocab=V, w_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n // T, T, D)).astype(np.float32)
    w = (rng.standard_normal((vocab, D)) * w_scale).astype(np.float32)
    t = rng.integers(0, vocab, (n // T, T))
    # A quarter of the rows aim at their own argmax, so accuracy is not 0.
    logits = x.reshape(-1, D) @ w.T
    hit = rng.random(n) < 0.25
    t.reshape(-1)[hit] = logits.argmax(-1)[hit]
    return x, w, t


def _assert_rel(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, f"{what}: {err} of max |value|"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("chunk", [16, 32, 64, 128])
def test_fused_loss_and_eval_match_jax(chunk, dtype):
    _check_against_jax(_inputs(), chunk, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gpt2_vocab_at_a_chunk_below_the_padding_matches_jax(dtype):
    """V = 50257 at chunk 32: the weight is padded to 50304 rows, and the
    block walk must stop at the vocab (the last block starts at 50240).
    The weight at GPT-2's init scale keeps the logits near 0, so 17
    padded columns let into the softmax would move the loss by ~3e-4."""
    _check_against_jax(_inputs(3, n=T, vocab=50257, w_scale=0.02), 32,
                       dtype)


def _check_against_jax(inputs, chunk, dtype):
    tdt, jdt, loss_tol, grad_tol = DTYPES[dtype]
    x, w, t = inputs
    jl, (jdx, jdw) = jax.value_and_grad(
        lambda a, b: jfused.fused_lm_loss(a, b, jnp.asarray(t), chunk, jdt),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    loss = fused_ce.fused_lm_loss(xt, wt, torch.from_numpy(t), chunk, tdt)
    dx, dw = torch.autograd.grad(loss, (xt, wt))
    assert dx.dtype == dw.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jl)) <= loss_tol
    _assert_rel(dx, jdx, grad_tol, "dx")
    _assert_rel(dw, jdw, grad_tol, "dW")

    jel, jacc = jfused.fused_lm_eval(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(t), chunk, jdt)
    el, acc = fused_ce.fused_lm_eval(torch.from_numpy(x),
                                     torch.from_numpy(w),
                                     torch.from_numpy(t), chunk, tdt)
    assert abs(float(el) - float(jel)) <= loss_tol
    assert float(acc) == float(jacc) > 0
    assert abs(float(el) - float(loss.detach())) <= 1e-6


@pytest.mark.parametrize("chunk", [32, 128])
def test_fused_matches_the_materialised_cross_entropy(chunk):
    """f32: the fused loss, eval and gradients against the port's own
    materialised CE and accuracy on the same inputs."""
    x, w, t = _inputs(1)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    ref = L.cross_entropy_loss(xt @ wt.T, torch.from_numpy(t))
    g_ref = torch.autograd.grad(ref, (xt, wt))
    got = fused_ce.fused_lm_loss(xt, wt, torch.from_numpy(t), chunk,
                                 torch.float32)
    g_got = torch.autograd.grad(got, (xt, wt))
    assert abs(float(got.detach()) - float(ref.detach())) <= 1e-5
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    loss, acc = fused_ce.fused_lm_eval(xt.detach(), wt.detach(),
                                       torch.from_numpy(t), chunk,
                                       torch.float32)
    logits = (xt @ wt.T).detach()
    assert abs(float(loss) - float(ref.detach())) <= 1e-5
    assert float(acc) == float(L.accuracy(logits, torch.from_numpy(t)))


def test_calls_are_counted_where_the_head_runs():
    x, w, t = _inputs(2)
    fused_ce.reset_calls()
    xt = torch.from_numpy(x).requires_grad_()
    loss = fused_ce.fused_lm_loss(xt, torch.from_numpy(w),
                                  torch.from_numpy(t), 32, torch.float32)
    assert fused_ce.CALLS == {"forward": 1, "backward": 0, "eval": 0}
    loss.backward()
    fused_ce.fused_lm_eval(xt.detach(), torch.from_numpy(w),
                           torch.from_numpy(t), 32, torch.float32)
    assert fused_ce.CALLS == {"forward": 1, "backward": 1, "eval": 1}
    fused_ce.reset_calls()
    assert set(fused_ce.CALLS.values()) == {0}


@pytest.fixture(scope="module")
def model():
    jparams = jcreate_model("gpt2", dtype=jnp.float32, seq_len=T,
                            **TINY).init(jax.random.PRNGKey(0))
    tparams = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))
    return jparams, tparams


@pytest.mark.parametrize("chunk", [0, 32])
def test_head_loss_and_signature_matches_jax(model, chunk):
    """GPT-2's monitored loss through the fused head (chunk 32) and the
    materialised one (0): loss, features, mean logits and every gradient
    against JAX's, ``wte``'s included."""
    jparams, tparams = model
    jcfg = jgpt2.GPT2Config(dtype=jnp.float32, lm_head_chunk=chunk, **TINY)
    cfg = gpt2.GPT2Config(dtype=torch.float32, lm_head_chunk=chunk, **TINY)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, V, (B, T + 1))
    x, y = toks[:, :-1], toks[:, 1:]

    def jloss(p):
        loss, feats, ml = jgpt2.loss_with_monitor(
            p, {"input": jnp.asarray(x), "target": jnp.asarray(y)}, jcfg)
        return loss, (feats, ml)

    (jl, (jf, jml)), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [p.clone().requires_grad_() for p in tree_leaves(tparams)]
    params = tree_unflatten(tparams, leaves)
    fused_ce.reset_calls()
    loss, feats, ml = gpt2.loss_with_monitor(
        params, {"input": torch.from_numpy(x),
                 "target": torch.from_numpy(y)}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    assert fused_ce.CALLS["forward"] == fused_ce.CALLS["backward"] == \
        (1 if chunk else 0)
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    for a, b in ((feats, jf), (ml, jml)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("tokens,chunk", [(10_682, 0), (10_683, 8192)])
def test_auto_predicate_at_its_boundary(tokens, chunk):
    """GPT-2's vocab in bf16: 10,682 tokens a node materialise (just
    under 1 GiB of logits), 10,683 take the fused head at 8192 columns,
    as in the JAX package."""
    cfg = gpt2.GPT2Config()
    jcfg = jgpt2.GPT2Config()
    assert gpt2.resolve_lm_head_chunk(cfg, tokens) == chunk
    assert jgpt2.resolve_lm_head_chunk(jcfg, tokens) == chunk
    assert fused_ce.DEFAULT_CHUNK == jfused.DEFAULT_CHUNK == 8192
    assert gpt2.resolve_lm_head_chunk(
        gpt2.GPT2Config(lm_head_chunk=0), tokens) == 0
    assert gpt2.resolve_lm_head_chunk(
        gpt2.GPT2Config(lm_head_chunk=512), tokens) == 512
