"""Top-k / top-p sampling of the port's dense-cache ``generate()``
against the JAX package's, on the CPU; mirrors
``tests/test_generate.py``'s sampling tests.

* ``_exact_topk`` equals a full stable descending sort (values and
  indices) at JAX's shapes, ties included, and JAX's own ``_exact_topk``.
* The keep-sets equal JAX's ``_sample`` masks exactly, read from the
  logits JAX hands ``jax.random.categorical``: top-k (ties at the k-th
  value stay in), top-p, and both, at two temperatures.
* ``top_k=1`` and a vanishing ``top_p`` equal greedy, which equals JAX's
  greedy stream on the same converted f32 weights (vocab 251: a size no
  other test file uses, so this file's JAX programs are its own).
* The validation errors are JAX's; every top-k draw lies in the exact
  top-k and every nucleus draw in the nucleus; ``top_p=1`` draws the
  plain sampler's stream.  The draws themselves come from a
  ``torch.Generator``: JAX's PRNG stream is not reproduced.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models import generate as jgen
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models import generate as gen

pytestmark = pytest.mark.torchport

JCFG = jgpt2.GPT2Config(vocab_size=251, n_positions=48, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=251, n_positions=48, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(5), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


@pytest.mark.parametrize("b,v,k", [(1, 50257, 40), (2, 50257, 1),
                                   (3, 1000, 7), (1, 64, 40), (2, 317, 5),
                                   (1, 32 * 41, 40)])
def test_exact_topk_equals_a_full_sort_and_jax(b, v, k):
    rng = np.random.default_rng(v + k)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[:, ::5] = np.round(x[:, ::5], 1)          # many ties
    vals, idx = gen._exact_topk(torch.from_numpy(x), k)
    order = np.argsort(-x, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(x, order, axis=-1))
    jvals, jidx = jgen._exact_topk(jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


def _tied_logits(seed, k):
    """[4, 257] normal logits with three more entries per row set equal
    to the row's k-th largest value."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 257)).astype(np.float32)
    for row in x:
        order = np.argsort(-row, kind="stable")
        row[order[k + 3:k + 6]] = row[order[k - 1]]
    return x


def _jax_masked(monkeypatch, logits, temperature, top_k, top_p):
    """The logits JAX's ``_sample`` hands ``jax.random.categorical``."""
    seen = []

    def categorical(key, masked, axis=-1):
        seen.append(np.asarray(masked))
        return jnp.argmax(masked, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", categorical)
    jgen._sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                 jnp.float32(temperature), False, top_k,
                 jnp.float32(top_p), top_p < 1.0)
    monkeypatch.undo()
    return seen[0]


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_k,top_p", [(10, 1.0), (10, 0.9), (0, 0.9),
                                         (0, 0.5), (25, 0.3), (1, 0.99)])
def test_keep_sets_equal_jax(monkeypatch, temperature, top_k, top_p):
    k = top_k or 10
    logits = _tied_logits(top_k * 100 + int(top_p * 10), k)
    masked = _jax_masked(monkeypatch, logits, temperature, top_k, top_p)
    scaled = torch.from_numpy(logits) / temperature
    if top_k > 0 and top_p >= 1.0:
        # JAX's pure top-k path samples among the k candidates.
        vals, _ = gen._exact_topk(scaled, top_k)
        np.testing.assert_array_equal(vals.numpy(), masked)
        want = np.isfinite(gen._filter_logits(scaled, top_k, 1.0).numpy())
        assert (want.sum(axis=-1) == top_k + 3).all()     # ties kept
        return
    keep = np.isfinite(gen._filter_logits(scaled, top_k, top_p).numpy())
    np.testing.assert_array_equal(keep, np.isfinite(masked))
    if top_k > 0:
        assert (keep.sum(axis=-1) <= top_k + 3).all()


def test_top_k_1_and_a_vanishing_top_p_equal_greedy(params):
    jparams, tparams = params
    prompt = np.random.default_rng(4).integers(0, 251, (2, 6))
    greedy = gen.generate(tparams, CFG, torch.as_tensor(prompt), 5,
                          temperature=0.0)
    ref = jgen.generate(jparams, JCFG, jnp.asarray(prompt), 5,
                        temperature=0.0)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(ref))
    for kw in (dict(temperature=1.5, top_k=1),
               dict(temperature=1.0, top_p=1e-6)):
        out = gen.generate(tparams, CFG, torch.as_tensor(prompt), 5,
                           generator=torch.Generator().manual_seed(3), **kw)
        assert torch.equal(out, greedy), kw


def test_validation_errors_are_jaxs(params):
    jparams, tparams = params
    bad = [dict(max_new_tokens=2, temperature=1.0, top_k=500),
           dict(max_new_tokens=2, temperature=1.0, top_p=0.0),
           dict(max_new_tokens=2, temperature=1.0, top_p=1.5),
           dict(max_new_tokens=0),
           dict(max_new_tokens=46)]
    for kw in bad:
        with pytest.raises(ValueError):
            jgen.generate(jparams, JCFG, jnp.zeros((1, 4), jnp.int32), **kw)
        with pytest.raises(ValueError):
            gen.generate(tparams, CFG, torch.zeros(1, 4, dtype=torch.long),
                         **kw)


def test_top_k_draws_lie_in_the_exact_top_k():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((4, 257)).astype(
        np.float32))
    top10 = np.argsort(-logits.numpy(), axis=-1)[:, :10]
    for seed in range(10):
        tok = gen._sample(logits, 1.3, 10, 1.0,
                          torch.Generator().manual_seed(seed))
        for row in range(4):
            assert int(tok[row]) in top10[row]


def test_nucleus_draws_lie_in_the_nucleus_and_top_p_1_is_plain():
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(3 * rng.standard_normal((4, 257)).astype(
        np.float32))
    keep = torch.isfinite(gen._filter_logits(logits / 0.9, 0, 0.5))
    assert (keep.sum(dim=-1) < 257).all()
    for seed in range(10):
        tok = gen._sample(logits, 0.9, 0, 0.5,
                          torch.Generator().manual_seed(seed))
        assert keep.gather(1, tok[:, None]).all()
        plain = gen._sample(logits, 0.9, 0, 1.0,
                            torch.Generator().manual_seed(seed))
        want = torch.multinomial(torch.softmax(logits / 0.9, dim=-1), 1,
                                 generator=torch.Generator().manual_seed(
                                     seed))[:, 0]
        assert torch.equal(plain, want)


def test_sampled_streams_repeat_per_generator(params):
    _, tparams = params
    prompt = torch.as_tensor(np.random.default_rng(9).integers(0, 251,
                                                               (1, 4)))

    def run(seed, **kw):
        return gen.generate(tparams, CFG, prompt, 8, temperature=0.9,
                            generator=torch.Generator().manual_seed(seed),
                            **kw)

    for kw in (dict(top_k=5), dict(top_p=0.8), dict(top_k=20, top_p=0.7)):
        assert torch.equal(run(7, **kw), run(7, **kw))
        out = run(7, **kw)
        assert ((out >= 0) & (out < 251)).all()
