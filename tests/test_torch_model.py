"""The port's GPT-2 (trustworthy_dl_tpu_torch.models) against the JAX
package on the same converted weights, on the CPU in f32.

Tolerances: forward logits within 1e-5 (both packages compute in f32;
only the order of the sums differs); greedy ``generate()`` streams equal
token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.models.generate import generate as jgenerate
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.models.generate import generate

pytestmark = pytest.mark.torchport

# vocab 197: a size no other test file uses, so the JAX programs this file
# compiles are its own in the process-global jit cache.
JCFG = jgpt2.GPT2Config(vocab_size=197, n_positions=48, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=197, n_positions=48, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(3), JCFG)
    numpy_tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, convert.params_from_jax(numpy_tree)


def test_convert_keeps_layout_and_rejects_other_trees(params):
    jparams, tparams = params
    assert tparams["blocks"]["attn"]["qkv"]["w"].shape == (2, 32, 96)
    np.testing.assert_array_equal(tparams["wte"].numpy(),
                                  np.asarray(jparams["wte"]))
    with pytest.raises(ValueError):
        convert.params_from_jax({"wte": np.zeros((2, 2))})


def test_forward_matches_jax(params):
    jparams, tparams = params
    tokens = np.random.default_rng(0).integers(0, 197, size=(2, 11))
    ref = np.asarray(jgpt2.forward(jparams, jnp.asarray(tokens), JCFG))
    got = gpt2.forward(tparams, torch.as_tensor(tokens), CFG)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_greedy_generate_matches_jax(params):
    jparams, tparams = params
    prompt = np.random.default_rng(1).integers(0, 197, size=(2, 7))
    ref = np.asarray(jgenerate(jparams, JCFG, jnp.asarray(prompt), 12))
    got = generate(tparams, CFG, torch.as_tensor(prompt), 12)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sampled_generate_is_deterministic_per_seed(params):
    _, tparams = params
    prompt = torch.as_tensor(np.random.default_rng(2).integers(0, 197, (1, 5)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return generate(tparams, CFG, prompt, 10, temperature=0.9,
                        generator=g)

    assert torch.equal(run(7), run(7))


def test_init_params_shapes_and_scales():
    p = gpt2.init_params(CFG, torch.Generator().manual_seed(0))
    assert p["blocks"]["mlp"]["proj"]["w"].shape == (2, 128, 32)
    assert abs(float(p["wte"].std()) - 0.02) < 0.005
