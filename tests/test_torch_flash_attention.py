"""The port's flash attention (B2/B3 plain twins behind the autograd
Function) against the JAX package's Pallas kernels in interpret mode, on
the CPU in f32, and the ``auto`` dispatch predicate.

Inputs are made with numpy from a seed and fed to both packages.

Tolerances: o within 2e-5 and lse within 1e-5 of the JAX forward kernel
(f32, only the summation order differs: one softmax over the row against
the kernel's online rescaling across key tiles); dq, dk, dv within 1e-4 of
``jax.grad`` through the JAX kernels (three chained products).  The bf16
backward twins against ``_flash_bwd``'s two kernels given the same bf16
inputs, o and lse: atol 2e-3 + rtol 2^-7, the card's kernel-vs-twin
tolerance (both round P and dS to bf16 before the same products; only the
f32 summation order differs), so a kernel held to the twin on the card is
held to the JAX kernels too.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torchport

# The JAX ops package re-exports the function under the module's name.
jfa = importlib.import_module("trustworthy_dl_tpu.ops.flash_attention")

SHAPES = [(2, 2, 128, 16), (1, 2, 192, 32)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_twin_matches_pallas_kernel(shape):
    b, h, t, d = shape
    q, k, v, _ = _qkv(shape, 1)
    bq, bk = jfa._blocks_for(t)
    merge = lambda a: a.reshape(b * h, t, d)  # noqa: E731
    o_ref, lse_ref = jfa._flash_fwd(*(jnp.asarray(merge(a)) for a in
                                      (q, k, v)), True, bq, bk, True)
    o, lse = fa.flash_attention_fwd(*(torch.from_numpy(merge(a)) for a in
                                      (q, k, v)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_matches_jax_grad_through_pallas(shape):
    q, k, v, w = _qkv(shape, 2)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v) * w)

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("bh,t,d", [(2, 128, 16), (2, 192, 64)])
def test_bf16_backward_twins_match_pallas_kernels(bh, t, d):
    rng = np.random.default_rng(3)
    # bf16 values, rounded once by torch and handed to both packages.
    q, k, v, do = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    as_jax = lambda a: jnp.asarray(a.float().numpy()).astype(  # noqa: E731
        jnp.bfloat16)
    jq, jk, jv, jdo = (as_jax(a) for a in (q, k, v, do))
    bq, bk = jfa._blocks_for(t)
    jo, jlse = jfa._flash_fwd(jq, jk, jv, True, bq, bk, True)
    ref = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, True, bq, bk, True)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    lse = torch.from_numpy(np.array(jlse))
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    for got, want in zip((dq, dk, dv), ref):
        want = torch.from_numpy(np.array(want.astype(jnp.float32)))
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, atol=2e-3,
                                   rtol=2.0 ** -7)


def test_auto_predicate_around_the_threshold():
    assert gpt2.AUTO_FLASH_MIN_T == jgpt2.AUTO_FLASH_MIN_T == 1024
    bf16 = torch.bfloat16
    assert not gpt2.auto_picks_flash(960, 64, bf16)
    assert not gpt2.auto_picks_flash(1023, 64, bf16)
    assert gpt2.auto_picks_flash(1024, 64, bf16)
    assert gpt2.auto_picks_flash(2048, 128, bf16)
    # Shapes or dtypes the kernels do not take stay on full attention.
    assert not gpt2.auto_picks_flash(1024 + 32, 64, bf16)
    assert not gpt2.auto_picks_flash(1024, 80, bf16)
    assert not gpt2.auto_picks_flash(1024, 64, torch.float32)
    # The JAX shape rule agrees on both sides of the threshold.
    for t in (1023, 1024):
        assert (t >= jgpt2.AUTO_FLASH_MIN_T and jfa.supports_flash(t, 64)) \
            == gpt2.auto_picks_flash(t, 64, bf16)


def test_explicit_flash_on_an_untaken_shape_raises():
    x = torch.zeros(1, 2, 96, 16)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x)
    with pytest.raises(ValueError):
        fa.flash_attention(x, x, x, causal=False)


def test_model_flash_path_matches_full_path():
    cfg_full = gpt2.GPT2Config(vocab_size=223, n_positions=64, n_layer=2,
                               n_embd=64, n_head=4, dtype=torch.float32,
                               attn_impl="full")
    cfg_flash = gpt2.GPT2Config(**{**cfg_full.__dict__,
                                   "attn_impl": "flash"})
    params = gpt2.init_params(cfg_full, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 223, size=(2, 64)))
    np.testing.assert_allclose(
        gpt2.forward(params, tokens, cfg_flash).numpy(),
        gpt2.forward(params, tokens, cfg_full).numpy(), rtol=0, atol=2e-5)
