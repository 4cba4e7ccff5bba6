"""The port's non-causal flash attention (B2/B3 at ``causal=False``) and
``flash_chunk`` against the JAX package's Pallas kernels in interpret
mode, on the CPU in f32.

Inputs are made with numpy from a seed and fed to both packages.

* The plain twins against JAX's ``_flash_fwd`` and ``_flash_bwd`` at
  [2, 128, 16] with 64-row tiles (two tiles each way, so the kernels'
  online rescaling runs), causal and not, given the same o, lse and Delta
  on the backward side (the non-causal dq computing Delta from o): o,
  lse, dq, dk and dv within 2e-5 (f32; only the summation order differs).
* ``flash_chunk`` against JAX's ``flash_chunk``: (o, lse) within 2e-5, and
  the VJP under nonzero (dO, dlse) cotangents within 1e-4 (the lse
  cotangent folded into Delta on both sides, then three chained
  products), causal and not.
* ``flash_attention(causal=False)`` through its autograd Function against
  the model's full attention at ``causal=False`` (1e-4).
* On the CPU no wrapper counts a launch; an untaken shape raises.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu_torch import ops
from trustworthy_dl_tpu_torch.models import gpt2
from trustworthy_dl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torchport

jfa = importlib.import_module("trustworthy_dl_tpu.ops.flash_attention")

BH, T, D = 2, 128, 16
TILE = 64          # bq = bk: two query and two key tiles on the JAX side
ATOL = 2e-5
GRAD_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _arrays(n, seed, shape=(BH, T, D), scale=1.0):
    rng = np.random.default_rng(seed)
    return [(scale * rng.standard_normal(shape)).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
def test_twins_match_pallas_kernels(causal):
    q, k, v, do = _arrays(4, 7)
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, causal, TILE, TILE, True)
    jdq, jdk, jdv = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, causal, TILE,
                                   TILE, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=ATOL)
    # The backward twins from JAX's own o and lse, as the kernels get them.
    # Not causal, dq takes o and returns its own Delta beside dq.
    o, lse = torch.from_numpy(np.array(jo)), torch.from_numpy(np.array(jlse))
    delta = (tdo * o).sum(-1)
    if causal:
        dq = fa.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, delta, causal)
    else:
        dq, own = fa.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, None,
                                            causal, o)
        torch.testing.assert_close(own, delta, atol=ATOL, rtol=0)
    dk, dv = fa.flash_attention_bwd_dkv(tq, tk, tv, tdo, lse, delta, causal)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_chunk_forward_and_vjp_match_jax(causal):
    q, k, v, do = _arrays(4, 8)
    (dlse,) = _arrays(1, 9, shape=(BH, T), scale=0.5)
    jargs = tuple(jnp.asarray(a) for a in (q, k, v))
    (jo, jlse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_chunk(a, b, c, causal, TILE, TILE), *jargs)
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, lse = fa.flash_chunk(*targs, causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=0, atol=ATOL)
    grads = torch.autograd.grad((o, lse), targs, (torch.from_numpy(do),
                                                  torch.from_numpy(dlse)))
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=GRAD_ATOL)
    # The lse cotangent matters: without it the gradients differ.
    plain = torch.autograd.grad(fa.flash_chunk(*targs, causal)[0], targs,
                                torch.from_numpy(do))
    assert max(float((a - b).abs().max())
               for a, b in zip(plain, grads)) > 10 * GRAD_ATOL


def test_non_causal_attention_matches_full_attention():
    q, k, v, w = _arrays(4, 10, shape=(1, 2, T, D))
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    ref_in = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*targs, causal=False)
    ref = gpt2.full_attention(*ref_in, causal=False)
    torch.testing.assert_close(out, ref, atol=GRAD_ATOL, rtol=0)
    weight = torch.from_numpy(w)
    got = torch.autograd.grad((out * weight).sum(), targs)
    want = torch.autograd.grad((ref * weight).sum(), ref_in)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=GRAD_ATOL, rtol=0)
    # Not causal in fact: the first query sees the last key.
    causal = fa.flash_attention(*targs, causal=True).detach()
    assert float((causal[..., 0, :] - out.detach()[..., 0, :]).abs().max()) \
        > 1e-2


def test_cpu_launches_nothing_and_untaken_shapes_raise():
    ops.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _arrays(3, 11))
    fa.flash_chunk(q, k, v, False)
    fa.flash_attention_fwd(q, k, v, False)
    counts = ops.launch_counts()
    assert counts["flash_attention_fwd"] == 0
    assert counts["flash_attention_fwd_full"] == 0
    assert {"flash_attention_bwd_dq_full",
            "flash_attention_bwd_dkv_full"} <= set(counts)
    odd = torch.zeros(2, 96, 16)
    with pytest.raises(ValueError):
        fa.flash_chunk(odd, odd, odd, False)
    with pytest.raises(ValueError):
        fa.flash_chunk(q[..., :8], k[..., :8], v[..., :8], True)
