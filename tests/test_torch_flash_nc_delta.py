"""The non-causal flash backward's Delta, now computed by the dq kernel
(``flash_attention_bwd_dq(..., o=, dlse=)`` returning (dq, Delta)),
against the JAX package's ``_flash_bwd(..., causal=False, dlse=)`` in
interpret mode, on the CPU in f32.

Inputs are made with numpy from a seed and fed to both packages, at
[2, 128, D] with D = 16 and 64 (two 64-row tiles each way), with and
without an lse cotangent.

* The plain twin (and the wrapper on CPU tensors) given JAX's own o and
  lse: dq, dk and dv within 2e-5 of ``_flash_bwd``'s kernels (f32; only
  the summation order differs), Delta within 2e-5 of JAX's Delta_eff =
  sum(dO * O) - dlse.
* The whole non-causal backward through autograd, ``flash_chunk``'s under
  (dO, dlse) and ``flash_attention(causal=False)``'s under dO alone,
  against ``_flash_bwd`` on JAX's forward: within 1e-4 (the port's own
  forward, then three chained products).
* The wrapper's contract: Delta from the caller when causal, o when not.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.torchport

jfa = importlib.import_module("trustworthy_dl_tpu.ops.flash_attention")

BH, T = 2, 128
TILE = 64
ATOL = 2e-5
GRAD_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _inputs(d, seed, with_dlse):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((BH, T, d)).astype(np.float32)
                   for _ in range(4))
    dlse = (0.5 * rng.standard_normal((BH, T))).astype(np.float32) \
        if with_dlse else None
    return q, k, v, do, dlse


def _jax_backward(q, k, v, do, dlse):
    """JAX's forward and ``_flash_bwd`` at causal=False, interpret mode:
    (o, lse, dq, dk, dv, Delta_eff) as numpy."""
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    jo, jlse = jfa._flash_fwd(jq, jk, jv, False, TILE, TILE, True)
    jdlse = None if dlse is None else jnp.asarray(dlse)
    grads = jfa._flash_bwd(jq, jk, jv, jo, jlse, jdo, False, TILE, TILE,
                           True, dlse=jdlse)
    delta = np.sum(do * np.asarray(jo), axis=-1)
    if dlse is not None:
        delta = delta - dlse
    return (np.asarray(jo), np.asarray(jlse),
            *(np.asarray(g) for g in grads), delta)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_dq_twin_computes_delta_as_jax(d, with_dlse):
    q, k, v, do, dlse = _inputs(d, 20 + d, with_dlse)
    jo, jlse, jdq, jdk, jdv, jdelta = _jax_backward(q, k, v, do, dlse)
    tq, tk, tv, tdo, o, lse = (torch.from_numpy(np.array(a)) for a in
                               (q, k, v, do, jo, jlse))
    tdlse = None if dlse is None else torch.from_numpy(dlse)
    dq, delta = fa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, None, False, o,
                                      tdlse)
    np.testing.assert_allclose(delta.numpy(), jdelta, rtol=0, atol=ATOL)
    dk, dv = fa.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, False)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # The wrapper on CPU tensors keeps the kernel's contract.
    wdq, wdelta = fa.flash_attention_bwd_dq(tq, tk, tv, tdo, lse, None,
                                            False, o, tdlse)
    assert torch.equal(wdq, dq) and torch.equal(wdelta, delta)


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("d", [16, 64])
def test_whole_non_causal_backward_matches_jax(d, with_dlse):
    q, k, v, do, dlse = _inputs(d, 40 + d, with_dlse)
    _, _, jdq, jdk, jdv, _ = _jax_backward(q, k, v, do, dlse)
    targs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    if with_dlse:
        o, lse = fa.flash_chunk(*targs, False)
        grads = torch.autograd.grad((o, lse), targs, (
            torch.from_numpy(do), torch.from_numpy(dlse)))
    else:
        o = fa.flash_attention(*targs, causal=False)
        grads = torch.autograd.grad(o, targs, torch.from_numpy(do))
    for got, want in zip(grads, (jdq, jdk, jdv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_ATOL)


def test_dq_wrapper_takes_delta_when_causal_and_o_when_not():
    q, k, v, do, dlse = (torch.from_numpy(np.array(a)) if a is not None
                         else None for a in _inputs(16, 60, True))
    o, lse = fa.flash_attention_fwd(q, k, v, False)
    delta = fa.row_delta(do, o, dlse)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, False)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, None, True, o)
    with pytest.raises(ValueError):
        fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True, None, dlse)
    with pytest.raises(ValueError):
        fa.flash_bwd_dq_plain(q, k, v, do, lse, None, False)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True)
    assert torch.equal(dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                 True))
