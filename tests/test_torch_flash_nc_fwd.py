"""The port's non-causal flash forward (B2 at ``causal=False``) against the
JAX package's Pallas forward in interpret mode, on the CPU in f32, at the
head widths where the card runs its wgmma kernel (D = 64 and 128).

Inputs are made with numpy from a seed and fed to both packages, at T =
192: three 64-row query and key tiles, an odd count, so the online
softmax rescales twice on the JAX side.  Two kinds of inputs:

* ``normal``: unit-normal q, k and v;
* ``rising``: the same with each key row k_s scaled by 1 + s / 64, so the
  scores' spread grows along the key axis and the running maximum of
  nearly every row moves on each key tile: the correction of the earlier
  tiles' sums is then not 1.

Each reaches the port through ``flash_attention_fwd(causal=False)`` (the
plain twin on CPU tensors, as the wrapper takes them there) and through
``flash_chunk``'s autograd Function, against JAX's ``_flash_fwd(...,
causal=False, ..., interpret=True)``: o and lse within 2e-5 (f32; only the
summation order differs).

``utils/flash_ab.tiled_fwd_reference``, which the card tests hold the
wgmma kernel to on rising keys at T = 1024, against the same JAX kernel
on bf16 inputs: o within the card's atol 2e-3 + rtol 2^-7 (both round P
to bf16 against the running max; the reference sums in f64, the kernel
in f32, so a P near a rounding boundary may round to the other side).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu_torch.ops import flash_attention as fa
from trustworthy_dl_tpu_torch.utils.flash_ab import tiled_fwd_reference

pytestmark = pytest.mark.torchport

jfa = importlib.import_module("trustworthy_dl_tpu.ops.flash_attention")

BH, T = 2, 192
TILE = 64
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _inputs(d, kind, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((BH, T, d)).astype(np.float32)
               for _ in range(3))
    if kind == "rising":
        k = k * (1.0 + np.arange(T, dtype=np.float32) / TILE)[:, None]
    return q, k, v


def _jax_forward(q, k, v):
    jo, jlse = jfa._flash_fwd(*(jnp.asarray(a) for a in (q, k, v)), False,
                              TILE, TILE, True)
    return np.asarray(jo), np.asarray(jlse)


@pytest.mark.parametrize("entry", ["flash_attention_fwd", "flash_chunk"])
@pytest.mark.parametrize("kind", ["normal", "rising"])
@pytest.mark.parametrize("d", [64, 128])
def test_non_causal_forward_matches_pallas_kernel(d, kind, entry):
    q, k, v = _inputs(d, kind, 20 + d)
    jo, jlse = _jax_forward(q, k, v)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if entry == "flash_chunk":
        o, lse = fa.flash_chunk(tq, tk, tv, False)
    else:
        o, lse = fa.flash_attention_fwd(tq, tk, tv, False)
    assert o.dtype == torch.float32 and lse.shape == (BH, T)
    np.testing.assert_allclose(o.detach().numpy(), jo, rtol=0, atol=ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), jlse, rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("d", [64, 128])
def test_rising_scores_move_the_running_max(d):
    """The ``rising`` inputs do what they are for: a row's largest score
    grows from one key tile to the next in 90% of the (row, tile) pairs
    (unit-normal keys: about half), and in every row at least
    once, so a kernel that dropped the correction of the earlier tiles'
    sums would show it."""
    q, k, v = _inputs(d, "rising", 20 + d)
    s = np.einsum("btd,bsd->bts", q, k) / np.sqrt(d)
    tile_max = s.reshape(BH, T, T // TILE, TILE).max(axis=-1)
    moves = np.diff(tile_max, axis=-1) > 0
    assert moves.mean() > 0.9 and bool(moves.any(axis=-1).all())
    # And the forward then differs from the unscaled keys' by far more
    # than the tolerance.
    plain = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in
                                     _inputs(d, "normal", 20 + d)), False)
    rising = fa.flash_attention_fwd(*(torch.from_numpy(a) for a in
                                      (q, k, v)), False)
    assert float((plain[1] - rising[1]).abs().min()) > 100 * ATOL


@pytest.mark.parametrize("d", [64, 128])
def test_tiled_reference_matches_pallas_kernel_in_bf16(d):
    q, k, v = (a.astype(jnp.bfloat16)
               for a in map(jnp.asarray, _inputs(d, "rising", 40 + d)))
    jo, _ = jfa._flash_fwd(q, k, v, False, TILE, TILE, True)
    tq, tk, tv = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (q, k, v))
    ref = tiled_fwd_reference(tq, tk, tv)
    got = torch.from_numpy(np.asarray(jo.astype(jnp.float32))).double()
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2.0 ** -7)
