"""The port's CUDA kernels (B5 decode, B6 prefill, B7 trust epilogue; B1
moment battery; B2/B3 flash attention forward and backward) against their
plain PyTorch twins, on the card, and the detector baseline's tensors
following the card.

These need an NVIDIA card and skip without one.  Run them there with
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``
(``tests/conftest.py`` sets up JAX, which the card does not need).

Tolerances: f32 outputs within 2e-5 (the kernels accumulate in f32 in
another order than the plain einsum); bf16 outputs within one bf16 step
of each other (rtol 2^-7) plus atol 2e-3, a few steps at the outputs'
size (weighted means of unit-normal V rows, mostly well under 1); the
margin exactly equal, the entropy within 1e-4 (one f32 pass over up to
50257 terms).
"""

import numpy as np
import pytest
import torch

from trustworthy_dl_tpu_torch.ops import flash_attention as fa
from trustworthy_dl_tpu_torch.ops import fused_stats as fs
from trustworthy_dl_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.torchport


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pools(rng, nb, h, bsz, dh, dtype, device):
    def mk(shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32
                            ).to(device=device, dtype=dtype)
    return mk((nb, h, bsz, dh)), mk((nb, h, bsz, dh)), mk


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 2e-3, 2.0**-7)])
@pytest.mark.parametrize("bsz,dh", [(8, 16), (16, 64)])
def test_decode_kernel_matches_plain(cuda, dtype, atol, rtol, bsz, dh):
    rng = np.random.default_rng(0)
    nb, h, r, nbps = 40, 3, 4, 8
    pk, pv, mk = _pools(rng, nb, h, bsz, dh, dtype, cuda)
    table = torch.tensor(rng.integers(0, nb, size=(r, nbps)),
                         dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 5, 13, nbps * bsz - 8], dtype=torch.int32,
                         device=cuda)
    for t in (1, 3, 8):
        q = mk((r, h, t, dh))
        before = pa.paged_attention.launches
        got = pa.paged_attention(q, pk, pv, table, start)
        torch.cuda.synchronize()
        assert pa.paged_attention.launches == before + 1
        ref = pa.paged_attention_plain(q, pk, pv, table, start)
        torch.testing.assert_close(got.float(), ref.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 2e-3, 2.0**-7)])
@pytest.mark.parametrize("t,start", [(20, 12), (64, 128), (64, 448)])
def test_prefill_kernel_matches_plain(cuda, dtype, atol, rtol, t, start):
    rng = np.random.default_rng(1)
    nb, h, bsz, dh, nbps = 80, 2, 16, 64, 32
    pk, pv, mk = _pools(rng, nb, h, bsz, dh, dtype, cuda)
    table = torch.tensor(rng.permutation(nb)[:nbps][None], dtype=torch.int32,
                         device=cuda)
    q = mk((1, h, t, dh))
    got = pa.paged_prefill_attention(q, pk, pv, table, start)
    torch.cuda.synchronize()
    ref = pa.paged_prefill_attention_plain(q, pk, pv, table, start)
    # Rows past the table's end (start + t > nbps * bsz) are discarded by
    # the serve path; compare the rows inside it.
    keep = min(t, nbps * bsz - start)
    torch.testing.assert_close(got[:, :, :keep].float(),
                               ref[:, :, :keep].float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b,v", [(5, 700), (8, 50257)])
def test_trust_kernel_matches_plain(cuda, b, v):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, v)).astype(np.float32) * 3
    x[0, 17] = x[0, 650 % v] = x[0].max() + 1.0     # duplicated maximum
    logits = torch.tensor(x, device=cuda)
    ent, mar = pa.logit_trust_stats(logits)
    torch.cuda.synchronize()
    ent_ref, mar_ref = pa.logit_trust_stats_plain(logits)
    assert float(mar[0]) == 0.0
    assert torch.equal(mar, mar_ref)
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


def test_moments_kernel_matches_plain(cuda):
    """B1 over segments below, at and above one chunk, empty, misaligned,
    and holding +-inf / NaN; sums within 2e-5 of their magnitude sums (f32
    in another order), NaN where the twin has NaN; min / max / max|x|
    exact."""
    rng = np.random.default_rng(3)
    base = torch.tensor(rng.normal(size=200_003).astype(np.float32) * 0.1,
                        device=cuda)
    special = torch.tensor([1.0, float("inf"), -2.0, float("-inf")],
                           device=cuda)
    nan = torch.tensor([0.5, float("nan"), -0.5], device=cuda)
    segs = [base[:1], base[:65_536], base[1:98_305], base, base[:0],
            special, nan]
    before = fs.fused_moments.launches
    got = fs.fused_moments(segs)
    torch.cuda.synchronize()
    assert fs.fused_moments.launches == before + 1
    ref = fs.fused_moments_plain(segs)
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    # Each sum within 2e-5 of its magnitude sum (sum |x|^p): the f32
    # rounding of a sum taken in another order.
    mag = torch.stack([torch.stack([a.sum(), (a ** 2).sum(), (a ** 3).sum(),
                                    (a ** 4).sum(), a.sum()])
                       for a in (s.abs() for s in segs)])
    err = (got[:, sums] - ref[:, sums]).abs()
    finite = torch.isfinite(ref[:, sums])
    assert bool((err[finite] <= 2e-5 * mag[finite] + 1e-6).all())
    assert torch.equal(torch.isnan(got[:, sums]), torch.isnan(ref[:, sums]))
    exact = [fs.MIN, fs.MAX, fs.LINF]
    torch.testing.assert_close(got[:, exact], ref[:, exact], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("bh,t,d", [(3, 64, 16), (4, 192, 64),
                                    (2, 128, 128), (96, 1024, 64)])
def test_flash_kernels_match_plain(cuda, bh, t, d):
    """B2 and B3 (dq, dk/dv) in bf16 against their plain twins: within
    atol 2e-3 + rtol 2^-7; lse within 1e-3 (f32 over a bf16 product)."""
    gen = torch.Generator(device=cuda).manual_seed(4)

    def mk():
        return torch.randn(bh, t, d, device=cuda, generator=gen).to(
            torch.bfloat16)

    q, k, v, do = mk(), mk(), mk(), mk()
    counts = [fa.flash_attention_fwd.launches,
              fa.flash_attention_bwd_dq.launches,
              fa.flash_attention_bwd_dkv.launches]
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    assert [fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dkv.launches] == [c + 1 for c in counts]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-3,
                               rtol=2.0 ** -7)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    for got, ref in ((dq, fa.flash_bwd_dq_plain(q, k, v, do, lse, delta)),
                     *zip((dk, dv), fa.flash_bwd_dkv_plain(q, k, v, do, lse,
                                                           delta))):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                                   rtol=2.0 ** -7)


def test_flash_autograd_matches_full_attention(cuda):
    """Through the autograd Function: forward and gradients of a bf16
    [2, 3, 128, 32] attention against the model's full attention."""
    from trustworthy_dl_tpu_torch.models.gpt2 import full_attention

    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = [torch.randn(2, 3, 128, 32, device=cuda, generator=gen).to(
        torch.bfloat16).requires_grad_() for _ in range(3)]
    out = fa.flash_attention(*qkv)
    g = torch.randn_like(out)
    grads = torch.autograd.grad(out, qkv, g)
    ref_in = [a.detach().float().requires_grad_() for a in qkv]
    ref = full_attention(*ref_in)
    ref_grads = torch.autograd.grad(ref, ref_in, g.float())
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a.float(), b, atol=3e-2, rtol=3e-2)


def test_baseline_follows_the_card(cuda):
    from trustworthy_dl_tpu_torch.detect import baseline as bl

    state = bl.init_baseline_state(3, 4, 2, device=cuda)
    # One stat vector per step for every node except node 1 on the first.
    assert state.ring.device.type == "cuda"
    assert state.count.device.type == "cuda"
    state = bl.push_stats(state, torch.ones(3, 2, device=cuda),
                          mask=torch.tensor([True, False, True],
                                            device=cuda))
    state = bl.push_stats(state, torch.full((3, 2), 3.0, device=cuda))
    mean, std, valid = bl.baseline_moments(state)
    assert mean.device.type == "cuda" and valid.device.type == "cuda"
    assert valid.tolist() == [2, 1, 2]
    assert mean[:, 0].tolist() == [2.0, 3.0, 2.0]


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 1, 16, dtype=torch.float16, device=cuda)
    pool = torch.zeros(3, 2, 8, 16, dtype=torch.float16, device=cuda)
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, table, 0)
    with pytest.raises(ValueError):
        pa.logit_trust_stats(torch.zeros(2, 9, dtype=torch.bfloat16,
                                         device=cuda))
    with pytest.raises(ValueError):
        fs.fused_moments([torch.zeros(8, dtype=torch.bfloat16, device=cuda)])
    f32 = torch.zeros(2, 64, 64, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(f32, f32, f32)
    odd = torch.zeros(2, 96, 64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(odd, odd, odd)
