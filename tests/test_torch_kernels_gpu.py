"""The port's CUDA kernels (B5 decode, B6 prefill, B7 trust epilogue)
against their plain PyTorch twins, on the card.

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


def test_wrappers_reject_what_kernels_do_not_take(cuda):
    q = torch.zeros(1, 2, 1, 16, dtype=torch.float16, device=cuda)
    pool = torch.zeros(3, 2, 8, 16, dtype=torch.float16, device=cuda)
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, table, 0)
    with pytest.raises(ValueError):
        pa.logit_trust_stats(torch.zeros(2, 9, dtype=torch.bfloat16,
                                         device=cuda))
