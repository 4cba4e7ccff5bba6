"""The port's CUDA kernels (B5 decode, B6 prefill, each over a bf16/f32 or
an int8 pool, B5's bf16-query split-K kernel at the edges of its spans,
B7 trust epilogue, B8 fused verify tail, B9 paged adapter delta; B4 int8
dequant matmul; B1 moment battery, also at ResNet-101's 3,344-segment
gradient mix in ceil(3344 / MAX_SEGMENTS) launches, the same bits over
two calls and a CUDA-graph replay, a NaN kept to its segment, and its
edges (+-inf, misaligned and empty segments, one and MAX_SEGMENTS + 1
segments, a call after calls of other counts); B2/B3 flash attention
forward and backward, causal and not (the non-causal instances also
through ``flash_chunk`` with an lse cotangent, and ring attention over
four positions of the card with its chunk launches counted; the
non-causal forward also with keys scaled by their index, and its kernel
named by the profiler: wgmma at D = 64 and 128); B2, B3, B7 and B8 also
run twice for the same bits;
B7 at odd V, one column and duplicated maxima across its CTAs' shares;
B8 100 times over poisoned scratch and on two streams at once)
against their plain PyTorch twins, on the card, the detector baseline's
tensors following the card, and the serving engine at the kernels' limits
(B8 past one launch's rows, B9 past its rank, an int8-KV engine past
B6-int8's head width, a bf16-pool engine past B5's and an f32 engine past
the CUDA-core kernel's shared memory refused at construction, a bf16
engine at 128-position blocks serving).  Also the vocab-chunked fused
head's card route (``ops/fused_ce.py``: bf16 operands, f32-accumulated
library products) against the same head on the CPU; NaN params (the chaos
drill's GRAD_NAN) through B1-B3 tripping the supervisor's guard as on the
CPU; and a checkpoint of a card trainer restored bit-exactly.

These need an NVIDIA card and skip without one.  Run them there with
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q``
(``tests/conftest.py`` sets up JAX, which the card does not need).

Tolerances: f32 outputs within 2e-5 (the kernels accumulate in f32 in
another order than the plain einsum); bf16 outputs within one bf16 step
of each other (rtol 2^-7) plus atol 2e-3, a few steps at the outputs'
size (weighted means of unit-normal V rows, mostly well under 1); the
margin exactly equal, the entropy within 1e-4 (one f32 pass over up to
50257 terms).  B4: within 1e-5 of sum |x| |w| scale over each output
(f32 summation order only: bf16 x int8 products are exact in f32).  B8:
logits within one bf16 step of the twin's plus that same f32 sum bound
(the same f32 sum in another order, each rounded to bf16: near zero the
order's f32 error is larger than a step of the value), the margin exactly
top-2 of the kernel's own logits.  B9: within 1e-5 of the plain output's
largest magnitude (f32 sums in another order), zero-page rows exactly 0.0.
"""

import numpy as np
import pytest
import torch

from trustworthy_dl_tpu_torch.ops import flash_attention as fa
from trustworthy_dl_tpu_torch.ops import fused_dequant_matmul as fdm
from trustworthy_dl_tpu_torch.ops import fused_stats as fs
from trustworthy_dl_tpu_torch.ops import paged_attention as pa
from trustworthy_dl_tpu_torch.quant import int8 as q8

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


@pytest.mark.parametrize("b,v", [(5, 700), (8, 50257), (1, 50257),
                                 (16, 50257), (9, 50257), (3, 37)])
def test_trust_kernel_matches_plain(cuda, b, v):
    """B7 at the serve path's decode tick (8 rows: clusters of 16) and a
    prompt's last chunk (1 row), past 8 rows (clusters of 8), and at odd V,
    where every other row starts off a 16-byte boundary; V = 37 is fewer
    16-byte vectors than a cluster has CTAs, so some shares are empty."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(b, v)).astype(np.float32) * 3
    x[0, 17] = x[0, 650 % v] = x[0].max() + 1.0     # duplicated maximum
    logits = torch.tensor(x, device=cuda)
    before = pa.logit_trust_stats.launches
    ent, mar = pa.logit_trust_stats(logits)
    torch.cuda.synchronize()
    assert pa.logit_trust_stats.launches == before + 1
    ent_ref, mar_ref = pa.logit_trust_stats_plain(logits)
    assert float(mar[0]) == 0.0
    assert torch.equal(mar, mar_ref)
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [1, 8, 16])
def test_trust_kernel_duplicated_maximum_across_slices(cuda, b):
    """Each row's maximum twice, in two CTAs' shares of the row: row 0 at
    its first and last columns (rank 0's scalar head or first vectors,
    the last rank's tail), row r > 0 six columns either side of the r-th
    sixteenth of the row (where shares meet, give or take the alignment
    head): margin 0, bit-equal to the plain version."""
    v = 50257
    rng = np.random.default_rng(21)
    x = rng.normal(size=(b, v)).astype(np.float32) * 3
    for r in range(b):
        cols = (0, v - 1) if r == 0 else \
            (v * ((r - 1) % 15 + 1) // 16 - 6, v * ((r - 1) % 15 + 1) // 16 + 6)
        x[r, list(cols)] = x[r].max() + 1.0
    logits = torch.tensor(x, device=cuda)
    ent, mar = pa.logit_trust_stats(logits)
    torch.cuda.synchronize()
    ent_ref, mar_ref = pa.logit_trust_stats_plain(logits)
    assert torch.equal(mar, torch.zeros_like(mar))
    assert torch.equal(mar, mar_ref)
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


def test_trust_kernel_single_column(cuda):
    """V = 1: one value a row (aligned, then off a 16-byte boundary), every
    CTA but one empty: entropy exactly 0 and the margin against the empty
    runner-up, x - NEG_INF in f32, as the JAX kernel's NEG_INF-padded tile
    gives (the plain version's top-2 needs two columns)."""
    logits = torch.tensor([[0.5], [-3.0], [7.25]], device=cuda)
    ent, mar = pa.logit_trust_stats(logits)
    torch.cuda.synchronize()
    assert torch.equal(ent, torch.zeros(3, device=cuda))
    assert torch.equal(mar, logits[:, 0] - torch.tensor(-1e30, device=cuda))


@pytest.mark.parametrize("b,v", [(1, 50257), (8, 50257), (5, 700)])
def test_trust_kernel_is_deterministic(cuda, b, v):
    """Two launches on the same logits give the same bits: every merge
    (lanes, warps, cluster ranks) runs in a fixed order, no atomics."""
    rng = np.random.default_rng(22)
    logits = torch.tensor(rng.normal(size=(b, v)).astype(np.float32) * 3,
                          device=cuda)
    first = pa.logit_trust_stats(logits)
    second = pa.logit_trust_stats(logits)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


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


def test_moments_kernel_at_resnet101_segment_mix(cuda):
    """B1 through the step's split (``engine.step._moments``, at most
    ``MAX_SEGMENTS`` segments a launch) over ResNet-101's 418 gradient
    leaves on each of 8 nodes: 3,344 segments in ceil(3344 /
    MAX_SEGMENTS) launches, against the plain twin: the sums within 2e-5
    of their magnitude sums with no absolute floor (at 1e-3 gradients a
    floor would swallow the short segments' S3 and S4), the extrema
    exact."""
    from trustworthy_dl_tpu_torch.engine.step import _moments
    from trustworthy_dl_tpu_torch.models.factory import create_model
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    gen = torch.Generator(device=cuda).manual_seed(5)
    shapes = [tuple(p.shape) for p in tree_leaves(
        create_model("resnet101").init(gen, cuda))]
    assert len(shapes) == 418
    grads = [torch.randn((8,) + s, device=cuda, generator=gen) * 1e-3
             for s in shapes]
    segs = [g[i].reshape(-1) for i in range(8) for g in grads]
    before = fs.fused_moments.launches
    got = _moments(segs)
    torch.cuda.synchronize()
    assert fs.fused_moments.launches == before + -(-3344
                                                  // fs.MAX_SEGMENTS)
    assert got.shape == (3344, 8)
    ref = fs.fused_moments_plain(segs)
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    mag = torch.stack([torch.stack([a.sum(), (a ** 2).sum(), (a ** 3).sum(),
                                    (a ** 4).sum(), a.sum()])
                       for a in (s.abs() for s in segs)])
    err = (got[:, sums] - ref[:, sums]).abs()
    assert bool((err <= 2e-5 * mag).all())
    exact = [fs.MIN, fs.MAX, fs.LINF]
    assert torch.equal(got[:, exact], ref[:, exact])


def _mix_segments(device, mix):
    """``utils/moments_ab``'s gradient segments of the ``gpt2`` (64
    segments, 497.8 M values) or ``resnet101`` (3,344 segments) mix."""
    from trustworthy_dl_tpu_torch.utils import moments_ab as mab

    (model, nodes), = [(m, n) for name, m, n in mab.MIXES if name == mix]
    return mab.mix_segments(mix, model, nodes, device)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _moments_close(got, segs):
    """Rows against the twin: sums within 2e-5 of their magnitude sums
    plus 1e-6, NaN where the twin has NaN, min / max / max|x| exact."""
    ref = fs.fused_moments_plain(segs)
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    mag = torch.stack([torch.stack([a.sum(), (a ** 2).sum(), (a ** 3).sum(),
                                    (a ** 4).sum(), a.sum()])
                       for a in (s.abs() for s in segs)])
    err = (got[:, sums] - ref[:, sums]).abs()
    finite = torch.isfinite(ref[:, sums])
    assert bool((err[finite] <= 2e-5 * mag[finite] + 1e-6).all())
    assert torch.equal(torch.isnan(got[:, sums]), torch.isnan(ref[:, sums]))
    assert torch.equal(torch.isinf(got[:, sums]), torch.isinf(ref[:, sums]))
    exact = [fs.MIN, fs.MAX, fs.LINF]
    torch.testing.assert_close(got[:, exact], ref[:, exact], rtol=0, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("mix", ["gpt2", "resnet101"])
def test_moments_kernel_bits_repeat_and_replay(cuda, mix):
    """B1 at the GPT-2 and ResNet-101 gradient mixes: two calls give the
    same bits, and so do two replays of the battery captured in a CUDA
    graph (the tickets are zeroed on the stream each call; no float
    atomics, the fold's order is fixed)."""
    from trustworthy_dl_tpu_torch.engine.step import _moments

    segs = _mix_segments(cuda, mix)
    first = _moments(segs)
    second = _moments(segs)
    torch.cuda.synchronize()
    assert torch.equal(_bits(first), _bits(second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _moments(segs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = _moments(segs)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(replayed), _bits(first))


def test_moments_kernel_nan_stays_in_its_segment(cuda):
    """A NaN in one multi-chunk segment makes that row's min, max and
    max|x| NaN and leaves every other row as the twin's."""
    rng = np.random.default_rng(31)
    segs = [torch.tensor(rng.normal(size=n).astype(np.float32), device=cuda)
            for n in (100_000, 5, 70_000, 1_000_000, 33)]
    segs[3][654_321] = float("nan")
    got = fs.fused_moments(segs)
    torch.cuda.synchronize()
    for row in range(len(segs)):
        ext = got[row, [fs.MIN, fs.MAX, fs.LINF]]
        assert bool(torch.isnan(ext).all()) == (row == 3)
    assert not bool(torch.isnan(got[[0, 1, 2, 4]]).any())
    _moments_close(got, segs)


def test_moments_kernel_edges(cuda):
    """+-inf without NaN (min -inf, max +inf), segments that start off a
    16-byte boundary (at every offset, across chunks), empty segments,
    and calls of 1, MAX_SEGMENTS and MAX_SEGMENTS + 1 segments (the last
    through ``_moments``: two launches; straight into the wrapper it is
    refused)."""
    from trustworthy_dl_tpu_torch.engine.step import _moments

    rng = np.random.default_rng(32)
    base = torch.tensor(rng.normal(size=300_011).astype(np.float32),
                        device=cuda)
    infs = base[:70_000].clone()
    infs[[5, 40_000]] = float("inf")
    infs[[7, 69_999]] = float("-inf")
    segs = [infs, base[:0], *(base[k:k + 65_541 + k] for k in range(4)),
            base[3:7], base[1:2], base[:0]]
    got = fs.fused_moments(segs)
    torch.cuda.synchronize()
    assert got[0, fs.MIN] == float("-inf") and got[0, fs.MAX] == float("inf")
    assert got[0, fs.LINF] == float("inf")
    empty = torch.tensor([0, 0, 0, 0, float("inf"), float("-inf"), 0, 0],
                         device=cuda)
    assert torch.equal(got[1], empty) and torch.equal(got[-1], empty)
    _moments_close(got, segs)

    one = fs.fused_moments([base])
    torch.cuda.synchronize()
    _moments_close(one, [base])
    sizes = rng.integers(0, 3000, fs.MAX_SEGMENTS + 1)
    sizes[::97] = 40_000
    many = [base[:int(n)] for n in sizes]
    full = fs.fused_moments(many[:fs.MAX_SEGMENTS])
    torch.cuda.synchronize()
    _moments_close(full, many[:fs.MAX_SEGMENTS])
    before = fs.fused_moments.launches
    split = _moments(many)
    torch.cuda.synchronize()
    assert fs.fused_moments.launches == before + 2
    assert torch.equal(_bits(split[:fs.MAX_SEGMENTS]), _bits(full))
    _moments_close(split, many)
    with pytest.raises(ValueError):
        fs.fused_moments(many)


def test_moments_kernel_call_after_other_count(cuda):
    """A call after calls of other segment counts (more segments, longer
    ones) gives the bits of the same call made first."""
    rng = np.random.default_rng(33)
    data = torch.tensor(rng.normal(size=2_000_000).astype(np.float32),
                        device=cuda)
    small = [data[:100_000], data[7:40_007], data[:3]]
    fresh = fs.fused_moments(small)
    torch.cuda.synchronize()
    big = [data[i * 1000:(i + 1) * 1000 + 70_000] for i in range(1500)]
    fs.fused_moments(big)
    fs.fused_moments([data])
    again = fs.fused_moments(small)
    torch.cuda.synchronize()
    assert torch.equal(_bits(fresh), _bits(again))


def _flash_inputs(device, bh, t, d, seed, rising=False):
    """q, k, v, dO bf16 [bh, t, d] from a seed; ``rising`` scales key row s
    by 1 + s / 64 (``utils/flash_ab.flash_inputs``)."""
    from trustworthy_dl_tpu_torch.utils.flash_ab import flash_inputs

    return flash_inputs(bh, t, d, seed, rising, device)


@pytest.mark.parametrize("bh,t,d", [(3, 64, 16), (2, 64, 32), (4, 192, 64),
                                    (2, 128, 128), (5, 320, 128),
                                    (96, 1024, 64), (3, 320, 16),
                                    (2, 1024, 128)])
def test_flash_kernels_match_plain(cuda, bh, t, d):
    """B2 and B3 (dq, dk/dv) in bf16 against their plain twins: within
    atol 2e-3 + rtol 2^-7; lse within 1e-3 (f32 over a bf16 product).
    Every D of ``HEAD_DIMS``, a single tile, odd tile counts (at the
    smallest and the largest D), and D = 128 at the train length."""
    q, k, v, do = _flash_inputs(cuda, bh, t, d, 4)
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


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,t,d", [(4, 192, 64), (2, 1024, 128)])
def test_flash_backward_kernels_are_deterministic(cuda, bh, t, d, causal):
    """dq and dk/dv take no atomics and each writes only its own rows:
    two calls on the same inputs give the same bits, causal and not (the
    non-causal dq's Delta, computed under an lse cotangent, too)."""
    q, k, v, do = _flash_inputs(cuda, bh, t, d, 6)
    o, lse = fa.flash_attention_fwd(q, k, v, causal)
    gen = torch.Generator(device=cuda).manual_seed(7)
    dlse = 0.5 * torch.randn(bh, t, device=cuda, generator=gen)

    def backward():
        if causal:
            delta = (do.float() * o.float()).sum(-1)
            dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta)
        else:
            dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None,
                                                  False, o, dlse)
        return (dq, delta, *fa.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                       delta, causal))

    first, second = backward(), backward()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bh,t,d", [(4, 192, 64), (2, 1024, 128)])
def test_flash_forward_kernels_are_deterministic(cuda, bh, t, d, causal):
    """B2 takes no atomics and each CTA writes only its own rows: two
    calls on the same inputs give the same bits of o and lse, causal and
    not (the non-causal wgmma kernel at both widths)."""
    q, k, v, _ = _flash_inputs(cuda, bh, t, d, 6)
    first = fa.flash_attention_fwd(q, k, v, causal)
    second = fa.flash_attention_fwd(q, k, v, causal)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d,causal,wgmma", [(64, False, True),
                                            (128, False, True),
                                            (32, False, False),
                                            (64, True, False),
                                            (128, True, False)])
def test_flash_forward_launches_its_instance(cuda, d, causal, wgmma):
    """The forward's kernel is chosen by D and ``causal`` alone: the
    non-causal entry at D = 64 and 128 launches ``flash_fwd_wgmma_kernel``,
    at D = 32 the mma.sync instance, and the causal entry the mma.sync
    instance at every D (profiler's kernel names, one kernel a call)."""
    from trustworthy_dl_tpu_torch.utils import kernel_ab

    q, k, v, _ = _flash_inputs(cuda, 4, 256, d, 13)
    names = kernel_ab.kernel_names(
        lambda: fa.flash_attention_fwd(q, k, v, causal),
        torch.empty(1024, dtype=torch.uint8, device=cuda))
    assert len(names) == 1 and "flash_fwd_" in names[0], names
    assert ("wgmma" in names[0]) == wgmma, names


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


@pytest.mark.parametrize("with_dlse", [False, True])
@pytest.mark.parametrize("bh,t,d,rising", [
    (3, 64, 16, False), (2, 64, 32, False), (4, 192, 64, False),
    (2, 128, 128, False), (5, 320, 128, False), (96, 256, 64, False),
    (96, 1024, 64, False), (4, 192, 64, True), (2, 192, 128, True)])
def test_non_causal_flash_kernels_match_plain(cuda, bh, t, d, rising,
                                              with_dlse):
    """B2 and B3's non-causal instances (``causal=False``) against their
    plain twins, with the causal cases' tolerances; the dq kernel's own
    Delta (less an lse cotangent, or not) within 1e-5 + 1e-5 relative of
    the twin's f32 reduction (f32 sums of D products in another order);
    each launch counted in ``launches`` and in ``launches_full``.  The
    ``rising`` cases scale the keys by their index (:func:`_flash_inputs`),
    so the forward's running maximum moves on nearly every key tile."""
    q, k, v, do = _flash_inputs(cuda, bh, t, d, 8, rising)
    gen = torch.Generator(device=cuda).manual_seed(12)
    dlse = 0.5 * torch.randn(bh, t, device=cuda, generator=gen) \
        if with_dlse else None
    wrappers = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                fa.flash_attention_bwd_dkv)
    counts = [(w.launches, w.launches_full) for w in wrappers]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, False, o,
                                          dlse)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                        causal=False)
    torch.cuda.synchronize()
    assert [(w.launches, w.launches_full) for w in wrappers] == \
        [(a + 1, b + 1) for a, b in counts]
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal=False)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=2e-3,
                               rtol=2.0 ** -7)
    torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=0)
    dq_ref, delta_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse, None, False,
                                              o, dlse)
    torch.testing.assert_close(delta, delta_ref, atol=1e-5, rtol=1e-5)
    refs = (dq_ref, *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta_ref,
                                            causal=False))
    for got, ref in zip((dq, dk, dv), refs):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                                   rtol=2.0 ** -7)
    # Not the causal kernel: the first query row attends every key.
    assert float((o[:, 0].float() - v[:, 0].float()).abs().max()) > 1e-2


@pytest.mark.parametrize("bh,t,d", [(2, 1024, 64), (2, 1024, 128)])
def test_non_causal_flash_forward_on_rising_scores(cuda, bh, t, d):
    """The non-causal forward on keys scaled by their index at T = 1024:
    the running max moves on nearly every one of the 16 key tiles, and at
    the end a row's scores spread ~17x as wide as unit-normal ones, so a
    few keys carry each row.  o against ``tiled_fwd_reference`` (the TPU
    kernel's own order of roundings: P rounded against the running max)
    within the smoke's tolerances, lse against the plain twin within 1e-3.
    The plain twin rounds P against the row's final max instead; on rows
    this peaked the two roundings of a dominant P differ by one bf16
    step, which can exceed atol 2e-3 + rtol 2^-7 on its own
    (``utils/flash_ab --rising`` holds both builds, the twin and the exact
    f64 softmax against each other)."""
    from trustworthy_dl_tpu_torch.utils.flash_ab import tiled_fwd_reference

    q, k, v, _ = _flash_inputs(cuda, bh, t, d, 8, rising=True)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.synchronize()
    ref = tiled_fwd_reference(q, k, v)
    torch.testing.assert_close(o.double(), ref, atol=2e-3, rtol=2.0 ** -7)
    torch.testing.assert_close(lse, fa.flash_fwd_plain(q, k, v, False)[1],
                               atol=1e-3, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_chunk_with_an_lse_cotangent_matches_plain(cuda, causal):
    """``flash_chunk``'s backward on the card (Delta - dlse into B3's
    kernels) against the twins given the same Delta - dlse, at the ring's
    chunk shape [96, 256, 64]."""
    q, k, v, do = _flash_inputs(cuda, 96, 256, 64, 9)
    gen = torch.Generator(device=cuda).manual_seed(10)
    dlse = 0.5 * torch.randn(96, 256, device=cuda, generator=gen)
    args = [a.clone().requires_grad_() for a in (q, k, v)]
    o, lse = fa.flash_chunk(*args, causal)
    grads = torch.autograd.grad((o, lse), args, (do, dlse))
    delta = (do.float() * o.detach().float()).sum(-1) - dlse
    lse = lse.detach()
    refs = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal),
            *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal))
    for got, ref in zip(grads, refs):
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-3,
                                   rtol=2.0 ** -7)


def test_ring_attention_on_the_card_launches_each_chunk(cuda):
    """Ring attention over 4 positions of the card at [2, 4, 512, 64]
    bf16: 4 causal and 6 non-causal launches of B2, dq and dk/dv; output
    and gradients near f32 full attention."""
    from trustworthy_dl_tpu_torch import ops
    from trustworthy_dl_tpu_torch.core.mesh import SEQ_AXIS, Mesh
    from trustworthy_dl_tpu_torch.models.gpt2 import full_attention
    from trustworthy_dl_tpu_torch.parallel import sequence as seq

    gen = torch.Generator(device=cuda).manual_seed(11)
    qkv = [torch.randn(2, 4, 512, 64, device=cuda, generator=gen).to(
        torch.bfloat16).requires_grad_() for _ in range(3)]
    g = torch.randn(2, 4, 512, 64, device=cuda, generator=gen)
    mesh = Mesh(np.array([cuda] * 4, dtype=object), (SEQ_AXIS,))
    ops.reset_launch_counts()
    with seq.use_sequence_mesh(mesh):
        out = seq.ring_attention(*qkv, True)
    grads = torch.autograd.grad(out, qkv, g.to(torch.bfloat16))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert (counts[name], counts[f"{name}_full"]) == (10, 6), counts
    ref_in = [a.detach().float().requires_grad_() for a in qkv]
    ref = full_attention(*ref_in, True)
    ref_grads = torch.autograd.grad(ref, ref_in, g)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a.float(), b, atol=3e-2, rtol=3e-2)


def test_sequence_trainer_refuses_f32_chunks_the_kernels_tile(cuda):
    """A ring whose chunks the flash kernels tile needs their bf16: an f32
    sequence-mode trainer is refused at construction; at a chunk the
    kernels do not tile (the einsum body) it builds."""
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.core.mesh import build_mesh
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
    from trustworthy_dl_tpu_torch.parallel import sequence as seq

    def trainer(seq_len):
        return DistributedTrainer(
            TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                           parallelism="sequence", dtype="float32"),
            mesh=build_mesh(4, "sequence", devices=[cuda] * 8),
            model_overrides=dict(n_layer=1, n_embd=64, n_head=4,
                                 vocab_size=128, n_positions=256,
                                 seq_len=seq_len),
            device="cuda")

    with pytest.raises(ValueError, match="bfloat16"):
        trainer(128)
    assert trainer(48).model.config.attn_impl == "ring"
    seq.set_sequence_mesh(None)


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


def _int8_pools(rng, nb, h, bsz, dh, device):
    k = torch.tensor(rng.normal(size=(nb, h, bsz, dh)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(nb, h, bsz, dh)), dtype=torch.float32)
    kq, ks = q8.quantize_kv(k)
    vq, vs = q8.quantize_kv(v)
    return [a.to(device) for a in (kq, vq, ks, vs)]


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 2e-3, 2.0**-7)])
def test_int8_decode_and_prefill_kernels_match_plain(cuda, dtype, atol, rtol):
    """B5 and B6 over an int8 pool (ragged decode rows T = 1, 5, 8; a
    ragged multi-row prefill T = 20; a chunk as long as the table, most of
    its rows' windows running past the table's end, as under int8 KV's
    max_seq chunk) against the twin with scales, on the rows inside each
    table."""
    rng = np.random.default_rng(6)
    nb, h, bsz, dh, r, nbps = 40, 3, 16, 64, 4, 8
    kq, vq, ks, vs = _int8_pools(rng, nb, h, bsz, dh, cuda)
    table = torch.tensor(rng.integers(0, nb, size=(r, nbps)),
                         dtype=torch.int32, device=cuda)
    start = torch.tensor([0, 5, 13, nbps * bsz - 24], dtype=torch.int32,
                         device=cuda)

    def mk(t):
        return torch.tensor(rng.normal(size=(r, h, t, dh)),
                            dtype=torch.float32).to(device=cuda, dtype=dtype)

    for t, wrapper in ((1, pa.paged_attention_int8),
                       (5, pa.paged_attention_int8),
                       (8, pa.paged_attention_int8),
                       (20, pa.paged_prefill_attention_int8),
                       (nbps * bsz, pa.paged_prefill_attention_int8)):
        q = mk(t)
        before = wrapper.launches
        got = wrapper(q, kq, vq, table, start, ks, vs)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = pa.paged_attention_plain(q, kq, vq, table, start, ks, vs)
        keep = (torch.arange(t, device=cuda)[None, :] + start.long()[:, None]
                < nbps * bsz)[:, None, :, None].expand_as(got)
        torch.testing.assert_close(got.float()[keep], ref.float()[keep],
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("bsz", [8, 16, 48])
def test_int8_prefill_tensor_core_kernel_matches_plain(cuda, dh, bsz):
    """B6-int8's tensor-core kernel (bf16 q) against the twin with scales:
    block sizes that divide 64 and one that does not (48), T = 9, 20, 64,
    65 and 512 over R = 4 rows with mid-block starts, the last rows of
    every chunk from 5 blocks before the table's end running past it
    (compared inside the table, finite everywhere), one table block with
    all-zero int8 rows and scales (exact-zero dequant), one launch a
    call.  Tolerance: one bf16 step plus 2e-3, the smoke's (the kernel
    feeds p * v_scale to the P.V product as a hi + lo pair of bf16 terms
    and sums in another order; the twin stays in f32; both round the
    output to bf16)."""
    rng = np.random.default_rng(12)
    h, r = 2, 4
    nbps = -(-640 // bsz)
    cap = nbps * bsz
    nb = r * nbps + 1
    kq, vq, ks, vs = _int8_pools(rng, nb, h, bsz, dh, cuda)
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=cuda)
    zero = int(table[1, 1])
    for a in (kq, vq, ks, vs):
        a[zero] = 0
    start = torch.tensor([0, bsz // 2 + 1, 3 * bsz + bsz // 2,
                          cap - 5 * bsz + 3], dtype=torch.int32,
                         device=cuda)
    for t in (9, 20, 64, 65, 512):
        q = torch.tensor(rng.normal(size=(r, h, t, dh)), dtype=torch.float32
                         ).to(device=cuda, dtype=torch.bfloat16)
        before = pa.paged_prefill_attention_int8.launches
        got = pa.paged_prefill_attention_int8(q, kq, vq, table, start, ks, vs)
        torch.cuda.synchronize()
        assert pa.paged_prefill_attention_int8.launches == before + 1
        ref = pa.paged_attention_plain(q, kq, vq, table, start, ks, vs)
        keep = (torch.arange(t, device=cuda)[None, :] + start.long()[:, None]
                < cap)[:, None, :, None].expand_as(got)
        assert bool(torch.isfinite(got).all()), t
        torch.testing.assert_close(got.float()[keep], ref.float()[keep],
                                   rtol=2.0 ** -7, atol=2e-3)


def test_engine_refuses_int8_kv_past_the_prefill_kernel(cuda):
    """B6-int8's tensor-core kernel takes Dh a multiple of 16: an int8-KV
    engine at Dh = 24 on the kernel path raises a ValueError naming the
    limit before it allocates anything on the card; GPT-2 small's Dh = 64
    at 16-position blocks is inside the limit."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=263, n_positions=64, n_layer=1,
                          n_embd=96, n_head=4, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="Dh=24"):
        ServingEngine(params, cfg, max_slots=2, max_seq=64, block_size=16,
                      kv_dtype="int8", device="cuda")
    assert torch.cuda.memory_allocated(cuda) == before
    assert pa.prefill_int8_kernel_limit(64, 16, torch.bfloat16) is None


@pytest.mark.parametrize("bsz", [8, 16, 48, 128])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_bf16_prefill_tensor_core_kernel_matches_plain(cuda, dh, bsz):
    """B6's tensor-core kernel over a bf16 pool (bf16 q) against the twin:
    block sizes that divide 64, one that does not (48) and one past the
    CUDA-core kernel's shared memory (128); over R = 3 rows, a 20-row
    chunk from mid-block starts, a 64-row chunk from 128 (the serve
    path's), and a chunk as long as the table from starts 0, mid-block
    and 3 blocks before the table's end (its later rows run past the
    table: compared inside it, finite everywhere); one launch a call.
    Tolerance: one bf16 step plus 2e-3, the smoke's (the kernel feeds p to
    the P.V product as a hi + lo pair of bf16 terms and sums in another
    order; the twin stays in f32; both round the output to bf16)."""
    rng = np.random.default_rng(31)
    h, r = 2, 3
    nbps = -(-640 // bsz)
    cap = nbps * bsz
    nb = r * nbps + 1
    pk, pv, _ = _pools(rng, nb, h, bsz, dh, torch.bfloat16, cuda)
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=cuda)
    mid = bsz // 2 + 1
    for t, starts in ((20, [mid, 3 * bsz + mid, cap - 20]),
                      (64, [128, 128, 128]),
                      (cap, [0, mid, cap - 3 * bsz])):
        start = torch.tensor(starts, dtype=torch.int32, device=cuda)
        q = torch.tensor(rng.normal(size=(r, h, t, dh)), dtype=torch.float32
                         ).to(device=cuda, dtype=torch.bfloat16)
        before = pa.paged_prefill_attention.launches
        got = pa.paged_prefill_attention(q, pk, pv, table, start)
        torch.cuda.synchronize()
        assert pa.paged_prefill_attention.launches == before + 1
        ref = pa.paged_prefill_attention_plain(q, pk, pv, table, start)
        keep = (torch.arange(t, device=cuda)[None, :] + start.long()[:, None]
                < cap)[:, None, :, None].expand_as(got)
        assert bool(torch.isfinite(got).all()), t
        torch.testing.assert_close(got.float()[keep], ref.float()[keep],
                                   rtol=2.0 ** -7, atol=2e-3)


def test_prefill_wrapper_rejects_past_the_kernel_limit(cuda):
    """bf16 q at Dh = 20, and f32 q at Dh = 64 over 128-position blocks
    (75,360 bytes of the CUDA-core kernel's 48 KB), are past B6's limits:
    ValueError naming the limit, nothing launched."""
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    for dtype, dh, bsz, needle in ((torch.bfloat16, 20, 16, "Dh=20"),
                                   (torch.float32, 64, 128, "shared memory")):
        q = torch.zeros(1, 2, 16, dh, dtype=dtype, device=cuda)
        pool = torch.zeros(3, 2, bsz, dh, dtype=dtype, device=cuda)
        before = pa.paged_prefill_attention.launches
        with pytest.raises(ValueError, match=needle):
            pa.paged_prefill_attention(q, pool, pool, table, 0)
        assert pa.paged_prefill_attention.launches == before


def test_bf16_engine_at_block_128_serves(cuda):
    """A bf16 GPT-2-shaped engine (2 layers, 768 wide, 12 heads of 64) over
    128-position blocks serves four greedy requests on the card, each
    prompt chunk through B6's tensor-core kernel (n_layer launches a
    chunk), and its streams equal the plain path's, or split only where
    the plain path's top-1 margin is a near tie (below 0.05: bf16
    attention outputs may differ in the last bit between the two)."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=281, n_positions=512, n_layer=2,
                          n_embd=768, n_head=12, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 281, int(n)).tolist()
               for n in (7, 130, 200, 300)]

    def serve(attn_impl):
        engine = ServingEngine(params, cfg, max_slots=4, max_seq=512,
                               block_size=128, attn_impl=attn_impl,
                               device="cuda")
        for p in prompts:
            engine.submit(ServeRequest(prompt=p, max_new_tokens=12))
        results = engine.run_until_idle()
        torch.cuda.synchronize()
        return engine, results

    before = pa.paged_prefill_attention.launches
    engine, got = serve("kernel")
    chunks = engine.metrics_summary()["prefill_chunks"]
    assert chunks > 0
    assert pa.paged_prefill_attention.launches - before == \
        cfg.n_layer * chunks
    _, ref = serve("plain")
    for rid in range(len(prompts)):
        assert got[rid].status == "completed"
        assert len(got[rid].tokens) == 12
        for i, (a, b) in enumerate(zip(got[rid].tokens, ref[rid].tokens)):
            if a != b:
                assert ref[rid].margins[i] < 0.05, (rid, i)
                break


def test_engine_refuses_f32_past_the_template(cuda):
    """f32 queries run the CUDA-core kernel, which stages one block a stage
    in 48 KB: an f32 engine at Dh = 64 over 128-position blocks (75,360
    bytes at 8 query rows) raises a ValueError naming the limit before it
    allocates anything on the card; 16-position blocks are inside it."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=283, n_positions=256, n_layer=1,
                          n_embd=128, n_head=2, dtype=torch.float32)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ServingEngine(params, cfg, max_slots=2, max_seq=256, block_size=128,
                      device="cuda")
    assert torch.cuda.memory_allocated(cuda) == before
    assert pa.prefill_kernel_limit(64, 16, torch.float32) is None


def _split_boundary_start(dh, t, cap):
    """A start whose T-query window straddles the last split of B5's
    cluster: at T > 1 the kernel gives rank c of a (row, head)'s 4 CTAs
    keys [c * span, (c + 1) * span) of the window [0, start + T), span =
    ceil((start + T) / 4) rounded up to a warp load's key rows (32 over
    D / 8 lanes rounded up to a power of two), so queries before 3 * span
    see no key of rank 3 and the later ones do.  T = 1 has no such start:
    a mid-table one."""
    lanes = 1 << (dh // 8 - 1).bit_length()
    kpw = 32 // lanes
    for s in range(cap - t, 0, -1):
        span = -(-(s + t) // 4)
        span = -(-span // kpw) * kpw
        if s < 3 * span < s + t:
            return s
    return cap // 2 + 3


@pytest.mark.parametrize("t", [1, 5, 8])
@pytest.mark.parametrize("bsz", [8, 16, 48])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_split_decode_kernel_matches_plain(cuda, pool, dh, bsz, t):
    """B5's split-K cluster kernel (bf16 q) over a bf16 or an int8 pool
    against the twin: 64-block tables, so a full window's span runs past
    one pass of a CTA's loads; starts 0 (a one-key window at T = 1),
    BLOCK - 1, a window straddling the last split (for T > 1), the table's
    last T positions, and the last position (the later queries of that
    row past the table: compared inside it, finite everywhere); one launch
    a call.  Tolerance: one bf16 step plus 2e-3, the smoke's (split-K only
    reorders f32 sums; both round the output to bf16)."""
    rng = np.random.default_rng(21)
    h, nbps = 2, 64
    cap = nbps * bsz
    starts = [0, bsz - 1, _split_boundary_start(dh, t, cap), cap - t,
              cap - 1]
    r = len(starts)
    nb = r * nbps + 1
    if pool == "int8":
        kq, vq, ks, vs = _int8_pools(rng, nb, h, bsz, dh, cuda)
        wrapper, scales = pa.paged_attention_int8, (ks, vs)
    else:
        kq, vq, _ = _pools(rng, nb, h, bsz, dh, torch.bfloat16, cuda)
        wrapper, scales = pa.paged_attention, ()
    table = torch.tensor((rng.permutation(r * nbps) + 1).reshape(r, nbps),
                         dtype=torch.int32, device=cuda)
    start = torch.tensor(starts, dtype=torch.int32, device=cuda)
    q = torch.tensor(rng.normal(size=(r, h, t, dh)), dtype=torch.float32
                     ).to(device=cuda, dtype=torch.bfloat16)
    before = wrapper.launches
    got = wrapper(q, kq, vq, table, start, *scales)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = pa.paged_attention_plain(q, kq, vq, table, start, *scales)
    keep = (torch.arange(t, device=cuda)[None, :] + start.long()[:, None]
            < cap)[:, None, :, None].expand_as(got)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float()[keep], ref.float()[keep],
                               rtol=2.0 ** -7, atol=2e-3)


def test_decode_wrappers_reject_past_the_kernel_limit(cuda):
    """bf16 q with Dh = 20 or T = 9 is past B5's limits: ValueError naming
    the limit, nothing launched."""
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    for t, dh, needle in ((1, 20, "Dh=20"), (9, 64, "T=9")):
        q = torch.zeros(1, 2, t, dh, dtype=torch.bfloat16, device=cuda)
        pool = torch.zeros(3, 2, 8, dh, dtype=torch.bfloat16, device=cuda)
        pool8 = pool.to(torch.int8)
        sc = torch.zeros(3, 2, 8, device=cuda)
        before = (pa.paged_attention.launches,
                  pa.paged_attention_int8.launches)
        with pytest.raises(ValueError, match=needle):
            pa.paged_attention(q, pool, pool, table, 0)
        with pytest.raises(ValueError, match=needle):
            pa.paged_attention_int8(q, pool8, pool8, table, 0, sc, sc)
        assert (pa.paged_attention.launches,
                pa.paged_attention_int8.launches) == before


def test_engine_refuses_bf16_pool_past_the_decode_kernel(cuda):
    """B5's bf16-query kernel takes Dh a multiple of 16: a bf16-pool
    engine at Dh = 20 on the kernel path raises a ValueError naming the
    limit before it allocates anything on the card; GPT-2 small's Dh = 64
    is inside the limit."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=269, n_positions=64, n_layer=1,
                          n_embd=80, n_head=4, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="Dh=20"):
        ServingEngine(params, cfg, max_slots=2, max_seq=64, block_size=16,
                      device="cuda")
    assert torch.cuda.memory_allocated(cuda) == before
    assert pa.decode_kernel_limit(64, pa.QROWS, torch.bfloat16, 16) is None


def _dq_inputs(rng, m, k, n, device):
    x = torch.tensor(rng.normal(size=(m, k)), dtype=torch.float32).to(
        device=device, dtype=torch.bfloat16)
    w = torch.tensor(rng.normal(size=(k, n)) * 0.02, dtype=torch.float32)
    wq, scale = (a.to(device).contiguous()
                 for a in q8.quantize_int8(w, axis=0))
    return x, wq, scale


@pytest.mark.parametrize("m", [1, 8, 15, 16, 64, 100, 320])
@pytest.mark.parametrize("k,n", [(768, 2304), (768, 768), (768, 3072),
                                 (3072, 768), (96, 288), (384, 96),
                                 (128, 64)])
def test_dequant_matmul_kernel_matches_plain(cuda, m, k, n):
    """B4 against its twin at GPT-2 small's four block matrices, n_embd
    96's qkv and mlp proj (K and N multiples of 16, not of 64) and a
    small square-ish case, at decode, draft, chunk and local-prefill row
    counts; one launch a call."""
    rng = np.random.default_rng(7)
    x, wq, scale = _dq_inputs(rng, m, k, n, cuda)
    before = fdm.dequant_matmul.launches
    got = fdm.dequant_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert fdm.dequant_matmul.launches == before + 1
    ref = fdm.dequant_matmul_plain(x, wq, scale)
    mag = (x.float().abs() @ wq.float().abs()) * scale
    assert bool(torch.isfinite(got).all())
    assert bool(((got - ref).abs() <= 1e-5 * mag + 1e-30).all())


@pytest.mark.parametrize("m,k,n", [(8, 3072, 768), (64, 768, 2304),
                                   (15, 96, 288)])
def test_dequant_matmul_kernel_is_deterministic(cuda, m, k, n):
    """The split's partials meet in a fixed order (warps, then cluster
    ranks): two calls give the same bits."""
    rng = np.random.default_rng(9)
    x, wq, scale = _dq_inputs(rng, m, k, n, cuda)
    first = fdm.dequant_matmul(x, wq, scale)
    second = fdm.dequant_matmul(x, wq, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_dequant_matmul_rejects_misaligned_x(cuda):
    """x, w_q and scale are copied 16 bytes at a time: a contiguous x two
    elements into its buffer raises ValueError, nothing launched."""
    rng = np.random.default_rng(12)
    _, wq, scale = _dq_inputs(rng, 8, 768, 768, cuda)
    buf = torch.zeros(8 * 768 + 2, dtype=torch.bfloat16, device=cuda)
    x = buf[2:].view(8, 768)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = fdm.dequant_matmul.launches
    with pytest.raises(ValueError, match="16-byte"):
        fdm.dequant_matmul(x, wq, scale)
    assert fdm.dequant_matmul.launches == before


@pytest.mark.parametrize("b,d,v", [(40, 768, 50257), (5, 64, 700),
                                   (72, 768, 1000)])
def test_verify_tail_kernel_matches_plain(cuda, b, d, v):
    rng = np.random.default_rng(8)
    normed = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32).to(
        device=cuda, dtype=torch.bfloat16)
    head = torch.tensor(rng.normal(size=(v, d)) * 0.05,
                        dtype=torch.float32).to(device=cuda,
                                                dtype=torch.bfloat16)
    head[v - 1] = head[3]                    # row 0's maximum duplicated
    normed[0] = head[3] * 40.0
    before = pa.fused_verify_tail.launches
    logits, ent, mar = pa.fused_verify_tail(normed, head)
    torch.cuda.synchronize()
    assert pa.fused_verify_tail.launches == before + 1
    ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
    bound = ref.abs() * 2.0 ** -7 \
        + 1e-5 * (normed.float().abs() @ head.float().abs().T)
    excess = float(((logits - ref).abs() - bound).max())
    assert excess <= 0.0, excess
    top2 = torch.topk(logits, 2, dim=-1).values
    assert torch.equal(mar, top2[:, 0] - top2[:, 1])
    assert float(mar[0]) == 0.0
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,d,v", [(40, 768, 50257), (96, 768, 50257),
                                   (3, 96, 701)])
def test_verify_tail_kernel_is_deterministic(cuda, b, d, v):
    """Two launches on the same inputs give the same bits for the logits,
    the entropy and the margin, whichever CTA arrives last to fold: the
    fold reads every CTA's partial in CTA order."""
    rng = np.random.default_rng(23)
    normed = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32).to(
        device=cuda, dtype=torch.bfloat16)
    head = torch.tensor(rng.normal(size=(v, d)) * 0.05,
                        dtype=torch.float32).to(device=cuda,
                                                dtype=torch.bfloat16)
    first = pa.fused_verify_tail(normed, head)
    second = pa.fused_verify_tail(normed, head)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _verify_inputs(rng, b, d, v, device):
    normed = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32).to(
        device=device, dtype=torch.bfloat16)
    head = torch.tensor(rng.normal(size=(v, d)) * 0.05,
                        dtype=torch.float32).to(device=device,
                                                dtype=torch.bfloat16)
    head[v - 1] = head[3]
    normed[b - 1] = head[3] * 40.0
    return normed, head


def test_verify_tail_kernel_holds_the_twin_launch_after_launch(cuda):
    """The last CTA folds the other CTAs' partials as soon as their counts
    arrive, so a count that got ahead of its CTA's stores would fold a
    stale partial now and then.  100 launches at 96 rows (rows 32-95 come
    from warps past the first), each after a block of the scratch's size
    was filled with NaN and freed (the allocator's next block of that
    size), each held to the twin: entropy within 1e-4, the margin exactly
    top-2 of the launch's logits."""
    rng = np.random.default_rng(31)
    b, d, v = 96, 768, 50257
    normed, head = _verify_inputs(rng, b, d, v, cuda)
    _, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
    scratch = (b * -(-v // pa.VERIFY_TILE_COLS) + 1, 4)
    for _ in range(100):
        torch.full(scratch, float("nan"), device=cuda)
        logits, ent, mar = pa.fused_verify_tail(normed, head)
        top2 = torch.topk(logits, 2, dim=-1).values
        assert torch.equal(mar, top2[:, 0] - top2[:, 1])
        assert float(mar[b - 1]) == 0.0
        torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


def test_verify_tail_kernel_on_two_streams_at_once(cuda):
    """Each launch counts its CTAs on a word of its own call's scratch, so
    launches on two streams that overlap on the card fold apart: 20 calls
    a stream, each against the twin as above."""
    rng = np.random.default_rng(32)
    d, v = 768, 50257
    cases = [_verify_inputs(rng, b, d, v, cuda) for b in (40, 96)]
    streams = [torch.cuda.Stream() for _ in cases]
    torch.cuda.synchronize()
    outs = [[] for _ in cases]
    for _ in range(20):
        for (normed, head), s, out in zip(cases, streams, outs):
            with torch.cuda.stream(s):
                out.append(pa.fused_verify_tail(normed, head))
    torch.cuda.synchronize()
    for (normed, head), out in zip(cases, outs):
        ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
        bound = ref.abs() * 2.0 ** -7 \
            + 1e-5 * (normed.float().abs() @ head.float().abs().T)
        for logits, ent, mar in out:
            assert float(((logits - ref).abs() - bound).max()) <= 0.0
            top2 = torch.topk(logits, 2, dim=-1).values
            assert torch.equal(mar, top2[:, 0] - top2[:, 1])
            torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,d", [(40, 96), (100, 48), (8, 16)])
def test_verify_tail_takes_d_multiple_of_16(cuda, b, d):
    """B8 at widths that are multiples of 16 but not of 64 (n_embd 96's
    spec verify is 40 x 96): the last K chunk is short; against the twin
    as above."""
    rng = np.random.default_rng(13)
    v = 3000
    normed = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32).to(
        device=cuda, dtype=torch.bfloat16)
    head = torch.tensor(rng.normal(size=(v, d)) * 0.05,
                        dtype=torch.float32).to(device=cuda,
                                                dtype=torch.bfloat16)
    head[v - 1] = head[3]
    normed[0] = head[3] * 40.0
    logits, ent, mar = pa.fused_verify_tail(normed, head)
    torch.cuda.synchronize()
    ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
    bound = ref.abs() * 2.0 ** -7 \
        + 1e-5 * (normed.float().abs() @ head.float().abs().T)
    assert float(((logits - ref).abs() - bound).max()) <= 0.0
    top2 = torch.topk(logits, 2, dim=-1).values
    assert torch.equal(mar, top2[:, 0] - top2[:, 1])
    assert float(mar[0]) == 0.0
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,d,launches", [(96, 1024, 2), (48, 1600, 1),
                                           (49, 1600, 2)])
def test_verify_tail_fits_rows_to_shared_memory(cuda, b, d, launches):
    """At GPT-2 medium's and XL's widths a launch takes the rows that fit
    beside the ring (80 and 48, ``verify_group_rows``): 96 rows at 1024
    are two launches, against the plain twin as above."""
    rng = np.random.default_rng(24)
    v = 2000
    normed = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32).to(
        device=cuda, dtype=torch.bfloat16)
    head = torch.tensor(rng.normal(size=(v, d)) * 0.05,
                        dtype=torch.float32).to(device=cuda,
                                                dtype=torch.bfloat16)
    head[v - 1] = head[3]
    normed[b - 1] = head[3] * 40.0
    before = pa.fused_verify_tail.launches
    logits, ent, mar = pa.fused_verify_tail(normed, head)
    torch.cuda.synchronize()
    assert pa.fused_verify_tail.launches == before + launches
    ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
    bound = ref.abs() * 2.0 ** -7 \
        + 1e-5 * (normed.float().abs() @ head.float().abs().T)
    assert float(((logits - ref).abs() - bound).max()) <= 0.0
    top2 = torch.topk(logits, 2, dim=-1).values
    assert torch.equal(mar, top2[:, 0] - top2[:, 1])
    assert float(mar[b - 1]) == 0.0
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b", [100, 144])
def test_verify_tail_takes_any_row_count(cuda, b):
    """B8 past one launch's 96 rows: one launch per row group, each writing
    its rows, against the plain twin as above."""
    rng = np.random.default_rng(10)
    d, v = 768, 5000
    normed = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32).to(
        device=cuda, dtype=torch.bfloat16)
    head = torch.tensor(rng.normal(size=(v, d)) * 0.05,
                        dtype=torch.float32).to(device=cuda,
                                                dtype=torch.bfloat16)
    head[v - 1] = head[3]
    normed[b - 1] = head[3] * 40.0          # a duplicated maximum past row 96
    before = pa.fused_verify_tail.launches
    logits, ent, mar = pa.fused_verify_tail(normed, head)
    torch.cuda.synchronize()
    assert pa.fused_verify_tail.launches == before + 2
    ref, ent_ref, _ = pa.fused_verify_tail_plain(normed, head)
    bound = ref.abs() * 2.0 ** -7 \
        + 1e-5 * (normed.float().abs() @ head.float().abs().T)
    assert float(((logits - ref).abs() - bound).max()) <= 0.0
    top2 = torch.topk(logits, 2, dim=-1).values
    assert torch.equal(mar, top2[:, 0] - top2[:, 1])
    assert float(mar[b - 1]) == 0.0
    torch.testing.assert_close(ent, ent_ref, rtol=0, atol=1e-4)


def _small_bf16(vocab):
    """A 2-layer, 128-wide bf16 GPT-2 with random weights (seed 0)."""
    from trustworthy_dl_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(vocab_size=vocab, n_positions=128, n_layer=2,
                          n_embd=128, n_head=2, dtype=torch.bfloat16)
    return cfg, gpt2.init_params(cfg, torch.Generator().manual_seed(0))


def test_engine_refuses_adapters_past_the_kernel_at_construction(cuda):
    """B9 takes rank <= 64: an engine at rank 65 on the kernel path raises
    a ValueError naming the limit before it allocates anything on the
    card (the plain path on the CPU takes any rank)."""
    from trustworthy_dl_tpu_torch.serve import ServingEngine

    cfg, params = _small_bf16(256)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="rank 65"):
        ServingEngine(params, cfg, max_slots=2, max_seq=64, block_size=16,
                      adapter_rank=65, device="cuda")
    assert torch.cuda.memory_allocated(cuda) == before


def test_engine_takes_rank_64_adapters_at_gpt2_medium_width(cuda):
    """GPT-2 medium's width (n_embd 1024, 16 heads; 2 layers) at adapter
    rank 64, which B9's shared memory refused before: the engine builds
    on the card's kernel path and serves an adapter request to the end,
    every adapter site of every chunk and tick through one B9 launch."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=283, n_positions=64, n_layer=2,
                          n_embd=1024, n_head=16, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    engine = ServingEngine(params, cfg, max_slots=2, max_seq=64,
                           block_size=16, prefill_chunk=16, adapter_rank=64,
                           adapter_pool_pages=1, adapter_map={"t": "ad-t"},
                           device="cuda")
    engine.adapter_pool.init_scale = 0.5
    before = pa.adapter_delta.launches
    rid = engine.submit(ServeRequest(
        prompt=[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3],
        max_new_tokens=6, tenant="t"))
    result = engine.run_until_idle()[rid]
    torch.cuda.synchronize()
    assert result.status == "completed" and len(result.tokens) == 6
    s = engine.metrics_summary()
    assert pa.adapter_delta.launches - before == \
        2 * cfg.n_layer * (s["decode_ticks"] + s["prefill_chunks"]) > 0


@pytest.mark.parametrize("knobs", [dict(weight_dtype="int8"),
                                   dict(spec_k=4)])
def test_engine_refuses_f32_int8_matrices_at_construction(cuda, knobs):
    """B4 takes bf16 x only: an f32 GPT-2 engine that would run its block
    matrices through it (int8 weights, or the int8 self-draft of
    ``spec_k=4``) raises a ValueError naming the limit before it
    allocates anything on the card."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=269, n_positions=64, n_layer=1,
                          n_embd=128, n_head=2, dtype=torch.float32)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(ValueError, match="x must be bf16"):
        ServingEngine(params, cfg, max_slots=2, max_seq=64, block_size=16,
                      device="cuda", **knobs)
    assert torch.cuda.memory_allocated(cuda) == before


@pytest.mark.parametrize("knobs", [dict(weight_dtype="int8"),
                                   dict(spec_k=4)])
def test_bf16_d96_engine_serves_int8_matrices(cuda, knobs):
    """n_embd = 96 (K = 96 and N = 288 are not multiples of 64): a bf16
    engine with int8 weights, and one drafting through the int8 weights
    (``spec_k=4``), serve four greedy requests on the card with every
    block matrix through B4 (4 x n_layer launches a forward or a draft
    step), and their streams equal the same engine's on the CPU, where
    every kernel is its plain twin, or split only where the CPU engine's
    top-1 margin is a near tie (below 0.05: bf16 outputs may differ in
    the last bit between the two)."""
    from trustworthy_dl_tpu_torch.models import gpt2
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    cfg = gpt2.GPT2Config(vocab_size=271, n_positions=128, n_layer=2,
                          n_embd=96, n_head=2, dtype=torch.bfloat16)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, 271, int(n)).tolist() for n in (5, 17, 30, 41)]

    def serve(device):
        engine = ServingEngine(params, cfg, max_slots=4, max_seq=96,
                               block_size=16, device=device, **knobs)
        for p in prompts:
            engine.submit(ServeRequest(prompt=p, max_new_tokens=12))
        results = engine.run_until_idle()
        if device == "cuda":
            torch.cuda.synchronize()
        return engine, results

    before = fdm.dequant_matmul.launches
    engine, got = serve("cuda")
    s = engine.metrics_summary()
    forwards = (cfg.n_layer * 4 * knobs["spec_k"] * s["spec_ticks"]
                if "spec_k" in knobs else
                cfg.n_layer * 4 * (s["decode_ticks"] + s["local_prefills"]
                                   + s["prefill_chunks"]))
    assert forwards > 0
    assert fdm.dequant_matmul.launches - before == forwards
    _, ref = serve("cpu")
    for rid in range(len(prompts)):
        assert got[rid].status == "completed"
        assert len(got[rid].tokens) == 12
        for i, (a, b) in enumerate(zip(got[rid].tokens, ref[rid].tokens)):
            if a != b:
                assert ref[rid].margins[i] < 0.05, (rid, i)
                break


def test_spec_engine_past_one_verify_launch_serves(cuda):
    """``max_slots=16, spec_k=8``: the verify feeds B8 16 x 9 = 144 rows,
    two launches a spec tick.  Four greedy requests complete, and their
    streams equal ``spec_k=0``'s, or split only where spec off's top-1
    margin is a near tie (below 0.05: bf16 verify and decode logits may
    differ in the last bit there)."""
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    cfg, params = _small_bf16(257)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 257, int(n)).tolist() for n in (5, 9, 14, 20)]

    def serve(spec_k):
        engine = ServingEngine(params, cfg, max_slots=16, max_seq=64,
                               block_size=16, spec_k=spec_k, device="cuda")
        for p in prompts:
            engine.submit(ServeRequest(prompt=p, max_new_tokens=16))
        results = engine.run_until_idle()
        torch.cuda.synchronize()
        return engine, results

    before = pa.fused_verify_tail.launches
    engine, spec = serve(8)
    ticks = engine.metrics_summary()["spec_ticks"]
    assert ticks > 0
    assert pa.fused_verify_tail.launches - before == 2 * ticks
    _, off = serve(0)
    for rid in range(len(prompts)):
        assert spec[rid].status == "completed"
        assert len(spec[rid].tokens) == 16
        for i, (a, b) in enumerate(zip(spec[rid].tokens, off[rid].tokens)):
            if a != b:
                assert off[rid].margins[i] < 0.05, (rid, i)
                break


def test_new_wrappers_reject_what_kernels_do_not_take(cuda):
    x32 = torch.zeros(8, 64, device=cuda)
    wq = torch.zeros(64, 64, dtype=torch.int8, device=cuda)
    scale = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):
        fdm.dequant_matmul(x32, wq, scale)             # f32 x on the card
    with pytest.raises(ValueError):
        fdm.dequant_matmul(x32.bfloat16()[:, :40].contiguous(),
                           wq[:40].contiguous(), scale)  # K not a multiple
    with pytest.raises(ValueError):
        pa.fused_verify_tail(torch.zeros(4, 64, device=cuda),
                             torch.zeros(9, 64, device=cuda))    # f32
    with pytest.raises(ValueError):
        pa.fused_verify_tail(torch.zeros(97, 40, dtype=torch.bfloat16,
                                         device=cuda),
                             torch.zeros(9, 40, dtype=torch.bfloat16,
                                         device=cuda))      # D % 16 != 0
    q = torch.zeros(1, 2, 1, 16, dtype=torch.bfloat16, device=cuda)
    pool = torch.zeros(3, 2, 8, 16, dtype=torch.bfloat16, device=cuda)
    sc = torch.zeros(3, 2, 8, device=cuda)
    table = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):                    # bf16 pool + scales
        pa.paged_attention_int8(q, pool, pool, table, 0, sc, sc)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("rows,t,rank,d", [(8, 1, 16, 768), (1, 64, 16, 768),
                                           (2, 20, 4, 64), (3, 9, 64, 768),
                                           (1, 3, 33, 128), (8, 1, 64, 1024),
                                           (2, 5, 64, 1600), (1, 16, 16, 768),
                                           (1, 17, 16, 768), (16, 1, 16, 768)])
def test_adapter_delta_kernel_matches_plain(cuda, tier, rows, t, rank, d):
    """B9 on one site of one layer of a pool [3, 5, 2, D, r] (the strided
    view the engine passes), bf16 pages or int8 pages with per-page
    scales; row 0 on the zero page, duplicates where rows allow; GPT-2
    medium's and XL's widths at rank 64, T either side of a tile's 8 and
    16 positions, and a 16-slot decode."""
    args = _adapter_args(cuda, tier, rows, t, rank, d)
    before = pa.adapter_delta.launches
    got = pa.adapter_delta(*args)
    torch.cuda.synchronize()
    assert pa.adapter_delta.launches == before + 1
    ref = pa.adapter_delta_plain(*args)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert bool((got[0] == 0.0).all())


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("rows,t", [(8, 1), (2, 20)])
def test_adapter_delta_kernel_gives_the_same_bits_twice(cuda, tier, rows, t):
    """B9 sums in a fixed order with no atomics: two launches on the same
    inputs give the same bits."""
    args = _adapter_args(cuda, tier, rows, t, 64, 768)
    first = pa.adapter_delta(*args)
    second = pa.adapter_delta(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_adapter_delta_kernel_gives_nan_rows_for_a_page_outside_the_pool(
        cuda, tier):
    """A page index outside [0, P] gives that row NaN (the kernel reads
    nothing outside the pool) and leaves the other rows right."""
    x, a, b, pages, sa, sb = _adapter_args(cuda, tier, 4, 3, 16, 768)
    bad = torch.tensor([1, 5, 2, -1], dtype=torch.int32, device=cuda)
    got = pa.adapter_delta(x, a, b, bad, sa, sb)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[1]).all()) and bool(torch.isnan(got[3]).all())
    good = torch.tensor([0, 2], device=cuda)
    ref = pa.adapter_delta_plain(x[good], a, b, bad[good], sa, sb)
    assert float((got[good] - ref).abs().max()) <= \
        1e-5 * float(ref.abs().max())


def _adapter_args(cuda, tier, rows, t, rank, d):
    """(x, A site, B site, pages, a_scale, b_scale) on one site of one
    layer of a pool [3, 5, 2, D, r], page 0 all zeros, row 0 on it."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    npg = 5
    shape_a, shape_b = (3, npg, 2, d, rank), (3, npg, 2, rank, d)
    if tier == "int8":
        a = torch.randint(-127, 128, shape_a, device=cuda, generator=gen,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, shape_b, device=cuda, generator=gen,
                          dtype=torch.int8)
        sa = torch.rand(3, npg, 2, device=cuda, generator=gen) * 1e-3
        sb = torch.rand(3, npg, 2, device=cuda, generator=gen) * 1e-3
    else:
        a = torch.randn(shape_a, device=cuda, generator=gen).to(
            torch.bfloat16)
        b = torch.randn(shape_b, device=cuda, generator=gen).to(
            torch.bfloat16)
        sa = sb = None
    a[:, 0] = 0
    b[:, 0] = 0
    pages = torch.tensor(([0, 3, 3, 1, 4, 2, 0, 1] * 2)[:rows],
                         dtype=torch.int32, device=cuda)
    x = torch.randn(rows, t, d, device=cuda, generator=gen).to(
        torch.bfloat16)
    return (x, a[1][:, 0], b[1][:, 0], pages,
            None if sa is None else sa[1][:, 0],
            None if sb is None else sb[1][:, 0])


def test_adapter_delta_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros(3, 64, 4, dtype=torch.bfloat16, device=cuda)
    b = torch.zeros(3, 4, 64, dtype=torch.bfloat16, device=cuda)
    x = torch.zeros(2, 1, 64, dtype=torch.bfloat16, device=cuda)
    pages = torch.zeros(2, dtype=torch.int32, device=cuda)
    scale = torch.ones(3, device=cuda)
    with pytest.raises(ValueError):                    # f32 x on the card
        pa.adapter_delta(x.float(), a, b, pages)
    with pytest.raises(ValueError):                    # f32 pages
        pa.adapter_delta(x, a.float(), b.float(), pages)
    with pytest.raises(ValueError):                    # rank above 64
        pa.adapter_delta(x, torch.zeros(3, 64, 65, dtype=torch.bfloat16,
                                        device=cuda),
                         torch.zeros(3, 65, 64, dtype=torch.bfloat16,
                                     device=cuda), pages)
    with pytest.raises(ValueError):                    # D not a multiple
        pa.adapter_delta(x[:, :, :60].contiguous(), a[:, :60].contiguous(),
                         b[:, :, :60].contiguous(), pages)
    with pytest.raises(ValueError):                    # one scale only
        pa.adapter_delta(x, a, b, pages, scale, None)
    with pytest.raises(ValueError):                    # i64 pages
        pa.adapter_delta(x, a, b, pages.long())


@pytest.mark.parametrize("chunk", [64, 8192])
def test_fused_head_on_the_card_matches_the_cpu(cuda, chunk):
    """bf16 compute: the products' f32 results within 1e-5 of their
    largest magnitude of the CPU's (f32 sums in another order), the loss
    within 1e-5 relative, dx and dW within 2^-7 of their largest
    magnitude (a one-ulp move of an f32 ``probs`` entry may flip the bf16
    rounding of its ``dlogits``); accuracy equal."""
    from trustworthy_dl_tpu_torch.ops import fused_ce

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(300, 96, generator=gen)
    w = torch.randn(1000, 96, generator=gen) * 0.3
    t = torch.randint(0, 1000, (300,), generator=gen)
    a, b = x.bfloat16(), w.bfloat16().T
    got = fused_ce.product_f32(a.to(cuda), b.to(cuda))
    want = fused_ce.product_f32(a, b)
    assert got.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    out = {}
    for dev in (cuda, torch.device("cpu")):
        xd = x.to(dev).requires_grad_()
        wd = w.to(dev).requires_grad_()
        loss = fused_ce.fused_lm_loss(xd, wd, t.to(dev), chunk,
                                      torch.bfloat16)
        grads = torch.autograd.grad(loss, (xd, wd))
        ev = fused_ce.fused_lm_eval(xd.detach(), wd.detach(), t.to(dev),
                                    chunk, torch.bfloat16)
        out[dev.type] = [float(loss.detach())] + [g.cpu() for g in grads] \
            + [float(v) for v in ev]
    card, cpu = out["cuda"], out["cpu"]
    assert abs(card[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    for g_card, g_cpu in zip(card[1:3], cpu[1:3]):
        assert float((g_card - g_cpu).abs().max()) <= 2.0 ** -7 * float(
            g_cpu.abs().max())
    assert abs(card[3] - cpu[3]) <= 1e-5 * abs(cpu[3])
    assert card[4] == cpu[4]


_CARD_GPT = dict(n_layer=2, n_embd=64, n_head=4, vocab_size=128,
                 n_positions=64, seq_len=64, attn_impl="flash")


def _card_trainer(device, ckpt_dir="checkpoints"):
    from trustworthy_dl_tpu_torch.core.config import TrainingConfig
    from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer

    config = TrainingConfig(model_name="gpt2", batch_size=8, num_nodes=4,
                            learning_rate=3e-3, detector_warmup=2,
                            checkpoint_dir=str(ckpt_dir))
    return DistributedTrainer(config, model_overrides=dict(_CARD_GPT),
                              device=device)


def _card_batches(n):
    from trustworthy_dl_tpu_torch.data import get_dataloader

    return list(get_dataloader("openwebtext", batch_size=8, seq_len=64,
                               vocab_size=128, num_examples=8 * n))


def test_nan_params_trip_the_guard_through_b1_b3(cuda):
    """NaN state (the drill's GRAD_NAN) through B1-B3 on the card: the
    step reports no finite node and the supervisor's guard rejects it, as
    the plain twins do on the CPU from the same params and batch."""
    from trustworthy_dl_tpu_torch.chaos.injector import \
        _corrupt_largest_leaf
    from trustworthy_dl_tpu_torch.engine.supervisor import \
        TrainingSupervisor
    from trustworthy_dl_tpu_torch.ops import launch_counts

    batch = _card_batches(1)[0]
    verdicts = {}
    card = _card_trainer(cuda)
    card.initialize()
    params = {k: v for k, v in card.state.params.items()}
    for name, tr in (("cuda", card), ("cpu", _card_trainer("cpu"))):
        if name == "cpu":
            from trustworthy_dl_tpu_torch.utils.tree import map_tree

            tr.initialize(params=map_tree(lambda a: a.cpu(), params))
        tr.state = tr.state._replace(
            params=_corrupt_largest_leaf(tr.state.params))
        before = launch_counts()
        tr.state, metrics = tr._train_step(tr.state, tr._node_batch(batch),
                                           tr.attack_plan)
        after = launch_counts()
        verdicts[name] = (metrics.finite.cpu().tolist(),
                          TrainingSupervisor._is_bad(metrics))
        if name == "cuda":
            for kernel in ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "fused_moments"):
                assert after[kernel] > before[kernel], kernel
    assert verdicts["cuda"] == verdicts["cpu"] == ([False] * 4, True)


def test_checkpoint_round_trip_on_the_card_is_bit_exact(cuda, tmp_path):
    """A ``block=False`` save on the card is a host snapshot: the step
    taken while it is written does not reach it.  A fresh trainer restored
    from it (params, optimizer, trust, the card's generator) takes the
    same next step bit for bit."""
    batches = _card_batches(4)
    a = _card_trainer(cuda, tmp_path / "ck")
    a.initialize()
    for b in batches[:2]:
        a.train_step(b, 0)
    a.checkpointer.save(a.state, a.global_step, block=False)
    want = a.train_step(batches[2], 0)
    a.checkpointer.wait()
    restored = _card_trainer(cuda, tmp_path / "ck")
    restored.load_checkpoint()
    assert restored.global_step == 2
    assert restored.state.rng.device.type == "cuda"
    got = restored.train_step(batches[2], 0)
    assert got["per_node_loss"] == want["per_node_loss"]
    from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

    for x, y in zip(tree_leaves(restored.state.params),
                    tree_leaves(a.state.params)):
        assert torch.equal(x, y)
    assert torch.equal(torch.rand(3, device=cuda, generator=a.state.rng),
                       torch.rand(3, device=cuda,
                                  generator=restored.state.rng))
