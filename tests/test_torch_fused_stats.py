"""The port's moment battery (B1's plain twin) and the statistic batteries
built on it, against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
side runs ``fused_moments(x, interpret=True)``: the Pallas kernel in
interpret mode over the aligned prefix, XLA over the tail and below one
tile (65,536 elements).

Tolerances: min, max and max|x| exactly equal (order-free); each raw sum
within 1e-5 of its magnitude sum (sum |x|^p, the scale of its f32
rounding in another summation order), 1e-4 for sum x^3 and sum x^4;
NaN and inf propagate the same way.  Full batteries: every stat within
rel 1e-4 of the JAX value plus 1e-4 of the battery's own std (location
stats of near-zero-mean data), kurtosis within 1e-3; the order-statistics
subsample and the per-leaf norms as in the JAX package (sample exactly
equal, norms within rel 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.detect import stats as jst
from trustworthy_dl_tpu.ops.fused_stats import fused_moments as jfused
from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.ops import fused_stats as fs

pytestmark = pytest.mark.torchport


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _magnitudes(x: np.ndarray) -> np.ndarray:
    a = np.abs(x.astype(np.float64))
    return np.array([a.sum(), (a ** 2).sum(), (a ** 3).sum(), (a ** 4).sum(),
                     a.sum()])


def _check_moments(got: np.ndarray, ref: np.ndarray, x: np.ndarray) -> None:
    sums = [fs.S1, fs.S2, fs.S3, fs.S4, fs.L1]
    tol = np.array([1e-5, 1e-5, 1e-4, 1e-4, 1e-5]) * _magnitudes(x)
    for col, t in zip(sums, tol):
        if np.isnan(ref[col]):
            assert np.isnan(got[col]), (col, got[col])
        else:
            np.testing.assert_allclose(got[col], ref[col], rtol=0, atol=t)
    for col in (fs.MIN, fs.MAX, fs.LINF):
        np.testing.assert_array_equal(got[col], ref[col])


@pytest.mark.parametrize("n", [1000, 65_536, 140_000])
def test_moments_twin_matches_pallas_kernel(n):
    x = (np.random.default_rng(n).standard_normal(n) * 0.05 + 0.01
         ).astype(np.float32)
    ref = np.array([float(v) for v in jfused(jnp.asarray(x),
                                             interpret=True)])
    got = fs.fused_moments([torch.from_numpy(x)])[0].numpy()
    _check_moments(got, ref, x)


@pytest.mark.parametrize("special", ["inf", "nan"])
def test_moments_twin_propagates_inf_and_nan(special):
    x = np.random.default_rng(7).standard_normal(65_536).astype(np.float32)
    if special == "inf":
        x[[3, 40_000]] = [np.inf, -np.inf]
    else:
        x[1234] = np.nan
    ref = np.array([float(v) for v in jfused(jnp.asarray(x),
                                             interpret=True)])
    got = fs.fused_moments([torch.from_numpy(x)])[0].numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(got[~finite & ~np.isnan(ref)],
                                  ref[~finite & ~np.isnan(ref)])
    for col in (fs.MIN, fs.MAX, fs.LINF):
        np.testing.assert_array_equal(got[col], ref[col])


def test_moments_of_many_segments_in_one_call():
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(n).astype(np.float32) for n in (5, 0, 7000)]
    got = fs.fused_moments([torch.from_numpy(x) for x in xs]).numpy()
    assert got.shape == (3, 8)
    np.testing.assert_array_equal(got[1], [0, 0, 0, 0, np.inf, -np.inf, 0,
                                           0])
    for row, x in zip(got[[0, 2]], (xs[0], xs[2])):
        ref = np.array([float(v) for v in jfused(jnp.asarray(x),
                                                 interpret=True)])
        _check_moments(row, ref, x)


@pytest.mark.parametrize("seed", range(8))
def test_moments_nan_flag_is_sum_of_squares(seed):
    """The kernel's fold puts NaN back into min, max and max|x| where sum
    x^2 is NaN: over random mixes of NaN, +-inf and finite values whose
    x^2 and x^4 overflow, the twin's and JAX's ``_xla_moments``' s2 is NaN
    exactly when the segment holds a NaN (s3 may turn NaN from +inf and
    -inf alone), and their min, max and max|x| agree."""
    from trustworthy_dl_tpu.ops.fused_stats import _xla_moments

    rng = np.random.default_rng(100 + seed)
    for _ in range(12):
        n = int(rng.integers(1, 40))
        x = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 25, n)
             ).astype(np.float32)
        picks = rng.random(n)
        x[picks < 0.1] = np.nan
        x[(picks >= 0.1) & (picks < 0.2)] = np.inf
        x[(picks >= 0.2) & (picks < 0.3)] = -np.inf
        has_nan = bool(np.isnan(x).any())
        got = fs.fused_moments([torch.from_numpy(x)])[0].numpy()
        ref = np.array([float(v) for v in _xla_moments(jnp.asarray(x))])
        assert bool(np.isnan(got[fs.S2])) == has_nan
        assert bool(np.isnan(ref[fs.S2])) == has_nan
        for col in (fs.MIN, fs.MAX, fs.LINF):
            assert bool(np.isnan(got[col])) == has_nan
            np.testing.assert_array_equal(got[col], ref[col])


def test_moments_split_past_one_launch_matches_jax():
    """``engine.step._moments`` over more than ``MAX_SEGMENTS`` segments
    (two launches' worth on the card, empty and one-value segments among
    them) is row for row the twin over all of them, and within the file's
    tolerances of JAX's ``fused_moments(interpret=True)``."""
    from trustworthy_dl_tpu_torch.engine.step import _moments

    rng = np.random.default_rng(21)
    sizes = rng.integers(0, 70, fs.MAX_SEGMENTS + 37)
    sizes[[0, fs.MAX_SEGMENTS - 1, fs.MAX_SEGMENTS]] = (0, 1, 66_000)
    xs = [(rng.standard_normal(int(n)) * 0.05).astype(np.float32)
          for n in sizes]
    segs = [torch.from_numpy(x) for x in xs]
    got = _moments(segs)
    assert got.shape == (len(xs), 8)
    np.testing.assert_array_equal(got.numpy(),
                                  fs.fused_moments_plain(segs).numpy())
    empty = [0, 0, 0, 0, np.inf, -np.inf, 0, 0]
    for row, x in zip(got.numpy(), xs):
        if x.size == 0:
            np.testing.assert_array_equal(row, empty)
            continue
        ref = np.array([float(v) for v in jfused(jnp.asarray(x),
                                                 interpret=True)])
        _check_moments(row, ref, x)


def test_moments_ab_helpers():
    """``utils/moments_ab``'s reading of a variant, its loading of another
    checkout's wrapper, its split, and its bound."""
    from pathlib import Path

    from trustworthy_dl_tpu_torch.utils import moments_ab as mab

    source = (Path(fs.__file__).parent / "csrc" / "fused_stats.cu"
              ).read_text()
    assert mab.parse_variant("DIAG=2") == 2
    assert "TDDL_B1_DIAG" in source
    for spec in ("LOADS=2", "CHUNK=65536", "DIAG=x"):
        with pytest.raises(ValueError):
            mab.parse_variant(spec)
    # This checkout as the other: its wrapper, loaded apart, keeps its cap
    # and runs the twin on CPU tensors without touching the library.
    other = mab.other_wrapper(Path(fs.__file__).parents[2], lib=None)
    assert other is not fs and other.MAX_SEGMENTS == fs.MAX_SEGMENTS
    assert other.kernel_library("fused_stats") is None
    segs = [torch.linspace(-1.0, 1.0, 9), torch.zeros(0)]
    np.testing.assert_array_equal(other.fused_moments(segs).numpy(),
                                  fs.fused_moments_plain(segs).numpy())
    calls = []
    segs = [torch.full((i + 1,), float(i)) for i in range(5)]
    out = mab.split(lambda part: calls.append(len(part)) or
                    fs.fused_moments(part), segs, 2)
    assert calls == [2, 2, 1]
    np.testing.assert_array_equal(out.numpy(),
                                  fs.fused_moments_plain(segs).numpy())
    ms, by = mab.bound_ms([torch.zeros(1000), torch.zeros(24)])
    assert by == "bytes"
    assert ms == pytest.approx((1024 * 4 + 2 * 32) / mab.HBM_BYTES_PER_S
                               * 1e3)


def test_leafwise_battery_matches_jax():
    rng = np.random.default_rng(11)
    leaves = [(rng.standard_normal(n) * s).astype(np.float32)
              for n, s in ((3000, 0.1), (40_000, 0.02), (17, 1.0))]
    j_stats, j_norms, j_finite, j_sample = jst.leafwise_statistics(
        [jnp.asarray(x) for x in leaves], max_sort=2048)
    t_stats, t_norms, t_finite, t_sample = st.leafwise_statistics(
        [torch.from_numpy(x) for x in leaves], max_sort=2048)
    np.testing.assert_array_equal(t_sample.numpy(), np.asarray(j_sample))
    np.testing.assert_allclose(t_norms.numpy(), np.asarray(j_norms),
                               rtol=1e-5)
    assert bool(t_finite) == bool(j_finite)
    j_stats = np.asarray(j_stats)
    t_stats = t_stats.numpy()
    scale = abs(j_stats[st.STAT_INDEX["std"]])
    kurt = st.STAT_INDEX["kurtosis"]
    keep = [i for i in range(st.NUM_TENSOR_STATS) if i != kurt]
    np.testing.assert_allclose(t_stats[keep], j_stats[keep], rtol=1e-4,
                               atol=1e-4 * scale)
    np.testing.assert_allclose(t_stats[kurt], j_stats[kurt], rtol=1e-3)


def test_consensus_checks_match_jax():
    rng = np.random.default_rng(5)
    sig = rng.random((4, 29)).astype(np.float32)
    sig[2] = rng.standard_normal(29).astype(np.float32) * 5
    np.testing.assert_array_equal(
        st.byzantine_verdicts(torch.from_numpy(sig)).numpy(),
        np.asarray(jst.byzantine_verdicts(jnp.asarray(sig))))
    ml = rng.standard_normal((4, 29)).astype(np.float32)
    cons = ml.mean(axis=0, keepdims=True)
    for m in ml:
        np.testing.assert_allclose(
            float(st.backdoor_divergence(torch.from_numpy(m[None]),
                                         torch.from_numpy(cons))),
            float(jst.backdoor_divergence(jnp.asarray(m[None]),
                                          jnp.asarray(cons))), rtol=1e-5)
    flat = rng.standard_normal(1001).astype(np.float32)
    np.testing.assert_allclose(
        float(st.chunked_cosine_mean(torch.from_numpy(flat))),
        float(jst.chunked_cosine_mean(jnp.asarray(flat))), atol=1e-6)


def test_microbatch_combine_matches_jax():
    """Order statistics keep their own reducers, the rest average."""
    stacked = np.random.default_rng(8).standard_normal(
        (3, st.NUM_GRADIENT_STATS)).astype(np.float32)
    np.testing.assert_allclose(
        st.combine_microbatch_stats(torch.from_numpy(stacked)).numpy(),
        np.asarray(jst.combine_microbatch_stats(jnp.asarray(stacked))),
        rtol=1e-6)


def test_baseline_tensors_follow_the_state_device():
    """The ring, the counts and every index the functions build live on
    the device the state was made on; nothing defaults to the CPU."""
    with pytest.raises(TypeError):
        bl.init_baseline_state(2, 3, 4)           # the device is required
    state = bl.init_baseline_state(2, 3, 4, device="cpu")
    state = bl.push_stats(state, torch.ones(2, 4),
                          mask=torch.tensor([True, False]))
    mean, std, valid = bl.baseline_moments(state)
    for t in (*state, mean, std, valid):
        assert t.device.type == "cpu"
    assert valid.tolist() == [1, 0]
