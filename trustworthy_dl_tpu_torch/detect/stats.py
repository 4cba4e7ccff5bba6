"""Tensor and gradient statistic batteries of the detector.

Counterpart of ``trustworthy_dl_tpu/detect/stats.py``.  The training
step's battery of a list of flattened f32 leaves is built from per-leaf
raw moments (kernel B1, ``ops/fused_stats``) combined across leaves, plus
order statistics over a deterministic subsample, so the concatenated
vector is never materialised.  The host detector's batteries
(:func:`tensor_statistics`, :func:`gradient_statistics`) are the direct,
centred formulas over the whole tensor.  Stat order is fixed and indexed
by name so the rule-based classifier can address columns.

Order statistics follow ``jnp.median`` / ``jnp.percentile``: linear
interpolation between the two neighbours of a sorted vector, so an even
count's median is the mean of the two middle values (``torch.median``
returns the lower one), and a sort stands in for ``torch.quantile``, which
refuses inputs past 2^24 elements.  Standard deviations are population
ones (``correction=0``), as in JAX.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from trustworthy_dl_tpu_torch.ops import fused_stats as fs
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

TENSOR_STAT_NAMES: Tuple[str, ...] = (
    "mean", "std", "min", "max", "median", "skewness", "kurtosis",
    "percentile_25", "percentile_75", "norm_l1", "norm_l2", "norm_inf",
)
GRADIENT_STAT_NAMES: Tuple[str, ...] = TENSOR_STAT_NAMES + (
    "num_gradients", "grad_norms_mean", "grad_norms_std", "grad_norms_max",
    "cosine_similarity",
)
NUM_TENSOR_STATS = len(TENSOR_STAT_NAMES)      # 12
NUM_GRADIENT_STATS = len(GRADIENT_STAT_NAMES)  # 17
STAT_INDEX = {name: i for i, name in enumerate(GRADIENT_STAT_NAMES)}


def _order_stats(x: torch.Tensor) -> List[torch.Tensor]:
    """(p25, median, p75) of a flat vector, from one sort."""
    return quantiles_from_sorted(torch.sort(x).values, (25, 50, 75))


def tensor_statistics(x: torch.Tensor, exact_order_stats: bool = True
                      ) -> torch.Tensor:
    """f32 [12] statistics of a flattened tensor.  Skewness and kurtosis
    are the biased (population) estimators, kurtosis Fisher's.  Without
    ``exact_order_stats`` the median is the mean and the quartiles
    mean -/+ 0.6745 std (the Gaussian approximation)."""
    x = x.reshape(-1).float()
    mean = x.mean()
    centered = x - mean
    # Integer powers as products, XLA's rounding of ``x ** k``.
    c2 = centered * centered
    std = c2.mean().sqrt()
    safe = torch.where(std > 0, std, torch.ones_like(std))
    safe2 = safe * safe
    m3 = (c2 * centered).mean()
    m4 = (c2 * c2).mean()
    skew = torch.where(std > 0, m3 / (safe2 * safe), torch.zeros_like(std))
    kurt = torch.where(std > 0, m4 / (safe2 * safe2) - 3.0,
                       torch.full_like(std, -3.0))
    if exact_order_stats:
        p25, median, p75 = _order_stats(x)
    else:
        median = mean
        p25 = mean - 0.6744898 * std
        p75 = mean + 0.6744898 * std
    absx = x.abs()
    return torch.stack([mean, std, x.min(), x.max(), median, skew, kurt,
                        p25, p75, absx.sum(), (x * x).sum().sqrt(),
                        absx.max()])


def tensor_statistics_sampled(x: torch.Tensor, max_sort: int = 65536
                              ) -> torch.Tensor:
    """f32 [12]: moments, extrema and norms over the whole tensor, order
    statistics over a strided subsample of at most ``max_sort`` elements
    (every ``n // max_sort``-th element from the first)."""
    x = x.reshape(-1).float()
    full = tensor_statistics(x, exact_order_stats=False)
    n = x.shape[0]
    if n <= max_sort:
        sample = x
    else:
        stride = n // max_sort
        sample = x[:max_sort * stride:stride]
    p25, median, p75 = _order_stats(sample)
    out = full.clone()
    out[TENSOR_STAT_NAMES.index("median")] = median
    out[TENSOR_STAT_NAMES.index("percentile_25")] = p25
    out[TENSOR_STAT_NAMES.index("percentile_75")] = p75
    return out


def _stats_from_raw_moments(s1, s2, s3, s4, mn, mx, l1, linf, count,
                            median, p25, p75) -> torch.Tensor:
    """The f32 [12] battery from raw-moment sums (single pass; gradients
    are near zero-mean, so the cancellation is negligible)."""
    n = max(float(count), 1.0)
    mean = s1 / n
    ex2, ex3, ex4 = s2 / n, s3 / n, s4 / n
    std = (ex2 - mean * mean).clamp(min=0.0).sqrt()
    safe = torch.where(std > 0, std, torch.ones_like(std))
    m3 = ex3 - 3.0 * mean * ex2 + 2.0 * mean ** 3
    m4 = ex4 - 4.0 * mean * ex3 + 6.0 * mean ** 2 * ex2 - 3.0 * mean ** 4
    skew = torch.where(std > 0, m3 / safe ** 3, torch.zeros_like(std))
    kurt = torch.where(std > 0, m4 / safe ** 4 - 3.0,
                       torch.full_like(std, -3.0))
    return torch.stack([mean, std, mn, mx, median, skew, kurt, p25, p75,
                        l1, s2.sqrt(), linf])


def strided_sample_of_leaves(leaves: Sequence[torch.Tensor], max_sort: int,
                             n_chunks: int = 16) -> torch.Tensor:
    """Deterministic <= ~max_sort-element subsample across flattened
    leaves, proportional to leaf size: up to ``n_chunks`` contiguous chunks
    spread evenly over each leaf (the same slices as the JAX package)."""
    total = sum(int(f.shape[0]) for f in leaves)
    if total <= max_sort:
        return torch.cat(list(leaves)) if len(leaves) > 1 else leaves[0]
    out = []
    for f in leaves:
        sz = int(f.shape[0])
        if sz == 0:
            continue
        q = min(max(1, (sz * max_sort) // total), sz)
        chunks = max(1, min(n_chunks, q // 1024))
        clen = q // chunks
        if clen == 0:
            chunks, clen = 1, q
        span = sz // chunks
        for i in range(chunks):
            off = min(i * span, sz - clen)
            out.append(f[off:off + clen])
    return torch.cat(out) if len(out) > 1 else out[0]


def quantiles_from_sorted(sorted_x: torch.Tensor, qs: Sequence[float]
                          ) -> List[torch.Tensor]:
    """Linear-interpolated quantiles of an already-sorted vector."""
    n = sorted_x.shape[0]
    out = []
    for q in qs:
        pos = (n - 1) * (q / 100.0)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        frac = pos - lo
        out.append(sorted_x[lo] * (1.0 - frac) + sorted_x[hi] * frac)
    return out


def leafwise_statistics(leaves: Sequence[torch.Tensor], max_sort: int = 16384,
                        moments: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(stats f32 [12], per-leaf L2 norms f32 [k], finite bool [], sample)
    over flattened f32 leaves, from their raw moments: ``moments`` [k, 8]
    when the caller has them (one B1 launch for many nodes), else one B1
    launch here.  Constant under differentiation.  The finite flag derives
    from s1/s2 (a NaN/Inf anywhere reaches both)."""
    with torch.no_grad():
        leaves = [f.detach() for f in leaves]
        if moments is None:
            moments = fs.fused_moments(leaves)
        s1 = moments[:, fs.S1].sum()
        s2_leaf = moments[:, fs.S2]
        s2 = s2_leaf.sum()
        s3 = moments[:, fs.S3].sum()
        s4 = moments[:, fs.S4].sum()
        mn = moments[:, fs.MIN].min()
        mx = moments[:, fs.MAX].max()
        l1 = moments[:, fs.L1].sum()
        linf = moments[:, fs.LINF].max()
        count = sum(int(f.shape[0]) for f in leaves)
        sample = strided_sample_of_leaves(leaves, max_sort).float()
        sorted_sample = torch.sort(sample).values
        p25, median, p75 = quantiles_from_sorted(sorted_sample, (25, 50, 75))
        stats = _stats_from_raw_moments(s1, s2, s3, s4, mn, mx, l1, linf,
                                        count, median, p25, p75)
        finite = torch.isfinite(s1) & torch.isfinite(s2)
        return stats, s2_leaf.sqrt(), finite, sample


def combine_microbatch_stats(stacked: torch.Tensor) -> torch.Tensor:
    """Per-microbatch batteries [accum, k] -> f32 [k]: min keeps min,
    max / norm_inf keep max, the sum-moment columns average."""
    out = stacked.mean(dim=0)
    out[STAT_INDEX["min"]] = stacked[:, STAT_INDEX["min"]].min()
    for name in ("max", "norm_inf"):
        out[STAT_INDEX[name]] = stacked[:, STAT_INDEX[name]].max()
    return out


def chunked_cosine_mean(flat: torch.Tensor, chunks: int = 4) -> torch.Tensor:
    """Mean pairwise cosine similarity among equal chunks of one flattened
    vector (the step's O(P) stand-in for the pairwise battery)."""
    n = flat.shape[0] // chunks
    if n == 0:
        return torch.ones((), device=flat.device)
    mat = flat[: n * chunks].reshape(chunks, n)
    norms = (mat * mat).sum(dim=1).sqrt()
    normed = mat / norms.clamp(min=1e-12)[:, None]
    sim = normed @ normed.T
    return (sim.sum() - sim.trace()) / (chunks * (chunks - 1))


def pairwise_cosine_matrix(outputs: torch.Tensor) -> torch.Tensor:
    """[n, n] cosine similarity between per-node outputs [n, d]."""
    norms = (outputs * outputs).sum(dim=-1, keepdim=True).sqrt()
    normed = outputs / norms.clamp(min=1e-12)
    return normed @ normed.T


def byzantine_verdicts(outputs: torch.Tensor, threshold: float = 0.5
                       ) -> torch.Tensor:
    """bool [n]: mean similarity to the other nodes below ``threshold``
    (needs >= 3 nodes)."""
    n = outputs.shape[0]
    if n < 3:
        return torch.zeros(n, dtype=torch.bool, device=outputs.device)
    sim = pairwise_cosine_matrix(outputs)
    off_diag_mean = (sim.sum(dim=1) - sim.diagonal()) / (n - 1)
    return off_diag_mean < threshold


def backdoor_divergence(model_outputs: torch.Tensor,
                        expected_outputs: torch.Tensor) -> torch.Tensor:
    """Batch-mean KL(log_softmax(model) || softmax(expected))."""
    logp = torch.log_softmax(model_outputs, dim=-1)
    q = torch.softmax(expected_outputs, dim=-1)
    kl = (q * (q.clamp(min=1e-12).log() - logp)).sum(dim=-1)
    batch = model_outputs.reshape(-1, model_outputs.shape[-1]).shape[0]
    return kl.sum() / batch


def _pairwise_cosine_mean(flat_grads: Sequence[torch.Tensor]
                          ) -> torch.Tensor:
    """Mean cosine similarity over every pair of flat tensors (1.0 for
    fewer than two)."""
    k = len(flat_grads)
    if k < 2:
        return torch.ones((), device=flat_grads[0].device if k else None)
    norms = [(g * g).sum().sqrt() for g in flat_grads]
    sims = [(flat_grads[i] * flat_grads[j]).sum()
            / (norms[i] * norms[j]).clamp(min=1e-12)
            for i in range(k) for j in range(i + 1, k)]
    return torch.stack(sims).mean()


def gradient_statistics(gradients: Any, exact_order_stats: bool = True,
                        max_cosine_pairs_tensors: int = 8) -> torch.Tensor:
    """f32 [17] statistics over gradient tensors (a list or a parameter
    tree, leaves in sorted-key order): the 12-stat battery of their
    concatenation, then the tensor count, the mean, population std and
    max of the per-tensor L2 norms, and the mean pairwise cosine
    similarity of the first ``max_cosine_pairs_tensors`` tensors."""
    tree = gradients if isinstance(gradients, dict) else list(gradients)
    grads = [g.reshape(-1).float() for g in tree_leaves(tree)]
    if not grads:
        return torch.zeros(NUM_GRADIENT_STATS)
    base = tensor_statistics(torch.cat(grads), exact_order_stats)
    norms = torch.stack([(g * g).sum().sqrt() for g in grads])
    cos = _pairwise_cosine_mean(grads[:max_cosine_pairs_tensors])
    extra = torch.stack([
        torch.full((), float(len(grads)), device=base.device),
        norms.mean(), norms.std(correction=0), norms.max(), cos])
    return torch.cat([base, extra])


def padded_tensor_statistics(x: torch.Tensor, exact_order_stats: bool = True
                             ) -> torch.Tensor:
    """f32 [17]: the tensor battery padded with zeros to the gradient
    battery's width (one baseline layout for both)."""
    base = tensor_statistics(x, exact_order_stats)
    pad = torch.zeros(NUM_GRADIENT_STATS - NUM_TENSOR_STATS,
                      device=base.device)
    return torch.cat([base, pad])


def detect_backdoor(model_outputs: torch.Tensor,
                    expected_outputs: torch.Tensor, threshold: float = 2.0
                    ) -> torch.Tensor:
    """bool []: the batch-mean KL divergence above ``threshold``."""
    return backdoor_divergence(model_outputs, expected_outputs) > threshold


__all__ = [
    "GRADIENT_STAT_NAMES", "NUM_GRADIENT_STATS", "NUM_TENSOR_STATS",
    "STAT_INDEX", "TENSOR_STAT_NAMES", "backdoor_divergence",
    "byzantine_verdicts", "chunked_cosine_mean", "combine_microbatch_stats",
    "detect_backdoor", "gradient_statistics", "leafwise_statistics",
    "padded_tensor_statistics", "pairwise_cosine_matrix",
    "quantiles_from_sorted", "strided_sample_of_leaves", "tensor_statistics",
    "tensor_statistics_sampled",
]
