"""Tensor and gradient statistic batteries of the in-step detector.

Counterpart of ``trustworthy_dl_tpu/detect/stats.py`` (the parts the
training step runs).  The battery of a list of flattened f32 leaves is
built from per-leaf raw moments (kernel B1, ``ops/fused_stats``) combined
across leaves, plus order statistics over a deterministic subsample, so
the concatenated vector is never materialised.  Stat order is fixed and
indexed by name so the rule-based classifier can address columns.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from trustworthy_dl_tpu_torch.ops import fused_stats as fs

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


__all__ = [
    "GRADIENT_STAT_NAMES", "NUM_GRADIENT_STATS", "NUM_TENSOR_STATS",
    "STAT_INDEX", "TENSOR_STAT_NAMES", "backdoor_divergence",
    "byzantine_verdicts", "chunked_cosine_mean", "combine_microbatch_stats",
    "leafwise_statistics", "pairwise_cosine_matrix", "quantiles_from_sorted",
    "strided_sample_of_leaves",
]
