"""Attack detection: the statistic batteries, rolling baselines, the
in-step verdicts, gradient verification and the host ``AttackDetector``
with its ML tier.  The names below resolve at first access (``_lazy``)."""

from trustworthy_dl_tpu_torch._lazy import lazy_exports

__all__, __getattr__, __dir__ = lazy_exports(__name__, {
    "detect.baseline": ("BaselineState", "baseline_moments",
                        "init_baseline_state", "push_stats", "zscores"),
    "detect.detector": ("AttackDetectionResult", "AttackDetector",
                        "AttackType", "Verdicts", "anomaly_verdicts",
                        "classify_attack", "push_then_detect"),
    "detect.stats": ("GRADIENT_STAT_NAMES", "NUM_GRADIENT_STATS",
                     "NUM_TENSOR_STATS", "STAT_INDEX", "TENSOR_STAT_NAMES",
                     "backdoor_divergence", "byzantine_verdicts",
                     "detect_backdoor", "gradient_statistics",
                     "padded_tensor_statistics", "pairwise_cosine_matrix",
                     "tensor_statistics"),
    "detect.verifier": ("GradientVerifier", "VerifierState", "absorb_norms",
                        "init_verifier_state", "norm_suspicions",
                        "verify_gradients_array"),
})
