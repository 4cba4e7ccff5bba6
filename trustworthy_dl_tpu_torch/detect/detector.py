"""Attack detection: the in-step verdict math and the host API.

Counterpart of ``trustworthy_dl_tpu/detect/detector.py``.  The in-step
layer: per-stat |z| against the node's rolling baseline, evidence at
z > 3, attack iff mean z exceeds 2.5 widened by (1 + 8 / k) for a
k-sample baseline, after the warm-up, with the rule-based classifier and
the attribution ladder.

The host :class:`AttackDetector` keeps the JAX package's whole public API
(output, gradient, Byzantine and backdoor checks over host histories,
statistics, export) and its epoch-cadence ML tier: a per-node
IsolationForest over the joined output and gradient battery histories.
Its tensor math runs on the detector's ``device``.  scikit-learn is
imported only inside the ML methods; without it the tier stays off, as in
JAX.
"""

from __future__ import annotations

import enum
import functools
import logging
import time
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.detect.baseline import BaselineState
from trustworthy_dl_tpu_torch.utils.io import atomic_write_json

logger = logging.getLogger(__name__)

EVIDENCE_Z = 3.0
ANOMALY_SCORE = 2.5
CONFIDENCE_SCALE = 5.0
BYZANTINE_SIMILARITY = 0.5
BACKDOOR_KL = 2.0
WARMUP = 10
SMALL_SAMPLE_WIDEN = 8.0


class AttackType(enum.IntEnum):
    """Attack taxonomy, as an i32 tensor holds it."""

    DATA_POISONING = 0
    MODEL_POISONING = 1
    GRADIENT_POISONING = 2
    BYZANTINE = 3
    BACKDOOR = 4
    ADVERSARIAL_INPUT = 5

    @property
    def label(self) -> str:
        return self.name.lower()


@dataclass
class AttackDetectionResult:
    """One host-API verdict."""

    is_attack: bool
    attack_type: Optional[AttackType]
    confidence: float
    evidence: Dict[str, Any]
    timestamp: float
    node_id: int


class Verdicts(NamedTuple):
    """Vectorised detection outcome for all nodes in one step."""

    is_attack: torch.Tensor      # bool [n]
    attack_type: torch.Tensor    # i32 [n] (valid iff is_attack)
    confidence: torch.Tensor     # f32 [n]
    score: torch.Tensor          # f32 [n] mean |z|
    z: torch.Tensor              # f32 [n, S]
    evidence_mask: torch.Tensor  # bool [n, S] z > 3


def _select(conds, values, default: torch.Tensor) -> torch.Tensor:
    """``jnp.select``: the value of the first condition that holds."""
    out = default
    for cond, value in reversed(list(zip(conds, values))):
        out = torch.where(cond, value, out)
    return out


def _codes(like: torch.Tensor, code: int) -> torch.Tensor:
    return torch.full(like.shape, int(code), dtype=torch.int32,
                      device=like.device)


def _rule_hits(z: torch.Tensor, evidence_mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(l2_hit, std_hit, shape_hit): the reference rule predicates."""
    i = st.STAT_INDEX
    l2_hit = evidence_mask[..., i["norm_l2"]] & (z[..., i["norm_l2"]] > 5.0)
    std_hit = evidence_mask[..., i["std"]] & (z[..., i["std"]] > 4.0)
    shape_hit = evidence_mask[..., i["skewness"]] | \
        evidence_mask[..., i["kurtosis"]]
    return l2_hit, std_hit, shape_hit


def classify_attack(z: torch.Tensor, evidence_mask: torch.Tensor
                    ) -> torch.Tensor:
    """norm_l2 z > 5 -> GRADIENT_POISONING; std z > 4 -> DATA_POISONING;
    skew/kurtosis evidence -> ADVERSARIAL_INPUT; else BYZANTINE."""
    hits = _rule_hits(z, evidence_mask)
    like = hits[0]
    return _select(hits, [_codes(like, AttackType.GRADIENT_POISONING),
                          _codes(like, AttackType.DATA_POISONING),
                          _codes(like, AttackType.ADVERSARIAL_INPUT)],
                   _codes(like, AttackType.BYZANTINE))


def _rule_fired(z: torch.Tensor, evidence_mask: torch.Tensor
                ) -> torch.Tensor:
    l2_hit, std_hit, shape_hit = _rule_hits(z, evidence_mask)
    return l2_hit | std_hit | shape_hit


@functools.lru_cache(maxsize=None)
def _family_types(device: torch.device) -> torch.Tensor:
    """i32 [3]: the attack code of each evidence family, built once per
    device (a fresh ``torch.tensor`` on a card is a blocking copy in
    every step).  Read only."""
    return torch.tensor([int(AttackType.GRADIENT_POISONING),
                         int(AttackType.DATA_POISONING),
                         int(AttackType.ADVERSARIAL_INPUT)],
                        dtype=torch.int32, device=device)


def classify_attack_dominant(z_grad: torch.Tensor, z_out: torch.Tensor
                             ) -> torch.Tensor:
    """The family whose signature columns carry the dominant z (norm ->
    GRADIENT_POISONING, dispersion -> DATA_POISONING, shape ->
    ADVERSARIAL_INPUT); BYZANTINE when none reaches z 1."""
    i = st.STAT_INDEX
    norm_sig = torch.maximum(torch.maximum(z_grad[..., i["norm_l2"]],
                                           z_grad[..., i["norm_l1"]]),
                             z_grad[..., i["norm_inf"]])
    data_sig = torch.maximum(z_out[..., i["std"]], z_grad[..., i["std"]])
    shape_sig = torch.maximum(
        torch.maximum(z_out[..., i["skewness"]], z_out[..., i["kurtosis"]]),
        torch.maximum(z_grad[..., i["skewness"]],
                      z_grad[..., i["kurtosis"]]))
    fams = torch.stack([norm_sig, data_sig, shape_sig], dim=-1)
    types = _family_types(z_grad.device)
    best = fams.argmax(dim=-1)
    return torch.where(fams.amax(dim=-1) >= 1.0, types[best],
                       _codes(norm_sig, AttackType.BYZANTINE))


def attribute_attack(grad_v: Verdicts, out_v: Verdicts, byz: torch.Tensor,
                     backdoor: torch.Tensor,
                     loss_outlier: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """i32 [n] attribution ladder: a battery's own rule label where one of
    its rules fired, then backdoor, Byzantine and loss detachment, else
    the dominant signature family."""
    grad_rule = grad_v.is_attack & _rule_fired(grad_v.z, grad_v.evidence_mask)
    out_rule = out_v.is_attack & _rule_fired(out_v.z, out_v.evidence_mask)
    if loss_outlier is None:
        loss_outlier = torch.zeros_like(byz)
    like = grad_v.attack_type
    return _select(
        [grad_rule, out_rule, backdoor, byz, loss_outlier],
        [grad_v.attack_type, out_v.attack_type,
         _codes(like, AttackType.BACKDOOR), _codes(like, AttackType.BYZANTINE),
         _codes(like, AttackType.DATA_POISONING)],
        classify_attack_dominant(grad_v.z, out_v.z))


def anomaly_verdicts(current_stats: torch.Tensor, state: BaselineState,
                     warmup: int = WARMUP,
                     score_threshold: float = ANOMALY_SCORE) -> Verdicts:
    """[n, S] current stats against the rolling baselines (the window
    before this step's stats are pushed)."""
    mean, std, valid = bl.baseline_moments(state)
    z = bl.zscores(current_stats, mean, std)
    usable = std > 0
    n_usable = usable.sum(dim=-1).clamp(min=1)
    score = torch.where(usable, z, torch.zeros_like(z)).sum(dim=-1) / n_usable
    threshold_eff = score_threshold * (
        1.0 + SMALL_SAMPLE_WIDEN / valid.float().clamp(min=1.0))
    is_attack = (score > threshold_eff) & (valid >= warmup)
    evidence = (z > EVIDENCE_Z) & usable
    return Verdicts(is_attack=is_attack,
                    attack_type=classify_attack(z, evidence),
                    confidence=(score / CONFIDENCE_SCALE).clamp(max=1.0),
                    score=score, z=z, evidence_mask=evidence)


def push_then_detect(state: BaselineState, current_stats: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     warmup: int = WARMUP,
                     score_threshold: float = ANOMALY_SCORE
                     ) -> Tuple[BaselineState, Verdicts]:
    """The reference's order: push this step's stats, rebuild the baseline
    over the window that now holds them, then score; a node ``mask``
    skips is never an attack."""
    state = bl.push_stats(state, current_stats, mask)
    verdicts = anomaly_verdicts(current_stats, state, warmup,
                                score_threshold)
    if mask is not None:
        verdicts = verdicts._replace(
            is_attack=verdicts.is_attack & mask.bool())
    return state, verdicts


# ---------------------------------------------------------------------------
# Host-facing API
# ---------------------------------------------------------------------------


class AttackDetector:
    """Attack detection over host histories, node by node.  ``device`` is
    where the statistic batteries run: the card by default (it raises
    without CUDA unless ``device="cpu"``); the trainer passes its own."""

    # The ML tier's hyperparameters, the JAX package's.
    ML_MIN_SAMPLES = 50
    ML_ISOFOREST_KW = dict(contamination=0.1, random_state=42,
                           n_estimators=100)
    ML_DBSCAN_KW = dict(eps=0.5, min_samples=5)

    def __init__(self, detection_threshold: float = 0.8,
                 history_size: int = 1000, exact_order_stats: bool = True,
                 device: Any = "cuda"):
        from trustworthy_dl_tpu_torch.serve.engine import resolve_device

        self.detection_threshold = detection_threshold
        self.history_size = history_size
        self.exact_order_stats = exact_order_stats
        self.device = resolve_device(device)
        self.output_history: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=history_size))
        self.gradient_history: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=history_size))
        self.loss_history: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=history_size))
        self.output_baselines: Dict[int, Dict] = defaultdict(dict)
        self.gradient_baselines: Dict[int, Dict] = defaultdict(dict)
        self.anomaly_detectors: Dict[int, Any] = {}
        self.clustering_models: Dict[int, Any] = {}
        self._model_keys: Dict[int, list] = {}   # fit-time feature order
        self.detection_stats: Dict[str, Any] = {
            "total_detections": 0, "false_positives": 0,
            "true_positives": 0, "attack_types": defaultdict(int)}
        logger.info("AttackDetector initialized")

    # -- stats helpers ---------------------------------------------------

    def _tensor(self, x: Any) -> torch.Tensor:
        """``x`` (a tensor or anything numpy reads) as f32 on the
        detector's device."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

    def calculate_tensor_statistics(self, tensor: Any) -> Dict[str, float]:
        """The 12-stat battery as a dict."""
        vals = st.tensor_statistics(self._tensor(tensor),
                                    self.exact_order_stats).tolist()
        return dict(zip(st.TENSOR_STAT_NAMES, vals))

    def calculate_gradient_statistics(self, gradients: Sequence[Any]
                                      ) -> Dict[str, float]:
        """The 17-stat battery as a dict ({} for no gradients)."""
        if not gradients:
            return {}
        vals = st.gradient_statistics([self._tensor(g) for g in gradients],
                                      self.exact_order_stats).tolist()
        return dict(zip(st.GRADIENT_STAT_NAMES, vals))

    # -- detection entry points --------------------------------------------

    def detect_output_anomaly(self, output: Any, node_id: int, step: int
                              ) -> bool:
        """Score a node's output against its history (a missing output is
        an attack)."""
        if output is None:
            return True
        stats_d = self.calculate_tensor_statistics(output)
        self.output_history[node_id].append(
            {"step": step, "stats": stats_d, "timestamp": time.time()})
        if len(self.output_history[node_id]) < WARMUP:
            return False
        self._update_baseline(node_id, self.output_history,
                              self.output_baselines)
        result = self._detect_statistical_anomaly(
            stats_d, self.output_baselines[node_id], node_id)
        if result.is_attack:
            logger.warning("Output anomaly detected on node %d: %s", node_id,
                           result.attack_type)
            self.detection_stats["total_detections"] += 1
            self.detection_stats["attack_types"][result.attack_type.label] \
                += 1
        return result.is_attack

    def detect_gradient_poisoning(self, gradients: Sequence[Any],
                                  node_id: int, step: int) -> bool:
        """Score a node's gradients against its history."""
        if gradients is None or len(gradients) == 0:
            return False
        stats_d = self.calculate_gradient_statistics(gradients)
        self.gradient_history[node_id].append(
            {"step": step, "stats": stats_d, "timestamp": time.time()})
        if len(self.gradient_history[node_id]) < WARMUP:
            return False
        self._update_baseline(node_id, self.gradient_history,
                              self.gradient_baselines)
        result = self._detect_statistical_anomaly(
            stats_d, self.gradient_baselines[node_id], node_id)
        if result.is_attack:
            logger.warning("Gradient poisoning detected on node %d", node_id)
            self.detection_stats["total_detections"] += 1
        return result.is_attack

    def detect_byzantine_behavior(self, node_outputs: Dict[int, Any],
                                  step: int) -> List[int]:
        """Nodes whose mean cosine similarity to the others falls below
        :data:`BYZANTINE_SIMILARITY` (needs >= 3 nodes).  Equal-length
        outputs go through one device call.  Ragged outputs compare each
        pair over its common prefix, normalised by both full norms, so mass
        outside the shared support counts against its owner."""
        if len(node_outputs) < 3:
            return []
        ids = sorted(node_outputs)
        flat = [self._tensor(node_outputs[i]).reshape(-1) for i in ids]
        lengths = {int(f.shape[0]) for f in flat}
        if len(lengths) == 1 and 0 not in lengths:
            verdicts = st.byzantine_verdicts(torch.stack(flat),
                                             BYZANTINE_SIMILARITY).tolist()
        else:
            host = [f.cpu().numpy() for f in flat]
            n = len(host)
            norms = np.array([np.linalg.norm(f) for f in host])
            sims = np.zeros((n, n), np.float64)
            for a in range(n):
                for c in range(a + 1, n):
                    w = min(host[a].shape[0], host[c].shape[0])
                    denom = norms[a] * norms[c]
                    sim = float(host[a][:w] @ host[c][:w] / denom) \
                        if w and denom > 0 else 0.0
                    sims[a, c] = sims[c, a] = sim
            verdicts = (sims.sum(axis=1) / (n - 1)
                        < BYZANTINE_SIMILARITY).tolist()
        byzantine = [i for i, flag in zip(ids, verdicts) if flag]
        for node_id in byzantine:
            logger.warning("Byzantine behavior detected on node %d", node_id)
        return byzantine

    def detect_backdoor_attack(self, model_outputs: Any,
                               expected_outputs: Any, node_id: int) -> bool:
        """KL divergence of the model's outputs from the expected ones
        above :data:`BACKDOOR_KL`."""
        if model_outputs is None or expected_outputs is None:
            return False
        flagged = bool(st.detect_backdoor(self._tensor(model_outputs),
                                          self._tensor(expected_outputs),
                                          BACKDOOR_KL))
        if flagged:
            logger.warning("Potential backdoor attack detected on node %d",
                           node_id)
        return flagged

    # -- baseline & scoring ----------------------------------------------

    def _update_baseline(self, node_id: int, history: Dict[int, deque],
                         baselines: Dict[int, Dict]) -> None:
        """Per-stat aggregates over the node's window."""
        entries = list(history[node_id])
        if len(entries) < WARMUP:
            return
        agg: Dict[str, List[float]] = defaultdict(list)
        for entry in entries:
            for name, value in entry["stats"].items():
                agg[name].append(value)
        baselines[node_id] = {
            name: {"mean": float(np.mean(vals)), "std": float(np.std(vals)),
                   "min": float(np.min(vals)), "max": float(np.max(vals)),
                   "percentile_5": float(np.percentile(vals, 5)),
                   "percentile_95": float(np.percentile(vals, 95))}
            for name, vals in agg.items()}

    def _detect_statistical_anomaly(self, current_stats: Dict[str, float],
                                    baseline: Dict[str, Dict], node_id: int
                                    ) -> AttackDetectionResult:
        """Mean |z| over the stats with a usable baseline; evidence at
        z > 3; attack past 2.5."""
        if not baseline:
            return AttackDetectionResult(False, None, 0.0, {}, time.time(),
                                         node_id)
        scores = []
        evidence: Dict[str, Any] = {}
        for name, value in current_stats.items():
            base = baseline.get(name)
            if base is None or base["std"] <= 0:
                continue
            z = abs((value - base["mean"]) / base["std"])
            scores.append(z)
            if z > EVIDENCE_Z:
                evidence[name] = {"z_score": z, "current_value": value,
                                  "baseline_mean": base["mean"],
                                  "baseline_std": base["std"]}
        overall = float(np.mean(scores)) if scores else 0.0
        is_attack = overall > ANOMALY_SCORE
        attack_type = self._classify_attack_type(evidence)
        return AttackDetectionResult(
            is_attack=is_attack,
            attack_type=attack_type if is_attack else None,
            confidence=min(1.0, overall / CONFIDENCE_SCALE),
            evidence=evidence, timestamp=time.time(), node_id=node_id)

    def _classify_attack_type(self, evidence: Dict) -> Optional[AttackType]:
        """The rule classifier over an evidence dict."""
        if not evidence:
            return None
        if "norm_l2" in evidence and evidence["norm_l2"]["z_score"] > 5:
            return AttackType.GRADIENT_POISONING
        if "std" in evidence and evidence["std"]["z_score"] > 4:
            return AttackType.DATA_POISONING
        if "skewness" in evidence or "kurtosis" in evidence:
            return AttackType.ADVERSARIAL_INPUT
        return AttackType.BYZANTINE

    # -- the ML tier -------------------------------------------------------

    @staticmethod
    def _joined_stats(out_entry: Optional[Dict],
                      grad_entry: Optional[Dict]) -> Dict[str, float]:
        """One feature row from the output battery and (when present) the
        gradient battery, namespaced ``out:`` / ``grad:``."""
        row: Dict[str, float] = {}
        if out_entry is not None:
            row.update({f"out:{k}": v for k, v in out_entry["stats"].items()})
        if grad_entry is not None:
            row.update({f"grad:{k}": v
                        for k, v in grad_entry["stats"].items()})
        return row

    def _node_feature_matrix(self, node_id: int) -> Optional[tuple]:
        """(keys, [t, d] f64 matrix) of one node's joined battery history
        in sorted-key column order, or None below ``ML_MIN_SAMPLES``.
        Histories of unequal length are aligned at their newest
        entries."""
        out_h = self.output_history.get(node_id)
        if out_h is None or len(out_h) < self.ML_MIN_SAMPLES:
            return None
        grad_h = list(self.gradient_history.get(node_id) or ())
        offset = len(out_h) - len(grad_h)
        joined = [
            self._joined_stats(
                entry,
                grad_h[i - offset] if 0 <= i - offset < len(grad_h) else None)
            for i, entry in enumerate(out_h)]
        keys = sorted(joined[-1])
        return keys, np.asarray([[row.get(k, 0.0) for k in keys]
                                 for row in joined], dtype=np.float64)

    def latest_features(self, node_id: int) -> Optional[Dict[str, float]]:
        """The newest joined feature row of a node."""
        out_h = self.output_history.get(node_id)
        if not out_h:
            return None
        grad_h = self.gradient_history.get(node_id)
        return self._joined_stats(out_h[-1], grad_h[-1] if grad_h else None)

    def update_detection_models(self, fit_clustering: bool = False) -> None:
        """Refit each node's IsolationForest on its feature history (and,
        with ``fit_clustering``, a DBSCAN that nothing queries); a no-op
        for nodes below ``ML_MIN_SAMPLES`` or without scikit-learn."""
        try:
            from sklearn.cluster import DBSCAN
            from sklearn.ensemble import IsolationForest
        except ImportError:
            logger.debug("detect: no sklearn in env, ML tier stays off")
            return
        fitted = 0
        for node_id in list(self.output_history):
            features = self._node_feature_matrix(node_id)
            if features is None:
                continue
            keys, matrix = features
            self._model_keys[node_id] = keys
            self.anomaly_detectors[node_id] = IsolationForest(
                **self.ML_ISOFOREST_KW).fit(matrix)
            if fit_clustering:
                self.clustering_models[node_id] = DBSCAN(
                    **self.ML_DBSCAN_KW).fit(matrix)
            fitted += 1
        if fitted:
            logger.info("detect: refit ML detectors for %d node(s)", fitted)

    def detect_with_ml_models(self, stats: Dict[str, float], node_id: int
                              ) -> bool:
        """Score one feature dict against the node's fitted model; False
        while it has none.  A dict without ``out:``/``grad:`` prefixes is
        an output battery."""
        model = self.anomaly_detectors.get(node_id)
        if model is None:
            return False
        if stats and not any(":" in k for k in stats):
            stats = {f"out:{k}": v for k, v in stats.items()}
        keys = self._model_keys.get(node_id) or sorted(stats)
        vec = np.asarray([stats.get(k, 0.0) for k in keys],
                         dtype=np.float64)[None, :]
        verdict = bool(model.predict(vec)[0] == -1)
        if verdict:
            logger.debug("detect: ML verdict anomalous for node %d "
                         "(score=%.4f)", node_id,
                         float(model.decision_function(vec)[0]))
        return verdict

    # -- statistics / maintenance ------------------------------------------

    def get_detection_statistics(self) -> Dict:
        total = self.detection_stats["total_detections"]
        return {
            "total_detections": total,
            "false_positive_rate": self.detection_stats["false_positives"]
            / max(1, total),
            "true_positive_rate": self.detection_stats["true_positives"]
            / max(1, total),
            "attack_type_distribution": dict(
                self.detection_stats["attack_types"]),
            "nodes_monitored": len(self.output_history),
            "average_history_length": float(np.mean(
                [len(h) for h in self.output_history.values()]))
            if self.output_history else 0,
        }

    def set_detection_threshold(self, threshold: float) -> None:
        self.detection_threshold = float(np.clip(threshold, 0.0, 1.0))
        logger.info("Detection threshold updated to %s",
                    self.detection_threshold)

    def reset_node_history(self, node_id: int) -> None:
        if node_id in self.output_history:
            self.output_history[node_id].clear()
        if node_id in self.gradient_history:
            self.gradient_history[node_id].clear()
        self.output_baselines.pop(node_id, None)
        self.gradient_baselines.pop(node_id, None)
        logger.info("Detection history reset for node %d", node_id)

    def export_detection_data(self, filepath: str) -> None:
        stats = self.detection_stats
        export_data = {
            "detection_stats": {
                **{k: v for k, v in stats.items() if k != "attack_types"},
                "attack_types": dict(stats["attack_types"])},
            "baselines": {
                "output": {str(k): v
                           for k, v in self.output_baselines.items()},
                "gradient": {str(k): v
                             for k, v in self.gradient_baselines.items()}},
            "history_lengths": {str(node_id): len(history) for node_id,
                                history in self.output_history.items()},
        }
        atomic_write_json(filepath, export_data)
        logger.info("Detection data exported to %s", filepath)

    def cleanup(self) -> None:
        self.output_history.clear()
        self.gradient_history.clear()
        self.loss_history.clear()
        self.anomaly_detectors.clear()
        self.clustering_models.clear()
        logger.info("AttackDetector cleanup completed")


__all__ = [
    "ANOMALY_SCORE", "AttackDetectionResult", "AttackDetector", "AttackType",
    "BACKDOOR_KL", "BYZANTINE_SIMILARITY", "EVIDENCE_Z", "Verdicts", "WARMUP",
    "anomaly_verdicts", "attribute_attack", "classify_attack",
    "classify_attack_dominant", "push_then_detect",
]
