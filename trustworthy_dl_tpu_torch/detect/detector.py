"""In-step attack verdicts: z-scores against rolling baselines, the
rule-based classifier and the attribution ladder.

Counterpart of the pure layer of ``trustworthy_dl_tpu/detect/detector.py``:
per-stat |z| against the node's rolling baseline, evidence at z > 3, attack
iff mean z exceeds 2.5 widened by (1 + 8 / k) for a k-sample baseline,
after the warm-up.  The epoch-cadence ML tier and the host
``AttackDetector`` API are not ported yet.
"""

from __future__ import annotations

import enum
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from trustworthy_dl_tpu_torch.detect import baseline as bl
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.detect.baseline import BaselineState

EVIDENCE_Z = 3.0
ANOMALY_SCORE = 2.5
CONFIDENCE_SCALE = 5.0
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


__all__ = [
    "ANOMALY_SCORE", "AttackType", "EVIDENCE_Z", "Verdicts", "WARMUP",
    "anomaly_verdicts", "attribute_attack", "classify_attack",
    "classify_attack_dominant",
]
