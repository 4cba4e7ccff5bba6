"""Adversarial attack injection for experiments.

Counterpart of ``trustworthy_dl_tpu/attacks/adversarial.py``:

* :class:`AttackPlan` - the schedule the training step reads: a per-node
  target mask (a tensor on the step's device) and host scalars, so
  ``plan.is_live(step)`` with the step's host counter needs no device sync;
* :func:`poison_batch` / :func:`poison_gradients` /
  :func:`corrupt_stage_compute` (pipeline stages) - the in-step injectors,
  the JAX package's arithmetic.  Their random draws come from a
  ``torch.Generator`` or from noise tensors the caller passes in (tests
  hand both packages the same draws);
* :class:`AdversarialAttacker` - the host API that compiles an
  :class:`AttackConfig` into plans (``plan``, or ``plan_for`` a live
  node map), poisons host batches for host-driven loops
  (``apply_attacks``, numpy draws from the config's seed) and reports the
  steps it attacked (``get_final_statistics``).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from trustworthy_dl_tpu_torch.core.config import AttackConfig

logger = logging.getLogger(__name__)

ATTACK_KINDS = ("gradient_poisoning", "data_poisoning", "byzantine",
                "backdoor")


class AttackPlan(NamedTuple):
    """Attack schedule of one run; ``active`` flips at ``start_step``."""

    target_mask: torch.Tensor   # bool [n] nodes under attack
    start_step: int
    active: bool
    intensity: float
    grad_poison: bool           # scale + noise gradients
    data_poison: bool           # scramble tokens, shift labels
    byzantine: bool             # replace gradients with noise
    backdoor: bool              # trigger + fixed target label
    ramp: float                 # intensity added per attacked step
    collude: bool               # every attacker draws the same noise

    def is_live(self, step: int) -> bool:
        return bool(self.active) and step >= self.start_step

    def effective_intensity(self, step: int) -> float:
        return self.intensity + self.ramp * max(step - self.start_step, 0)


def null_plan(num_nodes: int, device: Any = "cpu") -> AttackPlan:
    return AttackPlan(torch.zeros(num_nodes, dtype=torch.bool, device=device),
                      0, False, 0.0, False, False, False, False, 0.0, False)


def plan_from_config(config: AttackConfig, num_nodes: int,
                     active: bool = False, device: Any = "cpu"
                     ) -> AttackPlan:
    mask = torch.zeros(num_nodes, dtype=torch.bool)
    for node in config.target_nodes:
        if 0 <= node < num_nodes:
            mask[node] = True
    kinds = set(config.attack_types)
    return AttackPlan(
        target_mask=mask.to(device), start_step=int(config.start_step),
        active=bool(active), intensity=float(config.intensity),
        grad_poison="gradient_poisoning" in kinds,
        data_poison="data_poisoning" in kinds,
        byzantine="byzantine" in kinds, backdoor="backdoor" in kinds,
        ramp=float(config.intensity_ramp), collude=bool(config.collude))


def _node_mask(plan: AttackPlan, x: torch.Tensor) -> torch.Tensor:
    return plan.target_mask.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def poison_batch(plan: AttackPlan, batch: Dict[str, torch.Tensor], step: int,
                 num_classes: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Dict[str, torch.Tensor]:
    """Corrupt the per-node batch {'input': [n, b, ...], 'target':
    [n, b, ...]} of attacked nodes.  Data poisoning adds ``intensity``
    times standard-normal noise to float inputs, or scrambles a share
    ``intensity`` of the tokens, and shifts the labels by one.  Backdoor
    sets a 3x3 corner patch of every image to 2.0 (float [n, b, H, W, C]
    inputs), or zeroes the first four tokens, and sets every label to 0.
    ``noise`` may hold the draws: 'gauss' (float, x's shape), or 'flip'
    (bool, x's shape) and 'scramble' (ints in [0, vocab_guess))."""
    if not plan.is_live(step):
        return batch
    intensity = plan.effective_intensity(step)
    x, y = batch["input"], batch["target"]
    mask_x, mask_y = _node_mask(plan, x), _node_mask(plan, y)
    floating = x.is_floating_point()
    trig = x.clone()         # the backdoor trigger on the clean input
    if not floating:
        trig[..., :4] = 0
    elif x.dim() >= 4:
        trig[..., :3, :3, :] = 2.0
    if plan.data_poison:
        if floating:
            gauss = noise["gauss"].to(x.dtype) if noise is not None else \
                torch.randn(x.shape, generator=generator, device=x.device,
                            dtype=x.dtype)
            noisy = x + intensity * gauss
        else:
            if noise is None:
                vocab_guess = torch.clamp(x.max() + 1, min=num_classes)
                u = torch.rand(x.shape, generator=generator, device=x.device)
                scramble = torch.minimum((u * vocab_guess).long(),
                                         vocab_guess - 1).to(x.dtype)
                flip = torch.rand(x.shape, generator=generator,
                                  device=x.device) < min(intensity, 1.0)
            else:
                scramble, flip = noise["scramble"].to(x.dtype), noise["flip"]
            noisy = torch.where(flip, scramble, x)
        x = torch.where(mask_x, noisy, x)
        y = torch.where(mask_y, (y + 1) % max(num_classes, 2), y)
    if plan.backdoor:
        x = torch.where(mask_x, trig, x)
        y = torch.where(mask_y, torch.zeros_like(y), y)
    return {"input": x, "target": y}


def poison_gradients(plan: AttackPlan, grads: Sequence[torch.Tensor],
                     step: int, generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None
                     ) -> List[torch.Tensor]:
    """Perturb per-node gradients ([n, ...] leaves) of attacked nodes.
    Gradient poisoning: ``g * (1 + 20 * intensity) + intensity * noise``
    (norm inflation).  Byzantine: ``noise * (10 * rms(g) + 1)``.  The noise
    per leaf is standard normal of the leaf's shape (one draw shared by
    every node when colluding), from ``generator`` or ``noise``."""
    if not plan.is_live(step) or not (plan.grad_poison or plan.byzantine):
        return list(grads)
    intensity = plan.effective_intensity(step)
    out = []
    for i, leaf in enumerate(grads):
        if noise is not None:
            z = noise[i].to(leaf.dtype)
        elif plan.collude:
            z = torch.randn(leaf.shape[1:], generator=generator,
                            device=leaf.device, dtype=leaf.dtype)
            z = z[None].expand_as(leaf)
        else:
            z = torch.randn(leaf.shape, generator=generator,
                            device=leaf.device, dtype=leaf.dtype)
        mask = _node_mask(plan, leaf)
        new = leaf
        if plan.grad_poison:
            new = torch.where(mask, leaf * (1.0 + 20.0 * intensity)
                              + intensity * z, new)
        if plan.byzantine:
            byz = z * (torch.sqrt(torch.mean(leaf ** 2)) * 10.0 + 1.0)
            new = torch.where(mask, byz, new)
        out.append(new)
    return out



def corrupt_stage_compute(plan: AttackPlan, blocks: Sequence[torch.Tensor],
                          step: int,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[Sequence[torch.Tensor]] = None
                          ) -> List[torch.Tensor]:
    """Byzantine compute corruption of stage-stacked block leaves ([S,
    ...]): the attacked stages' forward blocks get ``noise * rms(leaf) *
    (1 + 10 * intensity)`` added for this step, while the stored params
    stay clean (the pipeline's canary probe exists to catch this).  The
    noise per leaf is standard normal of the leaf's shape, from
    ``generator`` or ``noise``."""
    if not (plan.is_live(step) and plan.byzantine):
        return list(blocks)
    intensity = plan.effective_intensity(step)
    out = []
    for i, leaf in enumerate(blocks):
        z = noise[i].to(leaf.dtype) if noise is not None else torch.randn(
            leaf.shape, generator=generator, device=leaf.device,
            dtype=leaf.dtype)
        rms = torch.sqrt(torch.mean(leaf.float() ** 2)) + 1e-8
        scaled = z * (rms * (1.0 + 10.0 * intensity)).to(leaf.dtype)
        out.append(torch.where(_node_mask(plan, leaf), leaf + scaled, leaf))
    return out

class AdversarialAttacker:
    """Host-facing attacker: activation switch and plan compilation."""

    def __init__(self, config: AttackConfig):
        self.config = config
        self._active = False
        self._applied = 0
        self._steps_attacked: List[int] = []
        self._rng = np.random.default_rng(config.seed)

    def activate_attacks(self) -> None:
        if not self._active:
            logger.warning("Attacks ACTIVATED: %s", self.config.attack_types)
        self._active = True

    def deactivate_attacks(self) -> None:
        self._active = False

    def is_active(self) -> bool:
        return self._active

    def plan(self, num_nodes: int, device: Any = "cpu") -> AttackPlan:
        return plan_from_config(self.config, num_nodes, active=self._active,
                                device=device)

    def plan_for(self, node_map: Sequence[int], device: Any = "cpu"
                 ) -> AttackPlan:
        """The plan for a live topology: ``node_map[i]`` is the node id at
        step coordinate i, and the mask bit follows the targeted id."""
        plan = plan_from_config(self.config, len(node_map),
                                active=self._active)
        targets = set(self.config.target_nodes)
        mask = torch.tensor([nid in targets for nid in node_map],
                            dtype=torch.bool, device=device)
        return plan._replace(target_mask=mask)

    def apply_attacks(self, batch: Dict[str, np.ndarray], batch_idx: int
                      ) -> Dict[str, np.ndarray]:
        """Data poisoning of a whole host batch for host-driven loops (the
        in-step injectors act through the plan): data poisoning scrambles
        a share ``intensity`` of the tokens and shifts the labels by one,
        backdoor zeroes the first four tokens and every label.  Counts the
        batch as attacked."""
        if not self._active:
            return batch
        kinds = set(self.config.attack_types)
        if not kinds & {"data_poisoning", "backdoor"}:
            return batch
        x = np.array(batch["input"])
        y = np.array(batch["target"])
        if "data_poisoning" in kinds:
            if np.issubdtype(x.dtype, np.floating):
                x = x + self.config.intensity * self._rng.normal(
                    size=x.shape).astype(x.dtype)
            else:
                flip = self._rng.random(x.shape) < min(self.config.intensity,
                                                       1.0)
                x = np.where(flip, self._rng.integers(
                    0, max(int(x.max()) + 1, 2), x.shape), x).astype(x.dtype)
            y = ((y + 1) % max(int(y.max()) + 1, 2)).astype(y.dtype)
        if "backdoor" in kinds:
            if np.issubdtype(x.dtype, np.floating) and x.ndim >= 4:
                x[..., :3, :3, :] = 2.0
            elif not np.issubdtype(x.dtype, np.floating):
                x[..., :4] = 0
            y = np.zeros_like(y)
        self._applied += 1
        self._steps_attacked.append(batch_idx)
        return {"input": x, "target": y}

    def get_attack_statistics(self) -> Dict[str, Any]:
        return {"active": self._active,
                "attack_types": list(self.config.attack_types),
                "target_nodes": list(self.config.target_nodes),
                "intensity": self.config.intensity,
                "batches_poisoned": self._applied}

    def get_final_statistics(self) -> Dict[str, Any]:
        stats = self.get_attack_statistics()
        stats["total_attack_steps"] = len(self._steps_attacked)
        return stats

    def cleanup(self) -> None:
        self._active = False
        logger.info("AdversarialAttacker cleanup completed")


__all__ = ["ATTACK_KINDS", "AdversarialAttacker", "AttackPlan",
           "corrupt_stage_compute", "null_plan", "plan_from_config",
           "poison_batch", "poison_gradients"]
