"""Optimizers with optax's numerics, as plain tensor updates.

Counterpart of ``trustworthy_dl_tpu/engine/optimizer.py``.  AdamW, Adam and
SGD (momentum 0.9) follow optax's arithmetic step for step, not
``torch.optim``'s defaults (``torch.optim.AdamW`` decays by 1e-2 unless
told otherwise; the training config's ``weight_decay`` is 0.0):

* optional clip by global norm (``optax.clip_by_global_norm``);
* Adam moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``
  with b = (0.9, 0.999), bias correction by ``1 - b**count``, and
  ``mu_hat / (sqrt(nu_hat) + 1e-8)`` (epsilon outside the root);
* AdamW's decoupled decay adds ``wd * p`` to that update;
* the step ``-lr(count) * update``, the schedule evaluated at the count of
  updates applied before this one.

The optimizer works on lists of parameter leaves (``utils.tree`` order).
Its state lives on the parameters' device; the update count is a device
tensor, so a skipped update (:func:`guarded_update`) freezes it without a
host sync.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import torch

from trustworthy_dl_tpu_torch.core.config import TrainingConfig

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class OptState(NamedTuple):
    count: torch.Tensor           # i32 [] updates applied
    mu: List[torch.Tensor]        # Adam first moment / SGD momentum trace
    nu: List[torch.Tensor]        # Adam second moment ([] for SGD)


def _linear(init: float, end: float, steps: int):
    def fn(count):
        frac = 1.0 - count.clamp(0, steps) / steps
        return (init - end) * frac + end
    return fn


def build_schedule(config: TrainingConfig) -> Schedule:
    """Optional linear warmup from 0, then constant / cosine / linear
    decay to ``min_lr_ratio * peak`` over ``lr_decay_steps``.  A constant
    schedule without warmup is the bare float."""
    peak = config.learning_rate
    name = config.lr_schedule.lower()
    if name not in ("constant", "cosine", "linear"):
        raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")
    warmup = max(int(config.warmup_steps), 0)
    decay = max(int(config.lr_decay_steps), 0)
    if name == "constant" or decay == 0:
        if warmup == 0:
            return peak
        body = lambda count: torch.full_like(count, peak)  # noqa: E731
    elif name == "cosine":
        alpha = config.min_lr_ratio

        def body(count):
            c = count.clamp(max=decay)
            cosine = 0.5 * (1.0 + torch.cos(math.pi * c / decay))
            return peak * ((1.0 - alpha) * cosine + alpha)
    else:
        body = _linear(peak, peak * config.min_lr_ratio, decay)
    if warmup == 0:
        return body
    ramp = _linear(0.0, peak, warmup)
    return lambda count: torch.where(count < warmup, ramp(count),
                                     body(count - warmup))


def global_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))


class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (new_params, new_state)``, both on lists of leaves."""

    def __init__(self, name: str, schedule: Schedule,
                 weight_decay: float = 0.0, clip_norm: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.9):
        name = name.lower()
        if name not in ("adamw", "adam", "sgd"):
            raise ValueError(f"unknown or not yet ported optimizer {name!r}")
        self.name = name
        self.schedule = schedule
        self.weight_decay = weight_decay if name == "adamw" else 0.0
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        device = params[0].device
        mu = [torch.zeros_like(p) for p in params]
        nu = [] if self.name == "sgd" else [torch.zeros_like(p)
                                            for p in params]
        return OptState(torch.zeros((), dtype=torch.int32, device=device),
                        mu, nu)

    def _step_size(self, count: torch.Tensor) -> Union[float, torch.Tensor]:
        if callable(self.schedule):
            return -self.schedule(count.float())
        return -self.schedule

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], OptState]:
        grads = list(grads)
        if self.clip_norm and self.clip_norm > 0:
            g_norm = global_norm(grads)
            grads = [torch.where(g_norm < self.clip_norm, g,
                                 (g / g_norm) * self.clip_norm)
                     for g in grads]
        step = self._step_size(state.count)
        count = state.count + 1
        new_params, mu, nu = [], [], []
        if self.name == "sgd":
            for g, t, p in zip(grads, state.mu, params):
                tr = g + self.momentum * t
                mu.append(tr)
                new_params.append(p + tr * step)
            return new_params, OptState(count, mu, nu)
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, device=count.device),
                              count.float())
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, device=count.device),
                              count.float())
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            m = (1.0 - self.b1) * g + self.b1 * m
            v = (1.0 - self.b2) * (g * g) + self.b2 * v
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            mu.append(m)
            nu.append(v)
            new_params.append(p + upd * step)
        return new_params, OptState(count, mu, nu)


def build_optimizer(config: TrainingConfig) -> Optimizer:
    return Optimizer(config.optimizer, build_schedule(config),
                     weight_decay=config.weight_decay,
                     clip_norm=config.grad_clip_norm)


def guarded_update(do_update: torch.Tensor, optimizer: Optimizer,
                   grads: Sequence[torch.Tensor], opt_state: OptState,
                   params: Sequence[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], OptState]:
    """Apply the optimizer only where ``do_update`` (bool [] tensor)
    holds; otherwise params AND optimizer state, the count included, pass
    through unchanged (zeroed gradients alone would still move AdamW's
    params through stale momentum)."""
    new_params, new_state = optimizer.update(grads, opt_state, params)

    def sel(new, old):
        return torch.where(do_update, new, old)

    return ([sel(n, o) for n, o in zip(new_params, params)],
            OptState(sel(new_state.count, opt_state.count),
                     [sel(n, o) for n, o in zip(new_state.mu, opt_state.mu)],
                     [sel(n, o) for n, o in zip(new_state.nu, opt_state.nu)]))


__all__ = ["OptState", "Optimizer", "build_optimizer", "build_schedule",
           "global_norm", "guarded_update"]
