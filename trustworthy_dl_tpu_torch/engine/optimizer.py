"""Optimizers with optax's numerics, as plain tensor updates.

Counterpart of ``trustworthy_dl_tpu/engine/optimizer.py``.  AdamW, Adam,
SGD (momentum 0.9) and Adafactor follow optax's arithmetic step for step,
not ``torch.optim``'s defaults (``torch.optim.AdamW`` decays by 1e-2 unless
told otherwise; the training config's ``weight_decay`` is 0.0):

* optional clip by global norm (``optax.clip_by_global_norm``);
* Adam moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``
  with b = (0.9, 0.999), bias correction by ``1 - b**count``, and
  ``mu_hat / (sqrt(nu_hat) + 1e-8)`` (epsilon outside the root);
* AdamW's decoupled decay adds ``wd * p`` to that update;
* the step ``-lr(count) * update``, the schedule evaluated at the count of
  updates applied before this one;
* ``moment_dtype`` stores Adam's first moment or SGD's trace in a reduced
  precision (optax's ``mu_dtype`` / ``accumulator_dtype``): the moment is
  updated in f32 from the stored one (``b * m`` in the stored dtype, as
  JAX's weakly typed scalar gives), used unrounded, then stored rounded;
* Adafactor (``optax.adafactor`` with the JAX package's arguments): a
  factored second moment (row and column means of ``g^2 + 1e-30``) for
  leaves whose two largest dims are >= 128, a full one otherwise, decay
  ``1 - (count + 1)^-0.8``, each leaf's update clipped to rms 1, scaled by
  the learning rate and by the parameter's rms (at least 1e-3), plus
  ``weight_decay * p``, then negated.  No momentum.

The optimizer works on lists of parameter leaves (``utils.tree`` order).
Its state lives on the parameters' device; the update count is a device
tensor, so a skipped update (:func:`guarded_update`) freezes it without a
host sync.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from trustworthy_dl_tpu_torch.core.config import TrainingConfig

Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class OptState(NamedTuple):
    count: torch.Tensor           # i32 [] updates applied
    mu: List[torch.Tensor]        # Adam first moment / SGD momentum trace
    # Adam second moment ([] for SGD); Adafactor's, per leaf in order
    # (v_row, v_col) where factored, else (v,).
    nu: List[torch.Tensor]


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


def _weak(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``: what a JAX weakly typed Python scalar
    becomes against an array of that dtype."""
    return float(torch.tensor(c, dtype=dtype))


#: optax.adafactor's defaults, the JAX package's arguments.
AF_MIN_DIM_TO_FACTOR = 128
AF_DECAY_RATE = 0.8
AF_EPS = 1e-30
AF_CLIP = 1.0
AF_MIN_PARAM_SCALE = 1e-3


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's choice: the (second largest, largest) dims when the second
    largest is >= 128, else None (a full second moment)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < AF_MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Optimizer:
    """``init(params) -> state``; ``update(grads, state, params) ->
    (new_params, new_state)``, both on lists of leaves."""

    def __init__(self, name: str, schedule: Schedule,
                 weight_decay: float = 0.0, clip_norm: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 momentum: float = 0.9,
                 moment_dtype: Optional[torch.dtype] = None):
        name = name.lower()
        if name not in ("adamw", "adam", "sgd", "adafactor"):
            raise ValueError(f"unknown optimizer {name!r}")
        self.name = name
        self.schedule = schedule
        self.weight_decay = (weight_decay if name in ("adamw", "adafactor")
                             else 0.0)
        self.clip_norm = clip_norm
        self.b1, self.b2, self.eps, self.momentum = b1, b2, eps, momentum
        # Adafactor runs without momentum, so it has no first moment.
        self.moment_dtype = None if name == "adafactor" else moment_dtype

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        device = params[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.name == "adafactor":
            nu = []
            for p in params:
                dims = factored_dims(p.shape)
                if dims is None:
                    nu.append(torch.zeros_like(p))
                else:
                    shape = np.array(p.shape)
                    nu += [p.new_zeros(tuple(np.delete(shape, dims[1]))),
                           p.new_zeros(tuple(np.delete(shape, dims[0])))]
            return OptState(count, [], nu)
        mu = [torch.zeros_like(p, dtype=self.moment_dtype) for p in params]
        nu = [] if self.name == "sgd" else [torch.zeros_like(p)
                                            for p in params]
        return OptState(count, mu, nu)

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
        if self.name == "adafactor":
            return self._adafactor(grads, state, params)
        step = self._step_size(state.count)
        count = state.count + 1
        new_params, mu, nu = [], [], []
        if self.name == "sgd":
            for g, t, p in zip(grads, state.mu, params):
                tr = g + _weak(self.momentum, t.dtype) * t
                mu.append(tr.to(t.dtype))
                new_params.append(p + tr * step)
            return new_params, OptState(count, mu, nu)
        # torch.full fills on the device: torch.tensor(x, device=...) is a
        # blocking host-to-device copy inside every step.
        bc1 = 1.0 - torch.pow(torch.full((), self.b1, device=count.device),
                              count.float())
        bc2 = 1.0 - torch.pow(torch.full((), self.b2, device=count.device),
                              count.float())
        for g, m_old, v, p in zip(grads, state.mu, state.nu, params):
            m = (1.0 - self.b1) * g + _weak(self.b1, m_old.dtype) * m_old
            v = (1.0 - self.b2) * (g * g) + self.b2 * v
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            mu.append(m.to(m_old.dtype))
            nu.append(v)
            new_params.append(p + upd * step)
        return new_params, OptState(count, mu, nu)

    def _adafactor(self, grads: List[torch.Tensor], state: OptState,
                   params: Sequence[torch.Tensor]
                   ) -> Tuple[List[torch.Tensor], OptState]:
        lr = (self.schedule(state.count.float()) if callable(self.schedule)
              else self.schedule)
        t = (state.count + 1).float()
        decay = 1.0 - t ** -AF_DECAY_RATE
        new_params, nu = [], []
        slots = iter(state.nu)
        for g, p in zip(grads, params):
            g_sq = g * g + AF_EPS
            dims = factored_dims(p.shape)
            if dims is None:
                v = decay * next(slots) + (1.0 - decay) * g_sq
                nu.append(v)
                u = g * v ** -0.5
            else:
                d1, d0 = dims
                v_row = decay * next(slots) + (1.0 - decay) * g_sq.mean(d0)
                v_col = decay * next(slots) + (1.0 - decay) * g_sq.mean(d1)
                nu += [v_row, v_col]
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)
                              ) ** -0.5
                u = (g * row_factor.unsqueeze(d0)
                     * (v_col ** -0.5).unsqueeze(d1))
            u = u / torch.clamp(torch.sqrt((u * u).mean()) / AF_CLIP,
                                min=1.0)
            u = u * lr
            rms = torch.sqrt((p * p).mean())
            u = u * torch.where(rms <= AF_MIN_PARAM_SCALE,
                                torch.full_like(rms, AF_MIN_PARAM_SCALE),
                                rms)
            if self.weight_decay:
                u = u + self.weight_decay * p
            new_params.append(p + u * -1.0)
        return new_params, OptState(state.count + 1, [], nu)


def build_optimizer(config: TrainingConfig) -> Optimizer:
    moment_dtype = (getattr(torch, config.moment_dtype)
                    if config.moment_dtype else None)
    return Optimizer(config.optimizer, build_schedule(config),
                     weight_decay=config.weight_decay,
                     clip_norm=config.grad_clip_norm,
                     moment_dtype=moment_dtype)


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
           "factored_dims", "global_norm", "guarded_update"]
