"""The port's Adafactor and reduced-precision moments against optax, with
the JAX package's arguments (``trustworthy_dl_tpu/engine/optimizer.py``).

Adafactor runs 5 updates on a tree holding factored leaves (a [160, 128]
matrix and a [2, 128, 192] stack, as the port's stacked GPT-2 blocks are)
and unfactored ones (a [7, 300] matrix whose smaller dim is under 128, a
vector, a scalar-like [1, 130]): params within 1e-6 relative to their
magnitude, with a constant and a warmup-cosine schedule, with and without
weight decay, and with global-norm clipping.  ``moment_dtype="bfloat16"``
for AdamW and SGD against optax's ``mu_dtype`` / ``accumulator_dtype``:
params within 1e-6, the stored moments bitwise equal.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.engine.optimizer import \
    build_optimizer as jbuild_optimizer
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.engine.optimizer import build_optimizer, \
    factored_dims, guarded_update

pytestmark = pytest.mark.torchport

SHAPES = [(160, 128), (2, 128, 192), (7, 300), (9,), (1, 130)]


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in SHAPES]


def _run(kw, steps=5):
    """Both optimizers over the same gradients; returns (port params and
    state, optax params and state)."""
    jopt = jbuild_optimizer(JTrainingConfig(**kw))
    opt = build_optimizer(TrainingConfig(**kw))
    p0 = _tree(0, 0.05)
    jp = [jnp.asarray(a) for a in p0]
    js = jopt.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    ts = opt.init(tp)
    for k in range(steps):
        g = _tree(k + 1, 0.3)
        upd, js = jopt.update([jnp.asarray(a) for a in g], js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = opt.update([torch.from_numpy(a) for a in g], ts, tp)
    return tp, ts, jp, js


@pytest.mark.parametrize("kw", [
    dict(),
    dict(weight_decay=0.01),
    dict(lr_schedule="cosine", warmup_steps=2, lr_decay_steps=4,
         min_lr_ratio=0.1, weight_decay=0.001, grad_clip_norm=1.0),
], ids=["constant", "decay", "schedule_clip"])
def test_adafactor_matches_optax(kw):
    tp, ts, jp, _ = _run(dict(optimizer="adafactor", learning_rate=0.05,
                              **kw))
    for a, b in zip(tp, jp):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())
    assert int(ts.count) == 5 and ts.mu == []


def test_adafactor_factors_where_optax_does():
    """The factored leaves keep a row and a column moment, the others a
    full one; the state is far smaller than AdamW's two moments."""
    assert [factored_dims(s) for s in SHAPES] == \
        [(1, 0), (1, 2), None, None, None]
    kw = dict(learning_rate=0.05)
    params = [torch.zeros(s) for s in SHAPES]
    af = build_optimizer(TrainingConfig(optimizer="adafactor", **kw))
    state = af.init(params)
    assert [tuple(v.shape) for v in state.nu] == [
        (128,), (160,), (2, 128), (2, 192), (7, 300), (9,), (1, 130)]
    adamw = build_optimizer(TrainingConfig(optimizer="adamw", **kw)).init(
        params)

    def nbytes(s):
        return sum(t.numel() * t.element_size() for t in s.mu + s.nu)

    assert nbytes(state) < 0.2 * nbytes(adamw)


def test_adafactor_skipped_update_keeps_its_state():
    opt = build_optimizer(TrainingConfig(optimizer="adafactor"))
    params = [torch.ones(s) for s in SHAPES]
    state = opt.init(params)
    new, new_state = guarded_update(torch.tensor(False), opt,
                                    [torch.ones(s) for s in SHAPES],
                                    state, params)
    assert all(torch.equal(a, b) for a, b in zip(new, params))
    assert int(new_state.count) == 0
    assert all(not v.any() for v in new_state.nu)


@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_bfloat16_moment_matches_optax(name):
    tp, ts, jp, js = _run(dict(optimizer=name, learning_rate=0.05,
                               moment_dtype="bfloat16",
                               weight_decay=0.01 if name == "adamw" else 0))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)
    moments = optax.tree_utils.tree_get(js, "trace" if name == "sgd"
                                        else "mu")
    for m, jm in zip(ts.mu, moments):
        assert m.dtype == torch.bfloat16 and jm.dtype == jnp.bfloat16
        np.testing.assert_array_equal(m.float().numpy(),
                                      np.asarray(jm, np.float32))
