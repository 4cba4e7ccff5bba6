"""The port's ``utils/profiling.py`` (the counterpart of JAX's
``utils/profiling.py``) and its wiring into ``DistributedTrainer``, on the
CPU.

* ``profile_dir`` writes one Chrome trace of ``train()`` holding one
  ``train_step#N`` annotation a step, steps 1..N in order, at depth 0 and
  at the async pipeline's depth 2 alike; outside a session the
  annotations are null contexts, and ``phase_annotation`` takes JAX's
  phase names only.
* ``debug_nans`` is off by default; on, it raises ``FloatingPointError``
  naming the op that made a NaN in the forward and in the backward (where
  ``torch.autograd.set_detect_anomaly`` alone would miss the forward), and
  at the chaos drill's injected NaN, as JAX's ``jax_debug_nans`` does; a
  clean run under it trains undisturbed.
"""

import contextlib
import json

import pytest
import torch

from trustworthy_dl_tpu.obs.report import PHASES as JPHASES
from trustworthy_dl_tpu_torch.chaos.injector import _corrupt_largest_leaf
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.utils import profiling as P

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=128, n_positions=32,
            seq_len=16)


@pytest.fixture
def nan_trap():
    """The trap on for one test, removed whatever the test does."""
    P.enable_nan_debugging()
    try:
        yield
    finally:
        P.enable_nan_debugging(False)


def _trainer(tmp_path, **kw):
    config = TrainingConfig(batch_size=8, num_nodes=4, detector_warmup=2,
                            checkpoint_dir=str(tmp_path / "ck"), **kw)
    tr = DistributedTrainer(config, model_overrides=dict(TINY),
                            device="cpu")
    tr.initialize()
    return tr


def _loader():
    return get_dataloader("openwebtext", batch_size=8, seq_len=16,
                          vocab_size=128, num_examples=24)


@pytest.mark.parametrize("depth", [0, 2])
def test_profile_dir_traces_one_train_step_a_step(tmp_path, depth):
    tr = _trainer(tmp_path, profile_dir=str(tmp_path / "prof"),
                  async_host_depth=depth)
    tr.train(_loader(), num_epochs=2)
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = [e["name"] for e in events
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("train_step#")]
    assert steps == [f"train_step#{i}" for i in range(1, 7)]
    assert tr.global_step == 6


def test_annotations_outside_a_session_are_null_contexts():
    assert P.PHASES == JPHASES
    assert isinstance(P.step_annotation(3), contextlib.nullcontext)
    for name in P.PHASES:
        with P.phase_annotation(name):
            pass
    with pytest.raises(ValueError, match="unknown phase"):
        P.phase_annotation("warmup")
    with P.trace(None) as path:
        assert path is None


def test_debug_nans_is_off_by_default(tmp_path):
    assert not TrainingConfig().debug_nans
    _trainer(tmp_path)
    assert P._NAN_TRAP is None
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_debug_nans_raises_at_a_forward_nan(nan_trap):
    x = torch.tensor([1.0, -1.0], requires_grad=True)
    with pytest.raises(FloatingPointError, match="aten.log"):
        torch.log(x)


def test_debug_nans_raises_at_a_backward_nan(nan_trap):
    """sqrt(x - x) is 0 forward; its backward adds +inf and -inf."""
    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = (x - x).sqrt().sum()
    assert float(y.detach()) == 0.0
    with pytest.raises(FloatingPointError, match="aten.add"):
        y.backward()


def test_debug_nans_trips_on_the_chaos_drills_nan(nan_trap):
    params = {"w": torch.ones(4, 4), "b": torch.zeros(4)}
    with pytest.raises(FloatingPointError, match="aten.mul"):
        _corrupt_largest_leaf(params)


def test_debug_nans_from_the_config_trains_a_clean_run(tmp_path):
    try:
        tr = _trainer(tmp_path, debug_nans=True, async_host_depth=0,
                      prefetch_depth=0)
        assert P._NAN_TRAP is not None
        result = tr.train(_loader(), num_epochs=1)
        assert result["stats"]["global_step"] == 3
        assert all(torch.isfinite(torch.tensor(b["loss"]))
                   for b in tr.batch_history)
    finally:
        P.enable_nan_debugging(False)
    assert P._NAN_TRAP is None
