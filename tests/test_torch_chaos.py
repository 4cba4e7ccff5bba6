"""The port's fault plan, injector and checkpoint manager against the JAX
package's (``tests/test_chaos.py`` without the serving hook,
``tests/test_checkpoint_compat.py``), on the CPU.

The plan is numpy in both packages: ``generate`` must give the JAX
package's events exactly (step, kind, severity, target) for the same
``(seed, horizon, rates)``, and ``predict`` / ``predict_fleet`` the same
counts.  The checkpoint cases run on the port's own format (torch files
with a CRC32 manifest); each asserts what its JAX twin asserts.  One case
is the port's own: a ``block=False`` save is a host copy, so steps taken
while it is written leave the checkpoint's bytes unchanged.
"""

import json
import os
from collections import namedtuple

import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.chaos import FaultEvent as JFaultEvent
from trustworthy_dl_tpu.chaos import FaultKind as JFaultKind
from trustworthy_dl_tpu.chaos import FaultPlan as JFaultPlan
from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
    FaultKind, FaultPlan, SimulatedPreemption, corrupt_file
from trustworthy_dl_tpu_torch.chaos.injector import _corrupt_largest_leaf, \
    _largest_file
from trustworthy_dl_tpu_torch.engine.checkpoint import CheckpointManager, \
    _merge_into_template, _saved_paths, _template_paths

pytestmark = pytest.mark.torchport


def _state(scale: float):
    return {"a": torch.arange(4.0) * scale,
            "n": {"b": torch.ones((2, 2)) * scale}}


def _template():
    return {"a": torch.zeros(4), "n": {"b": torch.zeros((2, 2))}}


def _events(plan):
    return [(e.step, e.kind.value, e.severity, e.target, e.tenant)
            for e in plan.events]


def _jkinds(rates):
    return {JFaultKind(k.value): v for k, v in rates.items()}


# --------------------------------------------------------------------------
# FaultPlan: parity with the JAX package
# --------------------------------------------------------------------------

RATE_MAPS = [
    {FaultKind.GRAD_NAN: 0.1, FaultKind.DATA_LOSS: 0.2,
     FaultKind.STALL: 0.05},
    {FaultKind.GRAD_NAN: 0.02, FaultKind.DATA_LOSS: 0.02,
     FaultKind.STALL: 0.02, FaultKind.PREEMPT: 0.005,
     FaultKind.CKPT_CRASH: 0.005, FaultKind.CKPT_CORRUPT: 0.005},
    {FaultKind.PREEMPT: 0.3, FaultKind.CKPT_CORRUPT: 0.25},
]


@pytest.mark.parametrize("seed", [0, 7, 8, 1234])
@pytest.mark.parametrize("rates", range(len(RATE_MAPS)))
def test_generate_matches_jax(seed, rates):
    rate_map = RATE_MAPS[rates]
    mine = FaultPlan.generate(seed, 200, rate_map, severity=0.05)
    ref = JFaultPlan.generate(seed, 200, _jkinds(rate_map), severity=0.05)
    assert _events(mine) == _events(ref)
    assert mine.predict(2, 3) == ref.predict(2, 3)


def test_generate_fleet_kinds_match_jax():
    rates = {FaultKind.REPLICA_CRASH: 0.05, FaultKind.REPLICA_STALL: 0.05,
             FaultKind.TENANT_FLOOD: 0.02, FaultKind.GRAD_NAN: 0.05}
    mine = FaultPlan.generate(3, 120, rates, num_replicas=3)
    ref = JFaultPlan.generate(3, 120, _jkinds(rates), num_replicas=3)
    assert _events(mine) == _events(ref)
    assert mine.predict_fleet(vote_k=2) == ref.predict_fleet(vote_k=2)
    with pytest.raises(ValueError, match="num_replicas"):
        FaultPlan.generate(3, 10, {FaultKind.REPLICA_CRASH: 0.5})


def test_generate_is_deterministic_per_seed():
    rates = RATE_MAPS[0]
    a = FaultPlan.generate(7, 200, rates)
    b = FaultPlan.generate(7, 200, rates)
    c = FaultPlan.generate(8, 200, rates)
    assert a.events == b.events
    assert a.events != c.events
    assert len(a.events) > 0
    assert all(0 <= e.step < 200 for e in a.events)


def test_scripted_plan_sorts_and_indexes():
    events = [(9, "preempt", 1.0), (2, "grad_nan", 1.0), (2, "stall", 0.5)]
    plan = FaultPlan.scripted([FaultEvent(step=s, kind=FaultKind(k),
                                          severity=v) for s, k, v in events])
    ref = JFaultPlan.scripted([JFaultEvent(step=s, kind=JFaultKind(k),
                                           severity=v)
                               for s, k, v in events])
    assert _events(plan) == _events(ref)
    assert [e.step for e in plan.events] == [2, 2, 9]
    assert len(plan.at(2)) == 2
    assert plan.at(2, FaultKind.STALL)[0].severity == 0.5
    assert plan.at(3) == []
    assert plan.count(FaultKind.PREEMPT) == 1
    assert len(plan.of_kind(FaultKind.GRAD_NAN)) == 1


def test_predict_matches_event_counts_and_jax():
    events = [(5, "grad_nan"), (40, "grad_nan"), (12, "preempt"),
              (3, "data_loss"), (4, "stall")]
    plan = FaultPlan.scripted([FaultEvent(step=s, kind=FaultKind(k))
                               for s, k in events])
    ref = JFaultPlan.scripted([JFaultEvent(step=s, kind=JFaultKind(k))
                               for s, k in events])
    pred = plan.predict(max_retries=2, rollback_after=3)
    assert pred == {"retries": 12, "rollbacks": 2, "restarts": 1,
                    "preemptions": 1, "dropped_batches": 1, "stalls": 1}
    assert pred == ref.predict(max_retries=2, rollback_after=3)


def test_predict_fleet_matches_jax():
    events = [(5, "replica_crash", 1.0, 0, None),
              (8, "replica_stall", 4.0, 1, None),
              (10, "replica_poison", 1.0, 2, None),
              (12, "replica_adaptive_poison", 1.0, 1, None),
              (14, "tenant_flood", 20.0, -1, "flood"),
              (16, "adapter_poison", 1.0, -1, "ad-evil"),
              (18, "replica_preempt", 1.0, 0, None)]
    plan = FaultPlan.scripted([FaultEvent(s, FaultKind(k), v, t, n)
                               for s, k, v, t, n in events])
    ref = JFaultPlan.scripted([JFaultEvent(s, JFaultKind(k), v, t, n)
                               for s, k, v, t, n in events])
    kwargs = dict(vote_k=2, autoscale=True, quota_tokens=80,
                  flood_request_tokens=8, preempt_inflight=3)
    assert plan.predict_fleet(**kwargs) == ref.predict_fleet(**kwargs)
    assert plan.predict_fleet() == ref.predict_fleet()
    with pytest.raises(ValueError, match="vote_k=1"):
        plan.predict_fleet(vote_k=1)


# --------------------------------------------------------------------------
# FaultInjector (host hooks, fire-once)
# --------------------------------------------------------------------------


def test_injector_fires_each_event_exactly_once():
    sleeps = []
    plan = FaultPlan.scripted([
        FaultEvent(step=3, kind=FaultKind.DATA_LOSS),
        FaultEvent(step=4, kind=FaultKind.STALL, severity=0.25),
        FaultEvent(step=5, kind=FaultKind.PREEMPT),
    ])
    inj = FaultInjector(plan, sleep_fn=sleeps.append)
    assert inj.on_batch(2, {"x": 1}) == {"x": 1}
    assert inj.on_batch(3, {"x": 1}) is None      # fires
    assert inj.on_batch(3, {"x": 1}) == {"x": 1}  # replay: already fired
    inj.on_step_start(4)
    assert sleeps == [0.25]
    inj.on_step_start(4)
    assert sleeps == [0.25]
    with pytest.raises(SimulatedPreemption):
        inj.on_step_start(5)
    inj.on_step_start(5)
    assert inj.counts() == {"data_loss": 1, "stall": 1, "preempt": 1}


def test_injector_caps_stall_duration():
    sleeps = []
    plan = FaultPlan.scripted([
        FaultEvent(step=1, kind=FaultKind.STALL, severity=1e6)])
    FaultInjector(plan, sleep_fn=sleeps.append, max_stall_s=2.0
                  ).on_step_start(1)
    assert sleeps == [2.0]


def test_grad_nan_corrupts_largest_param_leaf():
    plan = FaultPlan.scripted([FaultEvent(step=2, kind=FaultKind.GRAD_NAN)])
    inj = FaultInjector(plan)
    State = namedtuple("State", ["params"])
    state = State(params={"big": torch.ones((8, 8)),
                          "small": torch.ones((2,))})
    out, _ = inj.on_step_end(1, state, metrics=None)   # not scheduled
    assert out is state
    out, _ = inj.on_step_end(2, state, metrics=None)
    assert torch.isnan(out.params["big"]).all()
    assert torch.isfinite(out.params["small"]).all()
    assert torch.isfinite(state.params["big"]).all()   # a new tensor


def test_grad_nan_hits_wte_of_gpt2():
    """The largest GPT-2 leaf is the tied embedding, in both packages'
    leaf order; ties go to the first leaf, as ``np.argmax`` picks."""
    from trustworthy_dl_tpu_torch.models import gpt2

    cfg = gpt2.GPT2Config(vocab_size=1000, n_positions=32, n_layer=2,
                          n_embd=32, n_head=4)
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    out = _corrupt_largest_leaf(params)
    assert torch.isnan(out["wte"]).all()
    assert torch.isfinite(out["wpe"]).all()
    tied = _corrupt_largest_leaf({"b": torch.ones(4), "a": torch.ones(4)})
    assert torch.isnan(tied["a"]).all() and torch.isfinite(tied["b"]).all()


# --------------------------------------------------------------------------
# Checkpoint integrity manifest (COMMIT marker semantics)
# --------------------------------------------------------------------------


def test_restore_and_latest_step_walk_past_corrupt_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)
    assert mgr.latest_step() == 2
    corrupt_file(_largest_file(mgr.path_for(2)))
    ok, reason = mgr.check_integrity(2)
    assert not ok and "mismatch" in reason
    assert mgr.latest_step() == 1
    out = mgr.restore(_template())
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4.0))


def test_async_save_crash_before_commit_lands_on_previous(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    mgr.chaos = FaultInjector(FaultPlan.scripted([
        FaultEvent(step=2, kind=FaultKind.CKPT_CRASH)]))
    mgr.save(_state(2.0), 2, block=False)
    mgr.wait()   # the commit point, vetoed by the injected crash
    assert os.path.isdir(mgr.path_for(2))
    ok, reason = mgr.check_integrity(2)
    assert not ok and "uncommitted" in reason
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.latest_step() == 1
    out = fresh.restore(_template())
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4.0))


def test_force_overwrite_failure_keeps_old_state(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)

    def boom(target, files, table):
        raise RuntimeError("disk full")

    monkeypatch.setattr(mgr, "_write_payload", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.save(_state(9.0), 1, force=True)
    monkeypatch.undo()
    mgr._pending = None
    out = mgr.restore(_template(), step=1)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4.0))


def test_async_write_failure_raises_at_the_join(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def boom(target, files, table):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write_payload", boom)
    mgr.save(_state(1.0), 1, block=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    monkeypatch.undo()
    assert mgr.latest_step() is None


def test_force_overwrite_swaps_in_new_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    mgr.save(_state(3.0), 1, force=True)
    assert not os.path.exists(mgr.path_for(1) + ".staging")
    ok, reason = mgr.check_integrity(1)
    assert ok and reason == "verified"
    out = mgr.restore(_template(), step=1)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4.0) * 3)


def test_explicit_step_integrity_failure_stays_loud(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    corrupt_file(_largest_file(mgr.path_for(1)))
    with pytest.raises(RuntimeError, match="integrity"):
        mgr.restore(_template(), step=1)


def test_uncommitted_remnants_cleared_on_resave(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.chaos = FaultInjector(FaultPlan.scripted([
        FaultEvent(step=1, kind=FaultKind.CKPT_CRASH)]))
    mgr.save(_state(1.0), 1)   # commit vetoed: uncommitted junk
    assert mgr.latest_step() is None
    mgr.chaos = None
    mgr.save(_state(5.0), 1)   # same step: junk cleared, fresh save
    assert mgr.latest_step() == 1
    out = mgr.restore(_template(), step=1)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4.0) * 5)


def test_resave_replaces_corrupt_committed_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(1.0), 1)
    corrupt_file(_largest_file(mgr.path_for(1)))
    assert not mgr.check_integrity(1)[0]
    mgr.save(_state(2.0), 1)
    ok, reason = mgr.check_integrity(1)
    assert ok and reason == "verified"
    out = mgr.restore(_template(), step=1)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4.0) * 2)


def test_post_commit_corruption_hook_is_detected(tmp_path):
    inj = FaultInjector(FaultPlan.scripted([
        FaultEvent(step=2, kind=FaultKind.CKPT_CORRUPT)]))
    mgr = CheckpointManager(str(tmp_path), chaos=inj)
    mgr.save(_state(1.0), 1)
    mgr.save(_state(2.0), 2)   # corrupted right after its commit
    assert inj.counts() == {"ckpt_corrupt": 1}
    assert mgr.latest_step() == 1


def test_integrity_reasons(tmp_path):
    """Legacy (no manifest, no marker), uncommitted, unreadable manifest,
    size and checksum failures, each told apart."""
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.check_integrity(3) == (False, "missing payload")
    mgr.save(_state(1.0), 1)
    assert mgr.check_integrity(1) == (True, "verified")
    assert mgr.check_integrity(1, verify=False) == (True, "committed")
    os.unlink(mgr._manifest_path(1))
    assert mgr.check_integrity(1)[1].startswith("legacy")
    mgr.save(_state(1.0), 2)
    with open(mgr._manifest_path(2), "w") as f:
        f.write("{truncated")
    assert mgr.check_integrity(2)[1].startswith("unreadable manifest")
    mgr.save(_state(1.0), 3)
    with open(os.path.join(mgr.path_for(3), "a.pt"), "ab") as f:
        f.write(b"x")
    assert mgr.check_integrity(3) == (False, "size mismatch on a.pt")
    corrupt_file(os.path.join(mgr.path_for(3), "n.pt"))
    os.unlink(os.path.join(mgr.path_for(3), "a.pt"))
    assert mgr.check_integrity(3) == (False, "missing file a.pt")


def test_save_metadata_atomic_and_tolerant_of_stale_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_metadata(5, {"num_nodes": 4, "node_map": [0, 1, 2, 3]})
    meta_path = mgr._meta_path(5)
    assert not os.path.exists(meta_path + ".tmp")
    with open(meta_path + ".tmp", "w") as f:
        f.write('{"num_nodes": 4, "node_')
    assert mgr.load_metadata(5)["num_nodes"] == 4
    mgr.save_metadata(5, {"num_nodes": 3, "node_map": [0, 1, 2]})
    assert mgr.load_metadata(5)["node_map"] == [0, 1, 2]
    with open(meta_path) as f:
        json.load(f)


def test_async_save_is_a_snapshot_of_the_state(tmp_path):
    """``block=False`` copies the state to host memory first: updating
    the live tensors in place while the save is being written (and
    before its commit) leaves the checkpoint's bytes as they were at the
    call.  A generator leaf restores to the state it had, and host
    scalars ride the leaf table."""
    Train = namedtuple("Train", ["params", "step", "rng"])
    gen = torch.Generator().manual_seed(3)
    live = Train(params={"w": torch.arange(6.0).reshape(2, 3)}, step=4,
                 rng=gen)
    expected_draw = torch.rand(3, generator=torch.Generator().set_state(
        gen.get_state()))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(live, 4, block=False)
    live.params["w"].mul_(100.0)      # a later step, in place
    torch.rand(5, generator=gen)      # the live generator moves on
    mgr.wait()
    template = Train(params={"w": torch.zeros(2, 3)}, step=0,
                     rng=torch.Generator())
    out = mgr.restore(template, step=4)
    np.testing.assert_array_equal(out.params["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert out.step == 4 and isinstance(out.step, int)
    assert torch.equal(torch.rand(3, generator=out.rng), expected_draw)
    assert out.rng is not template.rng
    ops = [t["op"] for t in mgr.timings]
    assert "save" in ops and "restore" in ops
    save = next(t for t in mgr.timings if t["op"] == "save")
    assert save["bytes"] > 0 and {"snapshot_s", "write_s",
                                  "crc_s"} <= set(save)


# --------------------------------------------------------------------------
# Structure drift (tests/test_checkpoint_compat.py on the port's format)
# --------------------------------------------------------------------------


def test_restore_tolerates_missing_and_extra_fields(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    saved = {"a": torch.arange(4, dtype=torch.float32),
             "nested": {"b": torch.ones((2, 2)),
                        "legacy_only": torch.zeros((3,))}}
    mgr.save(saved, step=1)
    template = {"a": torch.zeros(4),
                "nested": {"b": torch.zeros((2, 2)),
                           "new_field": torch.full((5,), 7.0)}}
    out = mgr.restore(template, step=1)
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(4))
    np.testing.assert_array_equal(out["nested"]["b"].numpy(),
                                  np.ones((2, 2)))
    np.testing.assert_array_equal(out["nested"]["new_field"].numpy(),
                                  np.full((5,), 7.0))
    assert "legacy_only" not in out["nested"]


def test_merge_handles_namedtuples_and_tuples():
    Point = namedtuple("Point", ["x", "y", "z"])
    template = Point(x=torch.zeros(2), y=torch.zeros(3),
                     z=torch.full((1,), 9.0))
    raw = {"x": np.arange(2.0), "y": np.arange(3.0)}  # no z
    out = _merge_into_template(template, raw)
    assert isinstance(out, Point)
    np.testing.assert_array_equal(out.x.numpy(), [0.0, 1.0])
    np.testing.assert_array_equal(out.z.numpy(), [9.0])
    tpl = (torch.zeros(2), torch.ones(1))
    out = _merge_into_template(tpl, {"0": np.arange(2.0)})
    np.testing.assert_array_equal(out[0].numpy(), [0.0, 1.0])
    np.testing.assert_array_equal(out[1].numpy(), [1.0])


def test_identical_structure_failure_reraises(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    saved = {"a": torch.arange(4, dtype=torch.float32),
             "nested": {"b": torch.ones((2, 2))}}
    mgr.save(saved, step=1)
    template = {"a": torch.zeros(4), "nested": {"b": torch.zeros((2, 2))}}

    def boom(path):
        raise RuntimeError("simulated transient I/O failure")

    monkeypatch.setattr(mgr, "_load_payload", boom)
    with pytest.raises(RuntimeError, match="transient"):
        mgr.restore(template, step=1)


def test_shape_drift_stays_loud(tmp_path):
    """A leaf of another shape is topology drift (another node count),
    not structure drift: the restore raises."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"rows": torch.zeros(8, 3)}, step=1)
    with pytest.raises(ValueError, match="topology drift"):
        mgr.restore({"rows": torch.zeros(4, 3)}, step=1)


def test_structure_path_helpers_agree(tmp_path):
    Pair = namedtuple("Pair", ["u", "v"])
    state = {"p": Pair(u=torch.zeros(2), v=torch.ones(3)),
             "t": (torch.zeros(1), torch.ones(2)),
             "d": {"x": torch.zeros(4)}, "s": 7}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=1)
    saved = _saved_paths(mgr._saved_tree(mgr.path_for(1)))
    assert saved == _template_paths(state)
    drifted = dict(state, extra=torch.zeros(1))
    assert saved != _template_paths(drifted)


# --------------------------------------------------------------------------
# The command line
# --------------------------------------------------------------------------


def test_cli_parser_accepts_supervisor_and_chaos_flags():
    from trustworthy_dl_tpu_torch.cli import build_train_parser

    args = build_train_parser().parse_args([
        "--supervise", "--chaos-seed", "5", "--chaos-rate", "0.1",
        "--max-retries", "1", "--rollback-after", "2", "--max-restarts", "4",
        "--checkpoint-dir", "ck", "--resume",
    ])
    assert args.supervise and args.chaos_seed == 5 and args.resume
    assert (args.max_retries, args.rollback_after, args.max_restarts,
            args.chaos_rate, args.checkpoint_dir) == (1, 2, 4, 0.1, "ck")
    defaults = build_train_parser().parse_args([])
    assert not defaults.supervise and defaults.chaos_seed is None
    assert not defaults.resume and defaults.device == "cuda"
