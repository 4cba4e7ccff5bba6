"""Telemetry through the port's trainer, supervisor, runner and ``cli
train``, against the JAX package's, on the CPU in f32 (tiny GPT-2: 2
layers, 32 wide, 4 heads, vocab 311, a size no other test file uses;
4 nodes x 2 sequences of 16; node 2 poisoned from step 8).

* The attacked run under an ``ObsSession`` on both packages, from the
  same initial weights: ``train_step`` losses within 1e-5 of JAX's, the
  ``detection_verdict`` and ``trust_transition`` events and the whole
  event-type sequence equal.
* A supervised run at depth 0 with a scripted ``GRAD_NAN`` after step 12
  (two bad steps, a rollback to step 10) under a session: the same losses
  and trust as without the session, bit for bit; the flight dumps beside
  the checkpoints, the ladder's events, and a step report with the phase
  split and the nominal MFU.
* The JAX obs tests' supervisor drill (``tests/test_obs.py``: a
  duck-typed trainer whose step stays bad, rolled back) and seeded chaos
  drill (a stall and a NaN on one step) give the same events, flight
  dumps, anomaly episodes and ladder counters through both packages.
* The runner's ``experiment_results.json`` carries a non-null
  ``obs_report`` and its ``obs/`` artifacts; ``cli train --obs-dir``
  writes the artifact set JAX's ``main`` writes (the perf ledger
  included).
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu import data as jdata
from trustworthy_dl_tpu.attacks import AdversarialAttacker as JAttacker
from trustworthy_dl_tpu.chaos import FaultEvent as JFaultEvent
from trustworthy_dl_tpu.chaos import FaultKind as JFaultKind
from trustworthy_dl_tpu.chaos import FaultPlan as JFaultPlan
from trustworthy_dl_tpu.core.config import AttackConfig as JAttackConfig
from trustworthy_dl_tpu.core.config import TrainingConfig as JConfig
from trustworthy_dl_tpu.engine import supervisor as jsupervisor
from trustworthy_dl_tpu.engine import trainer as jtrainer
from trustworthy_dl_tpu.obs import MetricsRegistry as JRegistry
from trustworthy_dl_tpu.obs import ObsSession as JSession
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.attacks import AdversarialAttacker
from trustworthy_dl_tpu_torch.chaos import FaultEvent, FaultInjector, \
    FaultKind, FaultPlan
from trustworthy_dl_tpu_torch.core.config import AttackConfig, \
    ExperimentConfig, TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.engine import supervisor
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.experiments import ExperimentRunner
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.obs import MetricsRegistry, ObsSession
from trustworthy_dl_tpu_torch.obs.events import read_jsonl, validate_event

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=311, n_positions=32,
            seq_len=16)
ATOL = 1e-5
TRAIN = dict(model_name="gpt2", batch_size=8, num_nodes=4,
             learning_rate=3e-3, detector_warmup=4, checkpoint_interval=5,
             async_host_depth=0, prefetch_depth=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _plan(kinds):
    return kinds.FaultPlan.scripted(
        [kinds.FaultEvent(step=12, kind=kinds.FaultKind.GRAD_NAN)])


def _session(factory, **kw):
    session = factory(None, **kw)
    session.enable_spans()
    session.install_watchers(slo_rules=())
    return session


def _jax_run(ckpt):
    """The attacked run, unsupervised (a rollback's restore recompiles
    the JAX step: the ladder's equality is the drills' below)."""
    tr = jtrainer.DistributedTrainer(
        JConfig(checkpoint_dir=ckpt, **TRAIN),
        model_overrides=dict(TINY, dtype=jnp.float32))
    tr.initialize()
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.device_get(tr.state.params))
    attacker = JAttacker(JAttackConfig(attack_types=["gradient_poisoning"],
                                       target_nodes=[2], intensity=0.5,
                                       start_step=8))
    attacker.activate_attacks()
    tr.set_attack_plan(attacker.plan(4))
    session = _session(JSession, registry=JRegistry(), cost_analysis=False)
    tr.attach_obs(session)
    tr.train(jdata.get_dataloader("openwebtext", batch_size=8, seq_len=16,
                                  vocab_size=311, num_examples=64),
             num_epochs=2)
    return params, session


def _port_run(ckpt, params, session=None, supervised=True):
    tr = DistributedTrainer(TrainingConfig(checkpoint_dir=ckpt, **TRAIN),
                            model_overrides=dict(TINY, dtype=torch.float32),
                            device="cpu")
    tr.initialize(params=convert.params_from_jax(params))
    attacker = AdversarialAttacker(AttackConfig(
        attack_types=["gradient_poisoning"], target_nodes=[2],
        intensity=0.5, start_step=8))
    attacker.activate_attacks()
    tr.set_attack_plan(attacker.plan(4))
    loader = get_dataloader("openwebtext", batch_size=8, seq_len=16,
                            vocab_size=311, num_examples=64)
    if not supervised:
        tr.attach_obs(session)
        return tr, tr.train(loader, num_epochs=2)
    sup = supervisor.TrainingSupervisor(
        tr, max_retries=2, rollback_after=2,
        chaos=FaultInjector(_plan(SimpleNamespace(
            FaultPlan=FaultPlan, FaultEvent=FaultEvent,
            FaultKind=FaultKind))), obs=session)
    return tr, sup.run(loader, num_epochs=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs_train")
    params, jsession = _jax_run(str(root / "jax"))
    clean = _session(ObsSession)
    _port_run(str(root / "clean"), params, clean, supervised=False)
    bare, bare_result = _port_run(str(root / "bare"), params)
    session = _session(ObsSession)
    watched, result = _port_run(str(root / "port"), params, session)
    return dict(root=root, jsession=jsession, clean=clean, bare=bare,
                bare_result=bare_result, session=session, watched=watched,
                result=result)


def _events(session, etype=None):
    return [e for e in session.recorder.events()
            if etype is None or e["type"] == etype]


def test_a_session_leaves_the_trajectory_bit_identical(runs):
    bare, watched = runs["bare"], runs["watched"]
    keys = ("step", "loss", "per_node_loss", "weights", "attacked",
            "trust_scores")
    assert [{k: h[k] for k in keys} for h in watched.batch_history] == \
        [{k: h[k] for k in keys} for h in bare.batch_history]
    assert runs["result"]["supervisor"]["rollback_steps"] == \
        runs["bare_result"]["supervisor"]["rollback_steps"] == [10]
    assert runs["result"]["supervisor"]["anomalies_active"] == []


def test_train_events_equal_jax(runs):
    session, jsession = runs["clean"], runs["jsession"]
    steps = _events(session, "train_step")
    jsteps = _events(jsession, "train_step")
    assert [e["step"] for e in steps] == [e["step"] for e in jsteps]
    np.testing.assert_allclose([e["loss"] for e in steps],
                               [e["loss"] for e in jsteps], atol=ATOL,
                               rtol=0)
    for etype, keys in (("detection_verdict",
                         ("step", "node", "attack_type",
                          "ground_truth_positive")),
                        ("trust_transition",
                         ("step", "node", "from_status", "to_status"))):
        got = [{k: e[k] for k in keys} for e in _events(session, etype)]
        assert got == [{k: e[k] for k in keys}
                       for e in _events(jsession, etype)], etype
        assert got, etype
    assert [e["node"] for e in _events(session, "detection_verdict")] == [2]

    def sequence(s):
        # Step-time anomalies are the hosts' own timing, not the run's.
        return [(e["type"], e.get("step")) for e in s.recorder.events()
                if e["type"] not in ("span", "compile")
                and not (e["type"] == "anomaly"
                         and e["signal"] == "step_time")]
    assert sequence(session) == sequence(jsession)
    assert {"ckpt_save", "ckpt_commit"} <= {t for t, _ in sequence(session)}


def test_the_supervised_run_traces_the_ladder(runs):
    events = runs["session"].recorder.events()
    for event in events:
        validate_event(event)
    want = {"train_step", "guard_trip", "supervisor_retry", "chaos_fault",
            "ckpt_commit", "ckpt_save", "ckpt_restore", "flight_dump",
            "supervisor_rollback", "detection_verdict"}
    assert want <= {e["type"] for e in events}
    assert [(e["kind"], e["step"]) for e in events
            if e["type"] == "chaos_fault"] == [("grad_nan", 12)]

    def dumps(side):
        return sorted(n for n in os.listdir(runs["root"] / side)
                      if n.startswith("flight_"))
    # The names JAX's supervisor gives the same ladder (the drill below
    # holds the ladder itself to JAX's).
    assert dumps("port") == ["flight_001_guard_trip_step13.json",
                             "flight_002_rollback_step10.json"]
    assert not dumps("bare")
    with open(runs["root"] / "port" / dumps("port")[1]) as f:
        payload = json.load(f)
    assert payload["reason"] == "rollback" and payload["bad_step"] == 14
    types = [e["type"] for e in payload["events"]]
    assert types.count("guard_trip") == 2 and "supervisor_rollback" in types


def test_the_step_report_splits_the_phases(runs):
    report = runs["session"].step_timer.report()
    phases = report["phases"]
    assert set(phases) == {"data", "compute", "detection", "checkpoint"}
    assert abs(sum(p["fraction"] for p in phases.values()) - 1.0) < 1e-9
    # Accounted steps: every step but the two rejected ones.
    assert report["num_steps"] == len(runs["watched"].batch_history)
    assert report["mfu"]["tokens_per_step"] == 8 * 16
    assert report["mfu"]["peak_flops_source"] == "cpu-nominal-estimate"
    names = {e["name"] for e in _events(runs["session"], "span")}
    assert {"train.step", "train.data", "train.compute"} <= names


# ---------------------------------------------------------------------------
# The JAX obs tests' drills through both packages
# ---------------------------------------------------------------------------


def _rollback_drill(side, sup_module, factory, registry, root):
    """tests/test_obs.py's dump-on-rollback drill: a duck-typed trainer
    whose step stays bad (the GRAD_NAN signature: masked loss 0.0 with no
    finite node) through the real supervisor ladder."""
    ckpt_dir = root / side
    ckpt_dir.mkdir()
    bad = SimpleNamespace(loss=np.float32(0.0), grad_norm=np.float32(0.0),
                          finite=np.zeros(4, bool))

    class FakeTrainer:
        def __init__(self):
            self.global_step = 12
            self.state = {"w": np.zeros(2, np.float32)}
            self.attack_plan = None
            self.step_guard = None
            self.chaos = None
            self.obs = None
            self.training_state = None
            self.config = SimpleNamespace(checkpoint_dir=str(ckpt_dir))
            self.checkpointer = SimpleNamespace(
                verified_steps=lambda: [5], chaos=None, trace=None)
            self.restored = []

        def attach_obs(self, session):
            self.obs = session

        def _train_step(self, state, batch, plan):
            return state, bad

        def load_checkpoint(self, step):
            self.restored.append(step)
            self.global_step = step

    trainer = FakeTrainer()
    session = factory(None, registry=registry())
    sup = sup_module.TrainingSupervisor(trainer, max_retries=1,
                                        rollback_after=2, obs=session)
    assert sup.after_step(trainer, {}, bad) is None
    assert sup.after_step(trainer, {}, bad) is None
    dumps = sorted(p.name for p in ckpt_dir.glob("flight_*.json"))
    with open(ckpt_dir / dumps[-1]) as f:
        payload = json.load(f)
    actions = session.registry.get("tddl_supervisor_actions_total")
    return (trainer.restored, sup.rollbacks, sup.retries, dumps,
            [(e["type"], e.get("step"), e.get("restored_step"))
             for e in payload["events"]],
            {a: actions.value(action=a) for a in
             ("guard_trip", "retry", "bad_step", "rollback")},
            sup.report())


def test_the_rollback_drill_equals_jax(tmp_path):
    jax_ = _rollback_drill("jax", jsupervisor, JSession, JRegistry,
                           tmp_path)
    port = _rollback_drill("port", supervisor, ObsSession, MetricsRegistry,
                           tmp_path)
    assert port == jax_
    restored, rollbacks, retries, dumps, events, actions, _ = port
    assert restored == [5] and (rollbacks, retries) == (1, 2)
    assert [d.split("_")[2] for d in dumps] == ["guard", "rollback"]
    assert ("supervisor_rollback", 12, 5) in events
    assert actions == {"guard_trip": 2.0, "retry": 2.0, "bad_step": 2.0,
                       "rollback": 1.0}


def _chaos_drill(factory, registry, plan_kinds, root):
    """tests/test_obs.py's seeded drill: a stall and a NaN on one step must
    give exactly the plan-predicted anomalies and one anomaly dump."""
    plan = plan_kinds.FaultPlan.scripted([
        plan_kinds.FaultEvent(step=30, kind=plan_kinds.FaultKind.STALL,
                              severity=1.0),
        plan_kinds.FaultEvent(step=30, kind=plan_kinds.FaultKind.GRAD_NAN),
    ], seed=7)
    session = factory(str(root), registry=registry())
    _, anomaly = session.install_watchers(slo_rules=())
    rng = np.random.default_rng(plan.seed)
    for step in range(1, 60):
        stall = plan.at(step, plan_kinds.FaultKind.STALL)
        step_time = 0.1 + float(rng.normal(0, 0.002)) \
            + (stall[0].severity if stall else 0.0)
        loss = 2.0 + float(rng.normal(0, 0.01))
        if plan.at(step, plan_kinds.FaultKind.GRAD_NAN):
            loss = float("nan")
        anomaly.observe("step_time", step_time, step=step)
        anomaly.observe("loss", loss, step=step)
    session.finalize()
    events = read_jsonl(str(root / "trace.jsonl"))
    with open(root / "slo_status.json") as f:
        status = json.load(f)
    reg = session.registry
    return ([(e["signal"], e["step"], e["zscore"]) for e in events
             if e["type"] == "anomaly"],
            sorted(p.name for p in root.glob("flight_*anomaly*.json")),
            reg.get("tddl_anomaly_events_total").value(signal="loss"),
            reg.get("tddl_anomaly_active").value(signal="loss"),
            status["anomaly"])


def test_the_seeded_chaos_drill_equals_jax(tmp_path):
    jax_ = _chaos_drill(JSession, JRegistry, SimpleNamespace(
        FaultPlan=JFaultPlan, FaultEvent=JFaultEvent, FaultKind=JFaultKind),
        tmp_path / "jax")
    port = _chaos_drill(ObsSession, MetricsRegistry, SimpleNamespace(
        FaultPlan=FaultPlan, FaultEvent=FaultEvent, FaultKind=FaultKind),
        tmp_path / "port")
    assert port == jax_
    anomalies, dumps, events, active, status = port
    assert {(s, step) for s, step, _ in anomalies} == {("step_time", 30),
                                                      ("loss", 30)}
    assert len(dumps) == 1 and status["event_total"] == 2
    assert (events, active) == (1.0, 0.0)


# ---------------------------------------------------------------------------
# The runner and cli train
# ---------------------------------------------------------------------------


def test_the_runner_embeds_its_obs_report(tmp_path):
    runner = ExperimentRunner(
        ExperimentConfig("tiny_obs", num_nodes=4, num_epochs=2,
                         batch_size=8, learning_rate=3e-3,
                         attack_start_epoch=1, target_nodes=[2],
                         attack_types=["gradient_poisoning"],
                         steps_per_epoch=4, output_dir=str(tmp_path)),
        model_overrides=dict(TINY, dtype=torch.float32),
        data_overrides=dict(seq_len=16, vocab_size=311, num_examples=32),
        device="cpu")
    runner.run_experiment()
    with open(tmp_path / "tiny_obs" / "experiment_results.json") as f:
        results = json.load(f)
    report = results["obs_report"]
    assert report["num_steps"] == 8 and report["mfu"]["mfu"] > 0
    obs = tmp_path / "tiny_obs" / "obs"
    with open(obs / "obs_report.json") as f:
        assert json.load(f)["num_steps"] == 8
    types = [e["type"] for e in read_jsonl(str(obs / "trace.jsonl"))]
    assert types[0] == "run_start" and types[-1] == "run_end"
    assert types.count("train_step") == 8


#: What only an episode writes: the verdict store's rows, the flight
#: dumps and their incidents.
DEFERRED = ("VERDICTS.jsonl",)


def _artifacts(root):
    return sorted(n for n in os.listdir(root) if n not in DEFERRED
                  and not n.startswith(("flight_", "incident_")))


def test_cli_train_obs_dir_writes_the_jax_artifacts(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.delenv("TDDL_PERF_LEDGER", raising=False)
    monkeypatch.delenv("TDDL_VERDICT_STORE", raising=False)
    real_loader = jdata.get_dataloader

    class JTrainer(jtrainer.DistributedTrainer):
        def __init__(self, config, **kw):
            super().__init__(config, model_overrides=dict(
                TINY, dtype=jnp.float32))

    monkeypatch.setattr(jtrainer, "DistributedTrainer", JTrainer)
    monkeypatch.setattr(jdata, "get_dataloader", lambda *a, **kw:
                        real_loader(*a, **{**kw, "seq_len": 16,
                                           "vocab_size": 311}))
    flags = ["--nodes", "4", "--batch-size", "8", "--epochs", "1",
             "--steps-per-epoch", "3", "--metrics-snapshot-every", "2"]
    assert jcli.main(flags + ["--checkpoint-dir", str(tmp_path / "jc"),
                              "--obs-dir", str(tmp_path / "j")]) == 0
    assert cli.train_main(flags + ["--checkpoint-dir", str(tmp_path / "tc"),
                                   "--obs-dir", str(tmp_path / "t"),
                                   "--device", "cpu", "--seq-len", "16"],
                          model_overrides=dict(TINY,
                                               dtype=torch.float32)) == 0
    out = capsys.readouterr().out
    assert "obs artifacts in" in out
    assert "train-step storms: 0\n" in out
    assert _artifacts(tmp_path / "t") == _artifacts(tmp_path / "j")
    events = read_jsonl(str(tmp_path / "t" / "trace.jsonl"))
    for event in events:
        validate_event(event)
    types = [e["type"] for e in events]
    assert types.count("train_step") == 3 and types[-1] == "run_end"
    assert "metrics_snapshot" in types and "hbm_sweep" in types
