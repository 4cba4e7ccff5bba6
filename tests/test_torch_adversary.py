"""The adaptive adversary (``chaos/adversary.py``) against the JAX
package's, on the CPU.

* ``AdaptivePoisonAttacker.corrupt`` on identical tasks (both modes, with
  and without jitter, a vocab and the low-bit flip): tokens, entropies and
  margins bit-equal to JAX's; ``predict_attacker_trajectory`` and the live
  controller equal JAX's over seeded flag sequences;
  ``MarginSignatureMonitor`` gives JAX's verdicts and scores.
* JAX's adversary fast cases of ``tests/test_fleet.py`` that need an
  attacker, on both sides: the config's validation and the pinned
  controller, the adaptive event without (or with a mis-targeted)
  attacker, ``predict_fleet``'s vote extension and its validity bound.
* JAX's sub-threshold attacker drill on real engines at its tiny geometry
  (vocab 139, 2 layers, 32 wide, f32): 3 replicas, the attacker on replica
  2, ``MarginSignatureMonitor(20.0)``, ``vote_k`` 2.  On both fleets the
  ladder never trips and the vote quarantines replica 2; the counters
  equal ``predict_fleet(vote_k=2)`` and JAX's; the strength trajectory
  equals ``predict_attacker_trajectory`` over the recorded flags and
  JAX's; streams, ledger rows and trace events equal JAX's; unaffected
  streams equal one engine's and corrupted ones differ from it;
  attribution reconciles across the vote replays; no compile storm.
"""

from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import Api, RecordingTrace, SIDES
from trustworthy_dl_tpu.chaos import adversary as jadv
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu_torch.chaos import adversary as tadv
from trustworthy_dl_tpu_torch.models import convert, gpt2

pytestmark = pytest.mark.torchport


def adv(side):
    return tadv if side == "port" else jadv


class _Task:
    def __init__(self, rid, emitted, entropies, margins):
        self.request_id = rid
        self.emitted = list(emitted)
        self.entropies = list(entropies)
        self.margins = list(margins)


CORRUPT_CASES = [
    dict(mode="signal", vocab_size=139, signal_jitter=0.0),
    dict(mode="signal", vocab_size=139, signal_jitter=0.5),
    dict(mode="signal", vocab_size=None, signal_jitter=0.3),
    dict(mode="prompt_drift", vocab_size=50257, signal_jitter=0.5),
    dict(mode="prompt_drift", vocab_size=None, signal_jitter=0.0),
]


@pytest.mark.parametrize("case", CORRUPT_CASES,
                         ids=[f"{c['mode']}-{c['vocab_size']}-"
                              f"{c['signal_jitter']}" for c in CORRUPT_CASES])
def test_corrupt_is_bit_equal_to_jax(case):
    for strength in (0.05, 0.3, 0.77, 1.0):
        outs = []
        for side in SIDES:
            a = adv(side)
            attacker = a.AdaptivePoisonAttacker(a.AdversaryConfig(
                target=1, seed=11, initial_strength=strength,
                min_strength=0.05, **case))
            attacker.activate()
            tasks = []
            for rid, n in enumerate((1, 3, 8, 17, 0)):
                local = np.random.default_rng([rid, n])
                task = _Task(rid, local.integers(0, 139, n).tolist(),
                             local.random(n).tolist(),
                             (local.random(n) * 5).tolist())
                attacker.corrupt(task)
                tasks.append((task.emitted, task.entropies, task.margins))
            outs.append((tasks, attacker.corrupted_ids))
        assert outs[0] == outs[1], strength


def test_inactive_attacker_leaves_the_task_alone():
    attacker = tadv.AdaptivePoisonAttacker(tadv.AdversaryConfig(target=0))
    task = _Task(0, [1, 2], [0.5, 0.4], [1.0, 2.0])
    attacker.corrupt(task)
    attacker.observe(True, 1.0)
    assert (task.emitted, task.margins) == ([1, 2], [1.0, 2.0])
    assert attacker.strength_history == [0.3]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_trajectory_and_live_controller_equal_jax(seed):
    rng = np.random.default_rng(seed)
    flags = [bool(f) for f in rng.random(60) < rng.uniform(0.05, 0.6)]
    kw = dict(target=2, flag_rate_quarantine=0.25,
              safety_margin=float(rng.uniform(0.02, 0.1)),
              initial_strength=0.3, step_up=0.1, backoff=0.5,
              min_strength=0.05, max_strength=1.0)
    got = []
    for side in SIDES:
        a = adv(side)
        cfg = a.AdversaryConfig(**kw)
        predicted = a.predict_attacker_trajectory(cfg, flags, flag_window=16)
        live = a.AdaptivePoisonAttacker(cfg)
        live.activate()
        window = deque(maxlen=16)
        for f in flags:
            window.append(1 if f else 0)
            live.observe(f, sum(window) / len(window))
        assert live.strength_history == predicted
        got.append((predicted, live.flag_observations))
    assert got[0] == got[1]


def test_margin_signature_monitor_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(50):
        n = int(rng.integers(0, 6))
        margins = (rng.random(n) * 40).tolist()
        entropies = rng.random(n).tolist()
        threshold = float(rng.choice([12.0, 20.0, 24.0]))
        assert tadv.MarginSignatureMonitor(threshold).observe(
            entropies, margins) == jadv.MarginSignatureMonitor(
                threshold).observe(entropies, margins)


# --------------------------------------------------------------------------
# JAX's adversary fast cases, both sides
# --------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_adversary_config_validation_and_pinned_controller(side):
    a = adv(side)
    for bad, match in ((dict(mode="nope"), "mode"),
                       (dict(min_strength=0.9, max_strength=0.5),
                        "min_strength"),
                       (dict(corrupt_fraction=0.0), "corrupt_fraction"),
                       (dict(safety_margin=0.0), "safety_margin"),
                       (dict(signal_jitter=1.5), "signal_jitter")):
        with pytest.raises(ValueError, match=match):
            a.AdversaryConfig(target=0, **bad)
    cfg = a.AdversaryConfig(target=1, initial_strength=0.3, step_up=0.1,
                            backoff=0.5, min_strength=0.05,
                            flag_rate_quarantine=0.25, safety_margin=0.05)
    attacker = a.AdaptivePoisonAttacker(cfg)
    attacker.activate()
    flags = [False, False, True, False, False, False]
    window = []
    for f in flags:
        window.append(1 if f else 0)
        attacker.observe(f, sum(window[-8:]) / len(window[-8:]))
    assert attacker.strength_history == \
        a.predict_attacker_trajectory(cfg, flags, flag_window=8)
    assert attacker.strength_history[:4] == [0.3, 0.4, 0.5, 0.25]


@pytest.mark.parametrize("side", SIDES)
def test_adaptive_poison_requires_an_attached_adversary(side):
    api = Api(side)
    a = adv(side)
    with pytest.raises(ValueError, match="no adversary"):
        api.injector([(1, "REPLICA_ADAPTIVE_POISON",
                       dict(target=2))]).on_fleet_tick(1)
    wrong = api.FaultInjector(
        api.FaultPlan.scripted([api.FaultEvent(
            step=1, kind=api.FaultKind.REPLICA_ADAPTIVE_POISON, target=2)]),
        adversary=a.AdaptivePoisonAttacker(a.AdversaryConfig(target=0)))
    with pytest.raises(ValueError, match="configured for replica"):
        wrong.on_fleet_tick(1)


@pytest.mark.parametrize("side", SIDES)
def test_predict_fleet_vote_extension_and_validity_bound(side):
    api = Api(side)
    plan = api.FaultPlan.scripted([api.FaultEvent(
        step=1, kind=api.FaultKind.REPLICA_ADAPTIVE_POISON, target=2)])
    blind = plan.predict_fleet()
    assert blind["adaptive_poisons"] == 1 and blind["suspicions"] == 1
    assert blind["quarantines"] == blind["drains"] == blind["votes"] == 0
    caught = plan.predict_fleet(vote_k=2, vote_outvote_limit=3)
    assert caught["votes"] == caught["outvotes"] == 3
    assert caught["drains"] == caught["quarantines"] == 1
    with pytest.raises(ValueError, match="vote_k=1"):
        plan.predict_fleet(vote_k=1)
    with pytest.raises(ValueError, match="validity bound"):
        plan.predict_fleet(vote_k=2, horizon=500, cooloff_ticks=100)
    assert plan.predict_fleet(vote_k=2, horizon=500,
                              cooloff_ticks=10_000)["quarantines"] == 1


def test_predict_fleet_adaptive_rows_equal_jax():
    views = []
    for side in SIDES:
        api = Api(side)
        plan = api.FaultPlan.scripted([api.FaultEvent(
            step=1, kind=api.FaultKind.REPLICA_ADAPTIVE_POISON, target=2)])
        views.append([plan.predict_fleet(vote_k=k, vote_outvote_limit=m)
                      for k in (0, 2, 3) for m in (1, 2, 4)])
    assert views[0] == views[1]


# --------------------------------------------------------------------------
# The sub-threshold attacker drill on real engines
# --------------------------------------------------------------------------

V = 139
JCFG = jgpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                        n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    torch.set_num_threads(1)
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


class _Obs:
    """The port fleet's telemetry attachments: a compile watcher."""

    def __init__(self, compilewatch):
        self.compilewatch = compilewatch


def subthreshold_drill(side, params):
    """JAX's ``test_adaptive_subthreshold_attacker_caught_by_verdict_
    voting``, its knobs and traffic."""
    api = Api(side)
    a = adv(side)
    if api.port:
        from trustworthy_dl_tpu_torch.obs.compilewatch import (
            CompileRegistry, CompileWatcher)
    else:
        from trustworthy_dl_tpu.obs.compilewatch import (CompileRegistry,
                                                         CompileWatcher)
    adv_cfg = a.AdversaryConfig(
        target=2, seed=5, flag_rate_quarantine=0.25, safety_margin=0.08,
        initial_strength=0.3, step_up=0.1, backoff=0.5, min_strength=0.05,
        max_strength=1.0, signal_scale=40.0, signal_jitter=0.0,
        vocab_size=V)
    attacker = a.AdaptivePoisonAttacker(adv_cfg)
    plan = api.FaultPlan.scripted([api.FaultEvent(
        step=1, kind=api.FaultKind.REPLICA_ADAPTIVE_POISON, target=2)])
    ledger = api.AttributionLedger(None)
    trace = RecordingTrace()
    compiles = CompileRegistry().install()
    try:
        watcher = CompileWatcher(compiles)
        fleet_config = api.FleetConfig(
            num_replicas=3, max_retries=6, flag_window=16, flag_min_count=4,
            flag_rate_quarantine=0.25, suspicion_threshold=0.1,
            suspicion_min_flags=2, vote_k=2, vote_outvote_limit=2,
            quarantine_cooloff_ticks=10_000)
        kwargs = dict(fleet_config=fleet_config,
                      chaos=api.FaultInjector(plan, adversary=attacker),
                      ledger=ledger, registry=api.MetricsRegistry(),
                      max_slots=6, max_seq=48, queue_limit=4,
                      monitor=a.MarginSignatureMonitor(20.0))
        if api.port:
            fleet = api.ServingFleet(params[1], CFG, device="cpu",
                                     obs=_Obs(watcher), **kwargs)
        else:
            fleet = api.ServingFleet(params[0], JCFG, compilewatch=watcher,
                                     **kwargs)
        fleet.trace = trace
        rng = np.random.default_rng(1)
        prepared = deque()
        for _ in range(150):
            plen = int(rng.integers(3, 10))
            new = int(rng.integers(4, 10))
            prepared.append((rng.integers(0, V, plen).tolist(), int(new)))
        reqs = {}
        for _ in range(4000):
            if fleet.replicas[2].state is api.ReplicaState.QUARANTINED:
                break
            while prepared and sum(1 for r in fleet.requests.values()
                                   if not r.done) < 30:
                prompt, new = prepared.popleft()
                fid = fleet.submit(api.ServeRequest(prompt=prompt,
                                                    max_new_tokens=new))
                if fid is None:
                    prepared.appendleft((prompt, new))
                    break
                reqs[fid] = (prompt, new)
            fleet.step()
        results = fleet.run_until_idle(max_ticks=4000)
        storms = watcher.storm_total
    finally:
        compiles.uninstall()

    reasons = {e["reason"] for e in trace.of("replica_transition")
               if e["to_state"] == "draining"}
    assert reasons == {"verdict_outvoted"}
    assert fleet.replicas[2].flag_rate < 0.25
    assert fleet.states() == {0: "healthy", 1: "healthy", 2: "quarantined"}
    predicted = plan.predict_fleet(vote_k=2, vote_outvote_limit=2,
                                   horizon=fleet.tick, cooloff_ticks=10_000)
    assert {k: fleet.counters[k] for k in predicted} == predicted
    flags = [f for f, _ in attacker.flag_observations]
    assert sum(flags) >= 2
    assert attacker.strength_history == a.predict_attacker_trajectory(
        adv_cfg, flags, flag_window=16)
    assert sorted(results) == sorted(reqs)
    assert all(r.status == "completed" for r in results.values())
    records = ledger.records()
    replays = [r for r in records if r.get("status") == "vote_replay"]
    assert len(replays) == 2 * fleet.counters["votes"]
    assert not any(r["admitted"] for r in replays)
    ok, problems = fleet.verify_attribution()
    assert ok, problems
    assert [e["replica"] for e in trace.of("fleet_suspicion")
            if e["reason"] == "flag_rate"] == [2]
    assert len([e for e in trace.of("verdict_vote")
                if e["outcome"] == "outvoted"]) == 2
    assert storms == 0
    return {
        "counters": dict(fleet.counters), "states": fleet.states(),
        "tick": fleet.tick,
        "results": {f: (r.status, list(r.tokens), r.replica, r.attempts,
                        bool(r.flagged)) for f, r in results.items()},
        "reqs": reqs, "trajectory": attacker.strength_history,
        "observations": attacker.flag_observations,
        "corrupted": attacker.corrupted_ids,
        "events": trace.events,
        "ledger": [{k: v for k, v in r.items() if k not in ("ttft_s", "t")}
                   for r in records],
    }


def test_subthreshold_attacker_drill_matches_jax(params):
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    want = subthreshold_drill("jax", params)
    got = subthreshold_drill("port", params)
    # The monitor's score is the mean top-1 margin: within the serving
    # contract's 1e-4.
    scores = [[row.pop("monitor_z", None) for row in side["ledger"]]
              for side in (got, want)]
    assert [z is None for z in scores[0]] == [z is None for z in scores[1]]
    assert all(abs(a - b) <= 1e-4 for a, b in zip(*scores)
               if a is not None)
    for key in want:
        assert got[key] == want[key], key
    engine = ServingEngine(params[1], CFG, max_slots=6, max_seq=48,
                           queue_limit=len(got["reqs"]), device="cpu",
                           enable_monitor=False)
    order = sorted(got["reqs"])
    ids = [engine.submit(ServeRequest(prompt=got["reqs"][f][0],
                                      max_new_tokens=got["reqs"][f][1]))
           for f in order]
    ref = engine.run_until_idle()
    corrupted = clean = 0
    for f, rid in zip(order, ids):
        status, tokens, replica, _, _ = got["results"][f]
        if replica == 2:
            assert tokens != ref[rid].tokens, f
            corrupted += 1
        else:
            assert tokens == ref[rid].tokens, f
            clean += 1
    assert corrupted >= 2 and clean >= 2
