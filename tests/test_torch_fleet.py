"""The serving fleet's host contracts against the JAX package, on the CPU:
``trustworthy_dl_tpu_torch/serve/fleet.py`` beside
``trustworthy_dl_tpu/serve/fleet.py``, each over a copy of JAX's
``FakeEngine`` (``tests/test_fleet.py``) built on its own package's
``ServeResult``.  Nothing here runs a model.

Every scenario is one of JAX's fast-tier fleet cases that needs no
adaptive adversary, scripted identically on both fleets (the same submits,
``complete(...)`` calls and ticks); each holds JAX's own assertions on both
sides and then compares the two fleets' counters, ``states()``, every
``FleetResult``'s status, tokens, replica and attempt count, the fleet
trace events in order (type, replica, tick and the rest of the event), the
attribution ledger's records (attempts, statuses, ``hedge_lost`` and
``vote_replay`` rows; ``ttft_s`` and the stamp ``t`` left out, they are
wall time) and the registry values the case reads.

Beside them: the control-plane fields accepted with JAX's validation,
tensor-parallel replica widths (``tp_size``/``tp_max``) threaded to every
replica build as in JAX, an attacker attached
to the injector, the injector's fleet hooks against JAX's (fire-once,
persistence, heal, the adaptive event without an adversary), the engine's
fleet surface
(``retire_hook``, replica-labelled series, ``first_submit_id``,
``publish_prefix``), and ``ServingFleet`` raising on a host without CUDA
unless ``device="cpu"`` is passed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu import chaos as jchaos
from trustworthy_dl_tpu import serve as jserve
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.obs import attribution as jattribution
from trustworthy_dl_tpu.obs import registry as jregistry
from trustworthy_dl_tpu_torch import chaos as tchaos
from trustworthy_dl_tpu_torch import serve as tserve
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs import attribution as tattribution
from trustworthy_dl_tpu_torch.obs import registry as tregistry
from trustworthy_dl_tpu_torch.serve import fleet as tfleet

pytestmark = pytest.mark.torchport


class Api:
    """One package's fleet surface."""

    def __init__(self, side):
        self.side = side
        self.port = side == "port"
        serve = tserve if self.port else jserve
        chaos = tchaos if self.port else jchaos
        self.ServeRequest = serve.ServeRequest
        self.ServeResult = serve.ServeResult
        self.FleetConfig = serve.FleetConfig
        self.ServingFleet = serve.ServingFleet
        self.ReplicaState = serve.ReplicaState
        self.backoff_ticks = serve.backoff_ticks
        self.FaultEvent = chaos.FaultEvent
        self.FaultInjector = chaos.FaultInjector
        self.FaultKind = chaos.FaultKind
        self.FaultPlan = chaos.FaultPlan
        self.AttributionLedger = (tattribution if self.port
                                  else jattribution).AttributionLedger
        self.MetricsRegistry = (tregistry if self.port
                                else jregistry).MetricsRegistry

    def injector(self, events):
        return self.FaultInjector(self.FaultPlan.scripted(
            [self.FaultEvent(step=s, kind=getattr(self.FaultKind, k), **kw)
             for s, k, kw in events]))


SIDES = ("jax", "port")


class FakeEngine:
    """JAX's host-only stand-in (``tests/test_fleet.py``): submit, step,
    cancel, queued and in-flight ids, ``retire_hook``.  ``step()`` admits
    the queue; a test finishes requests with ``complete()``.  The port's
    fleet hands its watchers over in the replica's ``obs`` view."""

    def __init__(self, index, api, **kwargs):
        self.index = index
        self.api = api
        self.replica_id = kwargs.get("replica_id")
        self.retire_hook = kwargs.get("retire_hook")
        view = kwargs.get("obs")
        self.slo = view.slo if view is not None else kwargs.get("slo")
        self.anomaly = (view.anomaly if view is not None
                        else kwargs.get("anomaly"))
        self.chaos = kwargs.get("chaos")
        self.tp_size = kwargs.get("tp_size", 1)
        self.tp_devices = kwargs.get("tp_devices")
        self.queue_limit = kwargs.get("queue_limit", 64)
        self.kv_dtype = "model"
        self.weight_dtype = "model"
        self.kv_fallback_reason = None
        self._next = 0
        self.queue = {}
        self.inflight = {}
        self.steps = 0

    def submit(self, request):
        if len(self.queue) >= self.queue_limit:
            return None
        rid = self._next
        self._next += 1
        self.queue[rid] = request
        return rid

    def step(self):
        self.inflight.update(self.queue)
        self.queue.clear()
        self.steps += 1
        return 0

    def cancel(self, rid, status="cancelled"):
        req = self.queue.pop(rid, None) or self.inflight.pop(rid, None)
        if req is None:
            return False
        self.retire_hook(self.api.ServeResult(
            request_id=rid, tokens=[], status=status, ttft_s=None,
            itl_s=[]), None)
        return True

    def complete(self, rid, tokens=(1, 2), status="completed",
                 flagged=False):
        if self.inflight.pop(rid, None) is None:
            del self.queue[rid]
        self.retire_hook(
            self.api.ServeResult(request_id=rid, tokens=list(tokens),
                                 status=status, ttft_s=0.01, itl_s=[],
                                 flagged=flagged),
            {"layout": "stripe", "slot": 0, "block_ids": [],
             "prefix_block_ids": [], "prefix_publishers": {}})

    def shed(self, rid, status="no_capacity"):
        """JAX's tests' manual engine-side shed of a request."""
        self.queue.pop(rid, None)
        self.inflight.pop(rid, None)
        self.retire_hook(self.api.ServeResult(
            request_id=rid, tokens=[], status=status, ttft_s=None,
            itl_s=[]), None)

    @property
    def queued_ids(self):
        return list(self.queue)

    @property
    def inflight_ids(self):
        return list(self.inflight)

    @property
    def load(self):
        return len(self.queue) + len(self.inflight)


class RecordingTrace:
    def __init__(self):
        self.events = []

    def emit(self, type, **data):
        self.events.append({"type": getattr(type, "value", type), **data})

    def of(self, type):
        return [e for e in self.events if e["type"] == type]


def fake_fleet(api, num_replicas=2, chaos=None, ledger=None, registry=None,
               trace=None, **cfg_kwargs):
    fakes = {}

    def factory(index, **kwargs):
        fakes[index] = FakeEngine(index, api, **kwargs)
        return fakes[index]

    kwargs = dict(fleet_config=api.FleetConfig(num_replicas=num_replicas,
                                               **cfg_kwargs),
                  chaos=chaos, ledger=ledger, engine_factory=factory)
    if registry is not None:
        kwargs["registry"] = registry
    if api.port:
        kwargs["device"] = "cpu"
    fleet = api.ServingFleet(**kwargs)
    if trace is not None:
        fleet.trace = trace
    return fleet, fakes


def snapshot(fleet, trace=None, ledger=None, **extra):
    """What the two fleets are compared on."""
    out = {
        "counters": dict(fleet.counters),
        "states": fleet.states(),
        "results": {fid: (r.status, list(r.tokens), r.replica, r.attempts,
                          bool(r.flagged))
                    for fid, r in fleet.results.items()},
        "rejected": fleet.rejected,
        "tick": fleet.tick,
    }
    if trace is not None:
        out["events"] = trace.events
    if ledger is not None:
        out["ledger"] = [{k: v for k, v in r.items()
                          if k not in ("ttft_s", "t")}
                         for r in ledger.records()]
    out.update(extra)
    return out


def _complete_ballots(fleet, fakes, vote_target, tokens):
    for (voter, local), vote in list(fleet._vote_ballots.items()):
        if vote.target != vote_target:
            continue
        toks = tokens[voter] if isinstance(tokens, dict) else tokens
        fakes[voter].complete(local, tokens=toks)
    fleet.step()


# --------------------------------------------------------------------------
# Scenarios: JAX's fast tier, each returning its snapshot
# --------------------------------------------------------------------------


def stall_heartbeat_ladder(api):
    inj = api.injector([(2, "REPLICA_STALL", dict(target=0, severity=12))])
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, chaos=inj, trace=trace,
                              heartbeat_miss_degraded=2,
                              heartbeat_miss_limit=4, restart_ticks=1,
                              backoff_base_ticks=0)
    fid = fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2))
    assert fleet.requests[fid].live.keys() == {0}
    for _ in range(8):
        fleet.step()
    ladder = [(e["from_state"], e["to_state"]) for e in trace.events
              if e["type"] == "replica_transition" and e["replica"] == 0]
    assert ladder[:3] == [("healthy", "degraded"), ("degraded", "draining"),
                          ("draining", "restarting")]
    assert fleet.counters["drains"] == 1
    assert fleet.counters["failover_episodes"] == 1
    assert fleet.counters["failovers"] == 1
    attempt = fleet.requests[fid].live
    assert attempt.keys() == {1}
    fakes[1].complete(attempt[1].local_id, tokens=(7, 8))
    fleet.step()
    assert fleet.results[fid].status == "completed"
    assert fleet.results[fid].replica == 1
    assert fleet.results[fid].tokens == [7, 8]
    for _ in range(12):
        fleet.step()
    assert fleet.replicas[0].state is api.ReplicaState.HEALTHY
    return snapshot(fleet, trace)


def hedge_dedup(api):
    ledger = api.AttributionLedger(None)
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, ledger=ledger, trace=trace,
                              hedge_deadline_s=60.0)
    fid = fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                        deadline_s=30.0))
    fleet.step()
    rec = fleet.requests[fid]
    assert set(rec.live) == {0, 1}
    assert fleet.counters["hedges"] == 1
    fakes[1].complete(rec.live[1].local_id, tokens=(5, 6))
    fleet.step()
    assert fleet.results[fid].status == "completed"
    assert fleet.results[fid].replica == 1
    assert fleet.results[fid].tokens == [5, 6]
    assert fleet.counters["hedge_lost"] == 1
    records = ledger.records()
    admitted = [r for r in records if r.get("admitted")]
    losers = [r for r in records if not r.get("admitted")]
    assert len(admitted) == 1 and admitted[0]["request_id"] == fid
    assert len(losers) == 1 and losers[0]["status"] == "hedge_lost"
    assert losers[0]["replica"] == 0
    assert not fleet.busy
    return snapshot(fleet, trace, ledger)


def drain_blocks_admission(api):
    fleet, fakes = fake_fleet(api, num_replicas=2)
    fleet.replicas[0].state = api.ReplicaState.DRAINING
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    assert fleet.requests[fid].live.keys() == {1}
    fleet.replicas[1].state = api.ReplicaState.DRAINING
    parked = fleet.submit(api.ServeRequest(prompt=[2], max_new_tokens=1))
    rec = fleet.requests[parked]
    assert not rec.live and rec.retry_due is not None
    fleet.replicas[0].state = api.ReplicaState.HEALTHY
    fleet.step()
    assert rec.live.keys() == {0}
    return snapshot(fleet, live={f: sorted(r.live)
                                 for f, r in fleet.requests.items()})


def backpressure(api):
    fleet, fakes = fake_fleet(api, num_replicas=2)
    for f in fakes.values():
        f.queue_limit = 1
    a = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    b = fleet.submit(api.ServeRequest(prompt=[2], max_new_tokens=1))
    assert a is not None and b is not None
    shed = fleet.submit(api.ServeRequest(prompt=[3], max_new_tokens=1))
    assert shed is None
    assert fleet.rejected == 1
    return snapshot(fleet, fids=[a, b, shed])


def crash_failover_retained_journal(api):
    inj = api.injector([(2, "REPLICA_CRASH", dict(target=0))])
    ledger = api.AttributionLedger(None)
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, chaos=inj, ledger=ledger, trace=trace,
                              restart_ticks=2, backoff_base_ticks=0)
    fid = fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2))
    assert fleet.requests[fid].live.keys() == {0}
    fleet.step()
    fleet.step()
    assert fleet.replicas[0].engine is None
    assert fleet.replicas[0].state is api.ReplicaState.RESTARTING
    assert fleet.counters["crashes"] == 1
    assert fleet.counters["failover_episodes"] == 1
    rec = fleet.requests[fid]
    assert rec.closed and rec.closed[0]["outcome"] == "crashed"
    fleet.step()
    assert rec.live.keys() == {1}
    for _ in range(3):
        fleet.step()
    assert fleet.replicas[0].state is api.ReplicaState.HEALTHY
    assert fleet.replicas[0].engine is not None
    assert fleet.replicas[0].gen == 1
    assert fleet.counters["restarts"] == 1
    assert "0:0" in fleet.journals and "0:1" in fleet.journals
    fakes[1].complete(rec.live[1].local_id)
    fleet.step()
    assert fleet.results[fid].status == "completed"
    return snapshot(fleet, trace, ledger, journals=sorted(fleet.journals))


def retry_exhaustion(api):
    ledger = api.AttributionLedger(None)
    fleet, fakes = fake_fleet(api, num_replicas=2, ledger=ledger,
                              max_retries=2, backoff_base_ticks=0)
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    for _ in range(10):
        if fleet.requests.get(fid) is None:
            break
        rec = fleet.requests[fid]
        for rep_idx, att in list(rec.live.items()):
            fakes[rep_idx].shed(att.local_id)
        fleet.step()
    res = fleet.results[fid]
    assert res.status == "failover_exhausted"
    assert res.attempts == 3
    assert fleet.counters["failovers"] == 2
    return snapshot(fleet, ledger=ledger)


def slowstart(api):
    inj = api.injector([(1, "REPLICA_SLOWSTART", dict(target=0,
                                                      severity=5))])
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, chaos=inj, trace=trace)
    fleet.step()
    assert fleet.replicas[0].state is api.ReplicaState.RESTARTING
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    assert fleet.requests[fid].live.keys() == {1}
    assert fleet.counters["slowstarts"] == 1
    assert fleet.counters["failover_episodes"] == 0
    for _ in range(7):
        fleet.step()
    assert fleet.replicas[0].state is api.ReplicaState.HEALTHY
    return snapshot(fleet, trace)


def queue_expiry_flag_window(api):
    fleet, fakes = fake_fleet(api, num_replicas=2)
    fleet._on_terminal(0, api.ServeResult(request_id=99, tokens=[],
                                          status="deadline_exceeded",
                                          ttft_s=None, itl_s=[]), None)
    assert len(fleet.replicas[0].flags) == 0
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    rec = fleet.requests[fid]
    fakes[0].shed(rec.live[0].local_id, status="deadline_exceeded")
    fleet.step()
    assert len(fleet.replicas[0].flags) == 0
    fid2 = fleet.submit(api.ServeRequest(prompt=[2], max_new_tokens=1))
    fakes[0].complete(fleet.requests[fid2].live[0].local_id, flagged=True)
    fleet.step()
    assert list(fleet.replicas[0].flags) == [1]
    return snapshot(fleet, flags=list(fleet.replicas[0].flags))


def chaos_on_quarantined_replica(api):
    inj = api.injector([(3, "REPLICA_CRASH", dict(target=0)),
                        (4, "REPLICA_SLOWSTART", dict(target=0,
                                                      severity=1))])
    fleet, fakes = fake_fleet(api, chaos=inj, quarantine_cooloff_ticks=1000)
    rep = fleet.replicas[0]
    rep.state = api.ReplicaState.QUARANTINED
    rep.cooloff_until = 1000
    for _ in range(6):
        fleet.step()
    assert rep.state is api.ReplicaState.QUARANTINED
    assert rep.cooloff_until == 1000
    assert rep.engine is None
    assert fleet.counters["crashes"] == 1
    assert fleet.counters["failover_episodes"] == 0
    return snapshot(fleet)


def failover_event_names_the_replica_left(api):
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=3, trace=trace,
                              backoff_base_ticks=0, max_retries=4)
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    assert set(fleet.requests[fid].live) == {0}

    def shed_current():
        rec = fleet.requests[fid]
        for rep_idx, att in list(rec.live.items()):
            fakes[rep_idx].shed(att.local_id)
            return rep_idx

    left_a = shed_current()
    fleet.step()
    left_b = shed_current()
    fleet.step()
    failovers = [e for e in trace.events if e["type"] == "fleet_failover"]
    assert len(failovers) == fleet.counters["failovers"] == 2
    assert [e["from_replica"] for e in failovers] == [left_a, left_b]
    return snapshot(fleet, trace)


def suspicion_with_voting_off(api):
    reg = api.MetricsRegistry()
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, registry=reg, trace=trace,
                              flag_window=16, flag_min_count=8,
                              suspicion_threshold=0.1,
                              suspicion_min_flags=2)
    for flagged in (True, False, True, False, False):
        fleet.observe_retirement(0, flagged)
    fleet.step()
    rep = fleet.replicas[0]
    assert rep.state in (api.ReplicaState.HEALTHY,
                         api.ReplicaState.DEGRADED)
    assert fleet.counters["suspicions"] == 1
    assert fleet.counters["votes"] == 0
    episodes = trace.of("fleet_suspicion")
    assert len(episodes) == 1 and episodes[0]["replica"] == 0
    assert episodes[0]["reason"] == "flag_rate"
    gauge = reg.get("tddl_fleet_suspicion").value(replica="0")
    assert gauge == pytest.approx(rep.suspicion)
    assert reg.get("tddl_fleet_suspicions_total").value() == 1.0
    for _ in range(12):
        fleet.observe_retirement(0, False)
    assert not rep.suspicion_episode
    fleet.observe_retirement(0, True)
    fleet.observe_retirement(0, True)
    assert rep.suspicion_episode
    rep.outvotes = 1
    for _ in range(20):
        fleet.observe_retirement(0, False)
    assert rep.suspicion < 0.05 and rep.suspicion_episode
    return snapshot(fleet, trace, gauge=gauge, suspicion=rep.suspicion)


def outvote_ladder(api):
    reg = api.MetricsRegistry()
    trace = RecordingTrace()
    ledger = api.AttributionLedger(None)
    fleet, fakes = fake_fleet(api, num_replicas=3, registry=reg,
                              trace=trace, ledger=ledger, flag_window=16,
                              flag_min_count=8, suspicion_threshold=0.1,
                              suspicion_min_flags=2, vote_k=2,
                              vote_outvote_limit=2, drain_grace_ticks=2)
    fids = [fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2))
            for _ in range(9)]
    on_zero = [fid for fid in fids if 0 in fleet.requests[fid].live]
    assert len(on_zero) == 3

    def finish_on_zero(fid, tokens, flagged):
        fakes[0].complete(fleet.requests[fid].live[0].local_id,
                          tokens=tokens, flagged=flagged)
        fleet.step()

    finish_on_zero(on_zero[0], (1, 2), True)
    assert not fleet._vote_ballots
    fid2 = on_zero[1]
    finish_on_zero(fid2, (3, 4), True)
    assert fleet.counters["suspicions"] == 1
    assert fleet.counters["votes"] == 1
    ballots = {k for k, v in fleet._vote_ballots.items() if v.fid == fid2}
    assert {k[0] for k in ballots} == {1, 2}
    for (voter, local) in ballots:
        replay = (fakes[voter].queue.get(local)
                  or fakes[voter].inflight.get(local))
        assert replay.publish_prefix is False
        assert replay.on_token is None
    _complete_ballots(fleet, fakes, 0, (9, 9))
    assert fleet.counters["outvotes"] == 1
    fid3 = on_zero[2]
    finish_on_zero(fid3, (5, 6), False)
    assert fleet.counters["votes"] == 2
    _complete_ballots(fleet, fakes, 0, (8, 8))
    assert fleet.counters["outvotes"] == 2
    for _ in range(4):
        fleet.step()
    assert fleet.replicas[0].state is api.ReplicaState.QUARANTINED
    assert fleet.counters["drains"] == 1
    assert fleet.counters["quarantines"] == 1
    reasons = [(e["to_state"], e["reason"])
               for e in trace.of("replica_transition") if e["replica"] == 0]
    assert ("draining", "verdict_outvoted") in reasons
    votes = trace.of("verdict_vote")
    assert [v["outcome"] for v in votes] == ["outvoted", "outvoted"]
    assert [v["request_id"] for v in votes] == [fid2, fid3]
    outvoted = reg.get("tddl_fleet_votes_total").value(outcome="outvoted")
    assert outvoted == 2.0
    records = ledger.records()
    replays = [r for r in records if r.get("status") == "vote_replay"]
    assert len(replays) == 4 and not any(r["admitted"] for r in replays)
    assert all(r["vote_target"] == 0 for r in replays)
    admitted = [r for r in records if r.get("admitted")]
    assert sorted(r["request_id"] for r in admitted) == \
        sorted({r["request_id"] for r in admitted})
    return snapshot(fleet, trace, ledger, outvoted=outvoted)


def lone_faulty_voter_k2(api):
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=3, trace=trace, vote_k=2,
                              vote_outvote_limit=1, flag_min_count=8)
    fleet.note_suspicion(0, "attribution")
    assert fleet.counters["suspicions"] == 1
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=2))
    fakes[0].complete(fleet.requests[fid].live[0].local_id, tokens=(1, 2))
    fleet.step()
    assert fleet.counters["votes"] == 1
    _complete_ballots(fleet, fakes, 0, {1: (1, 2), 2: (7, 7)})
    for _ in range(3):
        fleet.step()
    assert fleet.counters["outvotes"] == 0
    assert fleet.replicas[0].state is not api.ReplicaState.QUARANTINED
    assert trace.of("verdict_vote")[0]["outcome"] == "confirmed"
    assert fleet.replicas[2].suspicion > 0.0
    assert any(e["replica"] == 2 and e["reason"] == "vote_dissent"
               for e in trace.of("fleet_suspicion"))
    return snapshot(fleet, trace)


def lone_voter_k1(api):
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=2, trace=trace, vote_k=1,
                              vote_outvote_limit=1, flag_min_count=8)
    fleet.note_suspicion(0, "attribution")
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=2))
    fakes[0].complete(fleet.requests[fid].live[0].local_id, tokens=(1, 2))
    fleet.step()
    assert fleet.counters["votes"] == 1
    _complete_ballots(fleet, fakes, 0, (9, 9))
    for _ in range(3):
        fleet.step()
    assert fleet.counters["outvotes"] == 0
    assert fleet.replicas[0].state is not api.ReplicaState.QUARANTINED
    return snapshot(fleet, trace)


def vote_with_hedged_retries(api):
    ledger = api.AttributionLedger(None)
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=3, ledger=ledger,
                              trace=trace, hedge_deadline_s=60.0, vote_k=2,
                              vote_outvote_limit=5, flag_min_count=8)
    fleet.note_suspicion(1, "attribution")
    fid = fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                        deadline_s=30.0))
    fleet.step()
    rec = fleet.requests[fid]
    assert set(rec.live) == {0, 1}
    fakes[1].complete(rec.live[1].local_id, tokens=(5, 6))
    fleet.step()
    assert fleet.results[fid].replica == 1
    assert fleet.counters["votes"] == 1
    assert fleet.counters["hedge_lost"] == 1
    ballots = {k for k, v in fleet._vote_ballots.items() if v.fid == fid}
    assert {k[0] for k in ballots} == {0, 2}
    _complete_ballots(fleet, fakes, 1, (5, 6))
    for _ in range(2):
        fleet.step()
    assert fleet.counters["votes"] == 1
    assert fleet.counters["outvotes"] == 0
    records = ledger.records()
    admitted = [r for r in records if r.get("admitted")]
    assert len(admitted) == 1 and admitted[0]["request_id"] == fid
    assert sorted(r["status"] for r in records if not r.get("admitted")) \
        == ["hedge_lost", "vote_replay", "vote_replay"]
    assert not fleet.busy
    return snapshot(fleet, trace, ledger)


def crash_of_vote_target(api):
    inj = api.injector([(2, "REPLICA_CRASH", dict(target=0))])
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=3, chaos=inj, trace=trace,
                              vote_k=2, flag_min_count=8, restart_ticks=1,
                              backoff_base_ticks=0)
    fleet.note_suspicion(0, "attribution")
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    fakes[0].complete(fleet.requests[fid].live[0].local_id)
    fleet.step()
    assert fleet.counters["votes"] == 1 and fleet._vote_ballots
    fleet.step()
    assert not fleet._vote_ballots
    assert fleet.counters["outvotes"] == 0
    assert not fleet.busy
    assert fakes[1].load == 0 and fakes[2].load == 0
    return snapshot(fleet, trace)


def crash_of_voters(api):
    inj = api.injector([(3, "REPLICA_CRASH", dict(target=1)),
                        (3, "REPLICA_CRASH", dict(target=2))])
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=3, chaos=inj, trace=trace,
                              vote_k=2, flag_min_count=8, restart_ticks=2)
    fleet.note_suspicion(0, "attribution")
    fid = fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    fakes[0].complete(fleet.requests[fid].live[0].local_id)
    fleet.step()
    assert fleet.counters["votes"] == 1 and fleet.busy
    fleet.step()
    fleet.step()
    assert not fleet._vote_ballots
    assert not fleet.busy
    assert fleet.counters["outvotes"] == 0
    assert fleet.replicas[0].state is not api.ReplicaState.QUARANTINED
    return snapshot(fleet, trace)


def poison_ladder_quarantine_and_probe(api):
    """REPLICA_POISON on a fake fleet: the flag-rate trip drains and
    quarantines the replica; after the cool-off the readmission probe
    re-enters through RESTARTING, re-flags and goes back with a doubled
    cool-off."""
    inj = api.injector([(1, "REPLICA_POISON", dict(target=1))])
    trace = RecordingTrace()
    fleet, fakes = fake_fleet(api, num_replicas=2, chaos=inj, trace=trace,
                              drain_grace_ticks=2,
                              quarantine_cooloff_ticks=3, restart_ticks=1)
    fids = [fleet.submit(api.ServeRequest(prompt=[i], max_new_tokens=1))
            for i in range(4)]
    fleet.step()
    on_one = [f for f in fids if 1 in fleet.requests[f].live]
    for fid in on_one:
        fakes[1].complete(fleet.requests[fid].live[1].local_id,
                          flagged=True)
        fleet.step()
    for _ in range(4):
        fleet.step()
    first = fleet.replicas[1].cooloff_ticks
    for _ in range(8):
        fleet.step()
        if fleet.replicas[1].state is api.ReplicaState.HEALTHY:
            break
    probe = fleet.submit(api.ServeRequest(prompt=[9], max_new_tokens=1))
    fleet.step()
    for _ in range(2):
        if probe in fleet.requests and 1 in fleet.requests[probe].live:
            fakes[1].complete(fleet.requests[probe].live[1].local_id,
                              flagged=True)
        fleet.step()
    return snapshot(fleet, trace, first_cooloff=first,
                    cooloff=fleet.replicas[1].cooloff_ticks,
                    live={f: sorted(r.live)
                          for f, r in fleet.requests.items()})


SCENARIOS = [stall_heartbeat_ladder, hedge_dedup, drain_blocks_admission,
             backpressure, crash_failover_retained_journal, retry_exhaustion,
             slowstart, queue_expiry_flag_window,
             chaos_on_quarantined_replica,
             failover_event_names_the_replica_left,
             suspicion_with_voting_off, outvote_ladder, lone_faulty_voter_k2,
             lone_voter_k1, vote_with_hedged_retries, crash_of_vote_target,
             crash_of_voters, poison_ladder_quarantine_and_probe]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_fake_fleet_matches_jax(scenario):
    jax_view = scenario(Api("jax"))
    port_view = scenario(Api("port"))
    assert port_view == jax_view


# --------------------------------------------------------------------------
# Config, backoff, refusals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_fleet_config_validation_and_backoff_schedule(side):
    api = Api(side)
    for bad in (dict(num_replicas=0), dict(flag_rate_quarantine=0.0),
                dict(flag_min_count=8, flag_window=4),
                dict(backoff_mult=0.5), dict(heartbeat_miss_limit=1),
                dict(suspicion_ewma_alpha=0.0), dict(vote_k=-1),
                dict(tp_size=0), dict(tp_max=1, tp_size=2)):
        with pytest.raises(ValueError):
            api.FleetConfig(**bad)
    cfg = api.FleetConfig(backoff_base_ticks=2, backoff_mult=2.0)
    assert [api.backoff_ticks(cfg, a) for a in (1, 2, 3, 4)] == \
        [2, 4, 8, 16]
    with pytest.raises(ValueError):
        api.backoff_ticks(cfg, 0)


def test_fleet_config_defaults_equal_jax():
    import dataclasses

    jfields = {f.name: f.default for f in dataclasses.fields(
        jserve.FleetConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(
        tserve.FleetConfig)}
    assert tfields == jfields
    assert tserve.ReplicaState.__members__.keys() == \
        jserve.ReplicaState.__members__.keys()
    assert [s.value for s in tserve.ReplicaState] == \
        [s.value for s in jserve.ReplicaState]
    assert tfleet.TERMINAL_STATUSES == jserve.fleet.TERMINAL_STATUSES
    fleet, _ = fake_fleet(Api("port"))
    jfleet, _ = fake_fleet(Api("jax"))
    assert fleet.counters == jfleet.counters


@pytest.mark.parametrize("field", ["slo_classes", "tenant_quota",
                                   "adapter_quota", "autoscale",
                                   "pool_roles"])
def test_control_plane_fields_are_accepted_with_jax_validation(field):
    """Each field builds a fleet config that takes it, and a value JAX
    refuses is refused with JAX's message."""
    good, bad = {
        "slo_classes": (lambda s: s.DEFAULT_SLO_CLASSES, None),
        "tenant_quota": (lambda s: s.TenantQuotaConfig(40.0), None),
        "adapter_quota": (lambda s: s.TenantQuotaConfig(10.0), None),
        "autoscale": (lambda s: s.AutoscalerConfig(min_replicas=2,
                                                   max_replicas=3),
                      lambda s: s.AutoscalerConfig(min_replicas=3,
                                                   max_replicas=4)),
        "pool_roles": (lambda s: ("prefill", "decode"),
                       lambda s: ("decode", "decode")),
    }[field]
    value = good(tserve)
    assert getattr(tserve.FleetConfig(num_replicas=2, **{field: value}),
                   field) is value
    if bad is not None:
        errors = []
        for serve in (tserve, jserve):
            with pytest.raises(ValueError) as exc:
                serve.FleetConfig(num_replicas=2, **{field: bad(serve)})
            errors.append(str(exc.value))
        assert errors[0] == errors[1]


@pytest.mark.parametrize("kwargs", [dict(tp_size=2), dict(tp_max=2)])
def test_tensor_parallel_replicas_are_refused_naming_slice_4(kwargs):
    """Once refused, now JAX's behaviour: the config takes the TP fields,
    and both fleets build every initial replica at the config's width
    (an engine kwarg ``tp_size`` from 2 up, none at 1), count it in
    ``chips_in_service`` and keep it across a rebuild.  JAX carves its 8
    CPU devices into per-replica slices; the port's CPU fleet has one
    device, so its replicas' positions share it (``tp_devices`` None)."""
    width = kwargs.get("tp_size", 1)
    views = []
    for side in SIDES:
        api = Api(side)
        cfg = api.FleetConfig(**kwargs)
        assert (cfg.tp_size, cfg.tp_max) == (width, kwargs.get("tp_max", 0))
        fleet, fakes = fake_fleet(api, **kwargs)
        assert [r.tp for r in fleet.replicas] == [width, width]
        assert fleet.chips_in_service() == 2 * width
        assert [f.tp_size for f in fakes.values()] == [width, width]
        devices = [f.tp_devices for f in fakes.values()]
        if width == 1 or api.port:
            assert devices == [None, None]
        else:
            assert [len(d) for d in devices] == [width, width]
            assert not set(devices[0]) & set(devices[1])
        rep = fleet.replicas[1]
        fleet._build_replica(1, prev=rep)      # a rebuild keeps the width
        assert rep.tp == width and fakes[1].tp_size == width
        views.append((fleet.chips_in_service(), dict(fleet.counters)))
    assert views[0] == views[1]


def test_tp_size_through_the_serve_config_is_refused_naming_slice_4():
    """Once refused, now JAX's behaviour: ``ServeConfig(tp_size=2)`` is
    accepted and 0 refused with JAX's message; a fleet given ``tp_size``
    through its engine kwargs (``from_config``'s path) pops it and builds
    its replicas at the larger of it and the config's width."""
    from trustworthy_dl_tpu.core.config import ServeConfig as JServeConfig
    from trustworthy_dl_tpu_torch.core.config import ServeConfig

    assert ServeConfig().tp_size == 1
    assert ServeConfig(tp_size=2).tp_size == JServeConfig(tp_size=2).tp_size
    errors = []
    for config in (ServeConfig, JServeConfig):
        with pytest.raises(ValueError) as exc:
            config(tp_size=0)
        errors.append(str(exc.value))
    assert errors[0] == errors[1]
    widths = []
    for side in SIDES:
        api = Api(side)
        built = {}

        def factory(index, _api=api, **kw):
            built[index] = FakeEngine(index, _api, **kw)
            return built[index]

        extra = dict(device="cpu") if api.port else {}
        fleet = api.ServingFleet(engine_factory=factory, tp_size=2,
                                 registry=api.MetricsRegistry(), **extra)
        assert fleet._base_tp == 2
        assert "tp_size" not in fleet._engine_kwargs
        widths.append(([r.tp for r in fleet.replicas],
                       [e.tp_size for e in built.values()],
                       fleet.chips_in_service()))
    assert widths[0] == widths[1] == ([2, 2], [2, 2], 4)


def test_injector_adversary_attaches_and_activates():
    """An attacker attaches to the injector; the adaptive event activates
    it on its replica, whose retirements it then corrupts, and a heal
    deactivates it."""
    plan = tchaos.FaultPlan.scripted([tchaos.FaultEvent(
        step=1, kind=tchaos.FaultKind.REPLICA_ADAPTIVE_POISON, target=2)])
    attacker = tchaos.AdaptivePoisonAttacker(tchaos.AdversaryConfig(
        target=2, vocab_size=50))
    inj = tchaos.FaultInjector(plan, adversary=attacker)
    assert inj.adversary is attacker and not attacker.active
    assert [e.kind for e in inj.on_fleet_tick(1)] == \
        [tchaos.FaultKind.REPLICA_ADAPTIVE_POISON]
    assert attacker.active and inj.replica_poisoned(2)
    task = _Task(4)
    task.emitted = [3, 4, 5, 6]
    inj.on_serve_retire(task, replica=2)
    assert attacker.corrupted_ids == [4] and task.margins[0] > 10.0
    inj.on_flag_observed(2, True, 0.5)
    assert len(attacker.strength_history) == 2
    inj.heal_replica(2)
    assert not attacker.active and not inj.replica_poisoned(2)
    assert tchaos.FaultInjector(plan).adversary is None


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a host "
                    "without CUDA")
def test_fleet_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.ServingFleet(engine_factory=lambda i, **kw: FakeEngine(
            i, Api("port"), **kw))
    fleet, _ = fake_fleet(Api("port"))
    assert str(fleet.device) == "cpu"


# --------------------------------------------------------------------------
# The injector's fleet hooks
# --------------------------------------------------------------------------


class _Task:
    def __init__(self, rid, adapter=None):
        self.request_id = rid
        self.adapter = adapter
        self.entropies = [3.0, 3.1]
        self.margins = [0.5, 0.4]


@pytest.mark.parametrize("side", SIDES)
def test_replica_addressed_serve_poison_never_crosses_replicas(side):
    inj = Api(side).injector([(3, "SERVE_POISON", dict(target=1))])
    on_zero = _Task(3)
    inj.on_serve_retire(on_zero, replica=0)
    assert on_zero.margins == [0.5, 0.4] and not inj.fired
    standalone = _Task(3)
    inj.on_serve_retire(standalone)
    assert standalone.margins == [0.5, 0.4]
    on_one = _Task(3)
    inj.on_serve_retire(on_one, replica=1)
    assert on_one.margins[0] > 100.0 and len(inj.fired) == 1
    again = _Task(3)
    inj.on_serve_retire(again, replica=1)
    assert again.margins == [0.5, 0.4]


def _hook_trace(api):
    """The fleet hooks over one plan of every kind the port arms: the
    events each tick returns, the signals of tasks on each replica and
    adapter, and the states after the heals."""
    inj = api.injector([
        (1, "REPLICA_POISON", dict(target=2, severity=2.0)),
        (1, "REPLICA_CRASH", dict(target=0)),
        (2, "ADAPTER_POISON", dict(tenant="ad-x", severity=3.0)),
        (2, "TENANT_FLOOD", dict(tenant="fl", severity=5)),
        (3, "REPLICA_PREEMPT", dict(target=1)),
        (3, "REPLICA_STALL", dict(target=1, severity=4)),
    ])
    out = {"ticks": {t: [(e.kind.value, e.target, e.tenant)
                         for e in inj.on_fleet_tick(t)]
                     for t in (1, 2, 2, 3, 4)}}
    tasks = {}
    for name, (rid, replica, adapter) in {
            "rep2": (0, 2, None), "rep1": (1, 1, None),
            "adapter_on_rep1": (2, 1, "ad-x"),
            "adapter_on_rep2": (3, 2, "ad-x")}.items():
        task = _Task(rid, adapter)
        inj.on_serve_retire(task, replica=replica)
        tasks[name] = (task.entropies, task.margins)
    out["tasks"] = tasks
    inj.on_flag_observed(2, True, 0.5)       # no adaptive attacker: no-op
    out["poisoned"] = (inj.replica_poisoned(2), inj.adapter_poisoned("ad-x"))
    inj.heal_replica(2)
    inj.heal_adapter("ad-x")
    healed = _Task(4)
    inj.on_serve_retire(healed, replica=2)
    out["healed"] = (healed.margins, inj.replica_poisoned(2),
                     inj.adapter_poisoned("ad-x"))
    out["counts"] = inj.counts()
    return out


def test_fleet_hooks_match_jax():
    assert _hook_trace(Api("port")) == _hook_trace(Api("jax"))


@pytest.mark.parametrize("side", SIDES)
def test_adaptive_poison_without_an_adversary_raises(side):
    inj = Api(side).injector([(1, "REPLICA_ADAPTIVE_POISON",
                               dict(target=2))])
    with pytest.raises(ValueError, match="no adversary"):
        inj.on_fleet_tick(1)


@pytest.mark.parametrize("side", SIDES)
def test_replica_poison_persists_until_healed(side):
    api = Api(side)
    inj = api.injector([(1, "REPLICA_POISON", dict(target=2))])
    assert [e.kind for e in inj.on_fleet_tick(1)] == \
        [api.FaultKind.REPLICA_POISON]
    assert inj.on_fleet_tick(2) == []
    for rid in (0, 1):
        t = _Task(rid)
        inj.on_serve_retire(t, replica=2)
        assert t.margins[0] > 100.0
    clean = _Task(2)
    inj.on_serve_retire(clean, replica=1)
    assert clean.margins == [0.5, 0.4]
    inj.heal_replica(2)
    healed = _Task(3)
    inj.on_serve_retire(healed, replica=2)
    assert healed.margins == [0.5, 0.4]


# --------------------------------------------------------------------------
# Real engines: invalid submits, the engine's fleet surface
# --------------------------------------------------------------------------

V = 107
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


@pytest.mark.parametrize("side", SIDES)
def test_invalid_submit_raises_without_orphaning_a_record(params, side):
    api = Api(side)
    jparams, tparams = params
    if api.port:
        fleet = api.ServingFleet(tparams, CFG, num_replicas=2, max_slots=2,
                                 max_seq=32, queue_limit=4, device="cpu")
    else:
        fleet = api.ServingFleet(jparams, JCFG, num_replicas=2,
                                 max_slots=2, max_seq=32, queue_limit=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=0))
    with pytest.raises(ValueError, match="empty prompt"):
        fleet.submit(api.ServeRequest(prompt=[], max_new_tokens=1))
    with pytest.raises(ValueError, match="max_seq"):
        fleet.submit(api.ServeRequest(prompt=[1] * 30, max_new_tokens=10))
    assert not fleet.requests and not fleet.busy
    assert fleet.run_until_idle(max_ticks=2) == {}


def test_engine_fleet_surface(params):
    """``retire_hook`` fires at every terminal with the placement of an
    admitted request (None for a queued one); a replica's series carry
    ``replica=``; a standalone engine's do not; ``first_submit_id`` anchors
    the shed tie-break; ``publish_prefix=False`` publishes nothing."""
    _, tparams = params
    reg = tregistry.MetricsRegistry()
    seen = []
    view = tfleet.ReplicaObs(registry=reg)
    eng = tserve.ServingEngine(tparams, CFG, max_slots=1, max_seq=32,
                               block_size=8, device="cpu", replica_id=1,
                               obs=view, retire_hook=lambda r, p: seen.append(
                                   (r.request_id, r.status, p)))
    a = eng.submit(tserve.ServeRequest(prompt=[1, 2, 3, 4, 5, 6, 7, 8, 9],
                                       max_new_tokens=2,
                                       publish_prefix=False))
    b = eng.submit(tserve.ServeRequest(prompt=[4, 5], max_new_tokens=2))
    eng.step()
    eng.cancel(b, status="vote_abandoned")
    eng.run_until_idle()
    assert [(rid, st) for rid, st, _ in seen] == [(b, "vote_abandoned"),
                                                  (a, "completed")]
    assert seen[0][2] is None and seen[1][2]["block_ids"]
    assert len(eng.scheduler.prefix) == 0           # nothing published
    assert reg.get("tddl_serve_requests_total").value(
        status="completed", replica="1") == 1.0
    assert reg.get("tddl_serve_tokens_total").value(replica="1") == 2.0
    plain = tserve.ServingEngine(tparams, CFG, max_slots=1, max_seq=32,
                                 block_size=8, device="cpu",
                                 obs=tfleet.ReplicaObs(
                                     registry=tregistry.MetricsRegistry()))
    plain.submit(tserve.ServeRequest(prompt=[1, 2, 3, 4, 5, 6, 7, 8, 9],
                                     max_new_tokens=1))
    plain.run_until_idle()
    assert len(plain.scheduler.prefix) == 1         # published
    # The shed tie-break reads the first submission's id: the retry of
    # an old request outlives a newer first submission.
    from trustworthy_dl_tpu_torch.serve.engine import _age_id

    class T:
        request_id = 7

    assert _age_id(T, tserve.ServeRequest(prompt=[1], max_new_tokens=1,
                                          first_submit_id=2)) == 2
    assert _age_id(T, tserve.ServeRequest(prompt=[1],
                                          max_new_tokens=1)) == 7
