"""The serving fleet's drills on real engines, against the JAX package, on
the CPU in f32: JAX's acceptance drill (``tests/test_fleet.py``), its
REPLICA_PREEMPT drill (``tests/test_migrate.py``) and its ADAPTER_POISON
drill (``tests/test_adapters.py``), each run through both packages' fleets
on the same weights (JAX initialises them, ``models/convert.params_from_jax``
carries them across), plus sampled streams across a crash.

Tiny GPT-2 (2 layers, 32 wide, 4 heads, vocab 107, JAX's fleet drill size).

* Acceptance: REPLICA_POISON on replica 2 at tick 1, REPLICA_CRASH on 0 at
  tick 3, REPLICA_STALL on 1 at tick 6 (severity 10), 3 replicas, 12
  requests.  Counters equal ``predict_fleet()`` and JAX's; every request
  completed with greedy streams equal to JAX's and to one port engine's;
  states ``{0: healthy, 1: healthy, 2: quarantined}``;
  ``verify_attribution()`` holds with a record spanning two journals;
  journals ``0:0`` and ``0:1`` kept; one ``replica_quarantine`` incident
  whose suspects, trigger, counters and blast radius equal JAX's (and an
  independent walk of the ledger).
* Preempt: REPLICA_PREEMPT on replica 0 at tick 3 over 4 requests; both of
  its in-flight requests move as block copies (``kv_migration`` events,
  ``migrated_from`` provenance on journal ``0:0``); migrations, preempts
  and fail-overs equal ``predict_fleet(preempt_inflight=2)`` and JAX's;
  streams equal; the ledger reconciles; one ``replica_preempt`` incident
  whose blast radius equals JAX's.
* Sampled streams: a fleet whose replica 0 crashes mid-stream serves
  temperature-0.9 requests; each equals one port engine's with the seed
  the fleet gave it (JAX's draws differ by design, ROADMAP "Deliberate
  differences").
* ADAPTER_POISON on a 2-replica fleet with rank-4 adapters: the adapter is
  quarantined fleet-wide, both replicas stay healthy with every impounded
  slot released, counts equal ``predict_fleet()`` and JAX's, statuses and
  greedy streams equal JAX's; heal and release readmit it.
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
from trustworthy_dl_tpu.obs import forensics as jforensics
from trustworthy_dl_tpu.obs import verdicts as jverdicts
from trustworthy_dl_tpu_torch import chaos as tchaos
from trustworthy_dl_tpu_torch import serve as tserve
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs import attribution as tattribution
from trustworthy_dl_tpu_torch.obs import forensics as tforensics
from trustworthy_dl_tpu_torch.obs import verdicts as tverdicts

pytestmark = pytest.mark.torchport

V = 107
JCFG = jgpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                        n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
SIDES = ("jax", "port")


@pytest.fixture(scope="module")
def params():
    torch.set_num_threads(1)
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


class PoisonSignatureMonitor:
    """JAX's drill monitor: flags exactly the chaos poison signature
    (a margin far above any real logit margin)."""

    def observe(self, entropies, margins):
        poisoned = float(np.mean(margins)) > 100.0
        return poisoned, (99.0 if poisoned else 0.0)


class RecordingTrace:
    def __init__(self):
        self.events = []

    def emit(self, type, **data):
        self.events.append({"type": getattr(type, "value", type), **data})

    def of(self, type):
        return [e for e in self.events if e["type"] == type]


def _plan(side, events):
    chaos = tchaos if side == "port" else jchaos
    return chaos.FaultPlan.scripted(
        [chaos.FaultEvent(step=s, kind=getattr(chaos.FaultKind, k), **kw)
         for s, k, kw in events])


def _fleet(side, params, fleet_config, **kwargs):
    jparams, tparams = params
    serve = tserve if side == "port" else jserve
    cfg = serve.FleetConfig(**fleet_config)
    if side == "port":
        return serve.ServingFleet(tparams, CFG, fleet_config=cfg,
                                  device="cpu", **kwargs)
    return serve.ServingFleet(jparams, JCFG, fleet_config=cfg, **kwargs)


def _ledger(side):
    return (tattribution if side == "port"
            else jattribution).AttributionLedger(None)


def _traffic(seed, n, plen, new):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = int(rng.integers(*plen))
        m = int(rng.integers(*new))
        out.append((rng.integers(0, V, p).tolist(), m))
    return out


def _engine_streams(tparams, reqs, **kw):
    """One port engine's streams of the same requests (the reference a
    fleet's survivors must equal)."""
    engine = tserve.ServingEngine(tparams, CFG, max_slots=4, max_seq=48,
                                  queue_limit=64, device="cpu", **kw)
    rids = [engine.submit(tserve.ServeRequest(prompt=p, max_new_tokens=m,
                                              **extra))
            for p, m, extra in reqs]
    results = engine.run_until_idle()
    return [results[r].tokens for r in rids]


def _touched(admitted, journal):
    """An independent walk: requests whose attempts decoded off the
    journal's blocks, directly or as ``migrated_from`` provenance."""
    touched = set()
    for rec in admitted:
        for att in rec.get("attempts") or []:
            placed = bool(att.get("block_ids")) or (
                att.get("layout") == "stripe" and att.get("slot", -1) >= 0)
            if att.get("journal") == journal and placed:
                touched.add(rec["request_id"])
            if (att.get("migrated_from") or {}).get("journal") == journal:
                touched.add(rec["request_id"])
    return sorted(touched)


ACCEPTANCE = [(1, "REPLICA_POISON", dict(target=2)),
              (3, "REPLICA_CRASH", dict(target=0)),
              (6, "REPLICA_STALL", dict(target=1, severity=10))]


def _acceptance(side, params, tmp_path):
    serve = tserve if side == "port" else jserve
    forensics = tforensics if side == "port" else jforensics
    verdicts = tverdicts if side == "port" else jverdicts
    chaos = tchaos if side == "port" else jchaos
    plan = _plan(side, ACCEPTANCE)
    inj = chaos.FaultInjector(plan)
    ledger = _ledger(side)
    trace = RecordingTrace()
    store = verdicts.VerdictStore(str(tmp_path / "VERDICTS.jsonl"))
    assembler = forensics.IncidentAssembler(str(tmp_path), trace=trace,
                                            ledger=ledger, verdicts=store)
    fleet = _fleet(side, params,
                   dict(num_replicas=3, max_retries=6,
                        heartbeat_miss_limit=3, restart_ticks=2,
                        drain_grace_ticks=4,
                        quarantine_cooloff_ticks=10_000),
                   chaos=inj, ledger=ledger, max_slots=2, max_seq=48,
                   queue_limit=32, monitor=PoisonSignatureMonitor(),
                   forensics=assembler)
    fleet.trace = trace
    reqs = _traffic(1, 12, (3, 10), (4, 10))
    for prompt, new in reqs:
        fleet.submit(serve.ServeRequest(prompt=prompt, max_new_tokens=new))
    results = fleet.run_until_idle(max_ticks=2000)

    predicted = plan.predict_fleet()
    observed = {k: fleet.counters[k] for k in predicted}
    assert observed == predicted, (observed, predicted)
    assert sorted(results) == list(range(12))
    assert all(r.status == "completed" for r in results.values())
    assert fleet.states() == {0: "healthy", 1: "healthy", 2: "quarantined"}
    assert inj.counts() == {"replica_poison": 1, "replica_crash": 1,
                            "replica_stall": 1}
    ok, problems = fleet.verify_attribution()
    assert ok, problems
    admitted = [r for r in ledger.records() if r.get("admitted")]
    assert sorted(r["request_id"] for r in admitted) == list(range(12))
    spanning = sorted(r["request_id"] for r in admitted
                      if r.get("attempts")
                      and len({a["journal"] for a in r["attempts"]}) > 1)
    assert spanning, "no record spans two replicas' journals"
    assert "0:0" in fleet.journals and "0:1" in fleet.journals

    incidents = forensics.load_incidents(str(tmp_path))
    quar = [i for i in incidents if i["reason"] == "replica_quarantine"]
    assert len(quar) == predicted["quarantines"] == 1
    inc = quar[0]
    trig = inc["trigger"]
    assert trig["type"] == "replica_transition"
    assert trig["replica"] == 2 and trig["to_state"] == "quarantined"
    assert inc["counters"]["quarantines"] == 1
    touched = _touched(admitted, "2:0")
    assert touched and inc["blast_radius"]["requests"] == touched
    priors = store.priors()["replicas"]["2"]
    assert priors["counts"].get("quarantine:quarantined") == 1
    return {
        "counters": dict(fleet.counters), "states": fleet.states(),
        "results": {f: (r.status, r.tokens, r.replica, r.attempts)
                    for f, r in results.items()},
        "journals": sorted(fleet.journals), "spanning": spanning,
        "incident": (inc["suspect_replicas"], inc["suspect_journals"],
                     inc["blast_radius"]["requests"],
                     sorted(inc["blast_radius"]["suspect_blocks"]),
                     trig["to_state"], trig["reason"], inc["counters"]),
        "transitions": [(e["replica"], e["from_state"], e["to_state"],
                         e["reason"], e["tick"])
                        for e in trace.of("replica_transition")],
        "failovers": [(e["request_id"], e["from_replica"], e["reason"],
                       e["due_tick"]) for e in trace.of("fleet_failover")],
        "migrations": [(e["request_id"], e["from_replica"],
                        e["to_replica"], e["reason"])
                       for e in trace.of("kv_migration")],
        "ledger": [(r["request_id"], r["status"], r["admitted"],
                    r.get("replica"),
                    [(a["journal"], a["outcome"], a.get("slot"),
                      len(a.get("block_ids") or []))
                     for a in r.get("attempts") or []])
                   for r in ledger.records()],
    }, reqs


def test_acceptance_drill_matches_jax(params, tmp_path):
    jview, reqs = _acceptance("jax", params, tmp_path / "jax")
    tview, _ = _acceptance("port", params, tmp_path / "port")
    assert tview == jview
    # ...and every stream equals one port engine's.
    ref = _engine_streams(params[1], [(p, m, {}) for p, m in reqs])
    assert [tview["results"][f][1] for f in range(12)] == ref


def _preempt(side, params, tmp_path):
    serve = tserve if side == "port" else jserve
    forensics = tforensics if side == "port" else jforensics
    chaos = tchaos if side == "port" else jchaos
    plan = _plan(side, [(3, "REPLICA_PREEMPT", dict(target=0))])
    ledger = _ledger(side)
    trace = RecordingTrace()
    assembler = forensics.IncidentAssembler(str(tmp_path), trace=trace,
                                            ledger=ledger)
    fleet = _fleet(side, params,
                   dict(num_replicas=3, max_retries=6,
                        heartbeat_miss_limit=3, restart_ticks=2,
                        drain_grace_ticks=4),
                   chaos=chaos.FaultInjector(plan), ledger=ledger,
                   max_slots=2, max_seq=48, queue_limit=32,
                   forensics=assembler)
    fleet.trace = trace
    reqs = _traffic(7, 4, (3, 8), (8, 12))
    for prompt, new in reqs:
        fleet.submit(serve.ServeRequest(prompt=prompt, max_new_tokens=new))
    results = fleet.run_until_idle(max_ticks=2000)
    assert sorted(results) == list(range(4))
    assert all(r.status == "completed" for r in results.values())
    predicted = plan.predict_fleet(preempt_inflight=2)
    observed = {k: fleet.counters[k] for k in predicted}
    assert observed == predicted, (observed, predicted)
    assert fleet.counters["migrations"] == 2
    assert fleet.counters["failover_episodes"] == 0
    migs = trace.of("kv_migration")
    assert len(migs) == 2
    assert all(e["from_replica"] == 0 and e["reason"] == "preempt"
               and e["blocks"] >= 1 for e in migs)
    ok, problems = fleet.verify_attribution()
    assert ok, problems
    spanning = [r for r in ledger.records()
                if r.get("admitted") and r.get("attempts")
                and any(a.get("migrated_from") for a in r["attempts"])]
    assert len(spanning) == 2
    for rec in spanning:
        mf = next(a["migrated_from"] for a in rec["attempts"]
                  if a.get("migrated_from"))
        assert mf["replica"] == 0 and mf["journal"] == "0:0"
        assert len(mf["block_ids"]) >= 1
    incidents = forensics.load_incidents(str(tmp_path))
    assert [i["reason"] for i in incidents] == ["replica_preempt"]
    inc = incidents[0]
    assert inc["suspect_journals"] == ["0:0"]
    assert inc["trigger"]["reason"] == "preempt"
    assert len([e for e in inc["actions"]
                if e["type"] == "kv_migration"]) == 2
    assert inc["blast_radius"]["requests"] == sorted(
        r["request_id"] for r in spanning)
    return {
        "counters": dict(fleet.counters), "states": fleet.states(),
        "results": {f: (r.status, r.tokens, r.replica)
                    for f, r in results.items()},
        "migrations": [(e["request_id"], e["to_replica"], e["blocks"])
                       for e in migs],
        "blast": inc["blast_radius"]["requests"],
    }, reqs


def test_preempt_drill_matches_jax(params, tmp_path):
    jview, reqs = _preempt("jax", params, tmp_path / "jax")
    tview, _ = _preempt("port", params, tmp_path / "port")
    assert tview == jview
    ref = _engine_streams(params[1], [(p, m, {}) for p, m in reqs])
    assert [tview["results"][f][1] for f in range(4)] == ref


def test_sampled_streams_across_a_crash_equal_one_engine(params):
    """Every attempt of a fleet request replays the one seed the fleet
    gave it, so a stream that crossed a crash equals one engine's."""
    plan = _plan("port", [(3, "REPLICA_CRASH", dict(target=0))])
    fleet = _fleet("port", params,
                   dict(num_replicas=2, restart_ticks=2,
                        backoff_base_ticks=0),
                   chaos=tchaos.FaultInjector(plan), max_slots=2,
                   max_seq=48, queue_limit=32, seed=11)
    reqs = _traffic(5, 4, (3, 8), (6, 10))
    fids = [fleet.submit(tserve.ServeRequest(prompt=p, max_new_tokens=m,
                                             temperature=0.9))
            for p, m in reqs]
    seeds = {f: fleet.requests[f].seed for f in fids}
    results = fleet.run_until_idle(max_ticks=2000)
    assert fleet.counters["crashes"] == 1
    assert fleet.counters["failovers"] >= 1
    assert any(r.attempts > 1 for r in results.values())
    ref = _engine_streams(params[1], [
        (p, m, dict(temperature=0.9, seed=seeds[f]))
        for f, (p, m) in zip(fids, reqs)])
    assert [results[f].tokens for f in fids] == ref
    # An explicit request seed wins over the fleet's.
    fid = fleet.submit(tserve.ServeRequest(prompt=[1, 2, 3],
                                           max_new_tokens=2, seed=99))
    assert fleet.requests[fid].seed == 99


def _adapter_poison(side, params):
    serve = tserve if side == "port" else jserve
    chaos = tchaos if side == "port" else jchaos
    plan = _plan(side, [(1, "ADAPTER_POISON", dict(tenant="ad-ev"))])
    inj = chaos.FaultInjector(plan)
    fleet = _fleet(side, params,
                   dict(num_replicas=2, flag_min_count=2,
                        quarantine_cooloff_ticks=10_000),
                   chaos=inj, max_slots=2, max_seq=48, queue_limit=32,
                   paged=True, block_size=8, num_blocks=32, adapter_rank=4,
                   adapter_pool_pages=4,
                   adapter_map={"t-evil": "ad-ev", "t-good": "ad-ok"},
                   monitor=PoisonSignatureMonitor())
    rng = np.random.default_rng(3)
    good = []
    for i in range(8):
        tenant = "t-evil" if i % 2 == 0 else "t-good"
        fid = fleet.submit(serve.ServeRequest(
            prompt=rng.integers(0, V, 5).tolist(), max_new_tokens=4,
            tenant=tenant))
        assert fid is not None
        if tenant == "t-good":
            good.append(fid)
    results = dict(fleet.run_until_idle(max_ticks=2000))
    predicted = plan.predict_fleet()
    observed = {k: fleet.counters[k] for k in predicted}
    assert observed == predicted, (observed, predicted)
    assert fleet.quarantined_adapters == {"ad-ev"}
    assert fleet.states() == {0: "healthy", 1: "healthy"}
    assert inj.counts() == {"adapter_poison": 1}
    for rep in fleet.replicas:
        assert rep.engine.quarantined_slots == set()
        assert rep.engine.in_service_capacity == 2
    for fid in good:
        assert results[fid].status == "completed"
        assert not results[fid].flagged
    assert fleet.submit(serve.ServeRequest(prompt=[1, 2, 3],
                                           max_new_tokens=2,
                                           tenant="t-evil")) is None
    inj.heal_adapter("ad-ev")
    fleet.release_adapter_quarantine("ad-ev")
    fid = fleet.submit(serve.ServeRequest(prompt=[4, 5, 6],
                                          max_new_tokens=3,
                                          tenant="t-evil"))
    readmitted = fleet.run_until_idle(max_ticks=2000)
    assert readmitted[fid].status == "completed"
    assert not readmitted[fid].flagged
    assert fleet.counters["adapter_quarantines"] == 1
    return {"counters": dict(fleet.counters), "states": fleet.states(),
            "results": {f: (r.status, r.tokens, r.replica, bool(r.flagged),
                            r.adapter)
                        for f, r in readmitted.items()}}


def test_adapter_poison_drill_matches_jax(params):
    assert _adapter_poison("port", params) == _adapter_poison("jax", params)
