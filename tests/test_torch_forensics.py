"""The port's forensics tier (``obs/forensics.py``, ``obs/verdicts.py``)
against the JAX package's, on the CPU, host-only except for one tiny CPU
serve run (GPT-2: 2 layers, 32 wide, 4 heads, vocab 317, a size no other
test file uses) whose trace and attribution ledger both assemblers read.

* VerdictStore: the same appends give the same rows (apart from the wall
  stamp and ``run_metadata``), keep-trim, torn-line tolerance, history,
  priors, counter and events; the outcome vocabulary is closed alike.
* ``blast_radius`` equals JAX's over hand-built ledgers (paged, stripe,
  migrated, hedge-loser, adapter, tenant and legacy records).
* Both ``IncidentAssembler``s build the same incident from the same
  port-written trace and ledger (a real serve run's, and a scripted
  fleet episode), pair it with the flight dump's index, and render it
  alike; ``load_incidents`` / ``find_incident`` tolerate torn files
  alike.
* The reason vocabulary is JAX's, and every literal reason in the port's
  sources comes from it.
* A supervisor ``guard_trip`` with forensics on writes
  ``incident_NNN_guard_trip.json`` beside its flight dump, as JAX's does.
"""

import ast
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.analysis.contracts import ARTIFACT_REASONS as \
    JREASONS
from trustworthy_dl_tpu.engine import supervisor as jsupervisor
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.obs import ObsSession as JSession
from trustworthy_dl_tpu.obs import forensics as jforensics
from trustworthy_dl_tpu.obs import registry as jregistry
from trustworthy_dl_tpu.obs import verdicts as jverdicts
from trustworthy_dl_tpu_torch.engine import supervisor
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs import ObsSession
from trustworthy_dl_tpu_torch.obs import forensics as tforensics
from trustworthy_dl_tpu_torch.obs import registry as tregistry
from trustworthy_dl_tpu_torch.obs import verdicts as tverdicts
from trustworthy_dl_tpu_torch.obs.attribution import read_ledger
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "trustworthy_dl_tpu_torch"
VOCAB = 317
SIDES = {"port": (tforensics, tverdicts, tregistry),
         "jax": (jforensics, jverdicts, jregistry)}


class RecordingTrace:
    def __init__(self, events=()):
        self.events = [dict(e) for e in events]

    def emit(self, type, **data):
        self.events.append({"type": getattr(type, "value", type), **data})


def _strip(row):
    """A row or incident less its wall stamps and run stamp."""
    return {k: v for k, v in row.items()
            if k not in ("t", "run_metadata", "timestamp")}


# ---------------------------------------------------------------------------
# VerdictStore
# ---------------------------------------------------------------------------


def _verdict_run(side, root):
    _, verdicts, registry = SIDES[side]
    reg = registry.MetricsRegistry()
    trace = RecordingTrace()
    path = root / side / "VERDICTS.jsonl"
    store = verdicts.VerdictStore(str(path), keep=5, registry=reg,
                                  trace=trace)
    store.append("vote", "outvoted", replica=2, request_id=7,
                 reason="verdict_outvoted", tick=9)
    store.append("quarantine", "quarantined", replica=2, tick=11)
    store.append("adapter_quarantine", "quarantined", adapter="ad-x",
                 tenant="acme", reason="adapter_poison", tick=12)
    store.append("suspicion", "opened", replica=1, tick=13,
                 extra={"score": 0.4})
    with open(path, "a") as f:
        f.write('{"kind": "torn\n')
    store.append("incident", "recorded", replica=2,
                 incident_id="incident_003_replica_quarantine", step=4)
    store.append("suspicion", "closed", replica=1, tick=20)
    with pytest.raises(ValueError):
        store.append("vote", "maybe")
    return ([_strip(r) for r in store.read()],
            [_strip(r) for r in store.history(replica=2)],
            store.history(tenant="acme", adapter="ad-x")[0]["kind"],
            store.priors(), [_strip(e) for e in trace.events],
            reg.prometheus_text())


def test_verdict_store_equals_jax(tmp_path):
    port = _verdict_run("port", tmp_path)
    assert port == _verdict_run("jax", tmp_path)
    rows, replica2, _, priors, events, text = port
    assert len(rows) == 5 and rows[0]["kind"] == "quarantine"
    assert [r["kind"] for r in replica2] == ["quarantine", "incident"]
    assert priors["replicas"]["2"]["incidents"] == \
        ["incident_003_replica_quarantine"]
    assert [e["type"] for e in events] == ["verdict"] * 6
    assert 'tddl_verdicts_total{outcome="quarantined"} 2' in text
    assert tverdicts.VERDICT_OUTCOMES == jverdicts.VERDICT_OUTCOMES
    store = tverdicts.VerdictStore(str(tmp_path / "stamp.jsonl"))
    stamp = store.append("incident", "recorded")["run_metadata"]
    assert stamp["platform"] == "unprobed" and "torch_version" in stamp
    with pytest.raises(ValueError):
        tverdicts.VerdictStore(str(tmp_path / "x.jsonl"), keep=0)
    assert tverdicts.VerdictStore(str(tmp_path / "absent.jsonl")).read() \
        == []


# ---------------------------------------------------------------------------
# blast_radius
# ---------------------------------------------------------------------------


def _rec(rid, attempts, admitted=True, **kw):
    return dict({"request_id": rid, "admitted": admitted,
                 "attempts": attempts}, **kw)


BLAST_CASES = {
    "replicas": (
        [_rec(0, [{"journal": "2:0", "layout": "paged",
                   "block_ids": [4, 5]}]),
         _rec(1, [{"journal": "1:0", "layout": "paged", "block_ids": [9]}]),
         _rec(2, [{"journal": "2:0", "layout": None, "block_ids": [],
                   "slot": -1}]),
         _rec(3, [{"journal": "0:0", "layout": "paged", "block_ids": [7],
                   "migrated_from": {"journal": "2:0", "replica": 2,
                                     "block_ids": [1, 2]}}]),
         _rec(4, [{"journal": "2:0", "layout": "paged", "block_ids": [8]}],
              admitted=False),
         _rec(5, [{"journal": "2:0", "layout": "stripe", "slot": 1}]),
         _rec(6, [{"replica": 2, "gen": 0, "block_ids": [3]}])],
        dict(suspect_journals=["2:0"])),
    "adapter_tenant": (
        [_rec(0, [{"journal": "0:0", "block_ids": [1]}], adapter="lora-x",
              adapter_page=3),
         _rec(1, [{"journal": "1:0", "block_ids": [2]}], tenant="acme"),
         _rec(2, [{"journal": "1:0", "block_ids": [3]}], adapter="lora-y")],
        dict(adapter="lora-x", tenant="acme")),
    "legacy": (
        [{"request_id": 9, "admitted": True, "journal": "2:0",
          "layout": "paged", "block_ids": [5]}],
        dict(suspect_journals=["2:0"])),
}


@pytest.mark.parametrize("case", sorted(BLAST_CASES))
def test_blast_radius_equals_jax(case):
    records, kw = BLAST_CASES[case]
    radius = tforensics.blast_radius(records, **kw)
    assert radius == jforensics.blast_radius(records, **kw)
    assert radius["requests"] == {"replicas": [0, 3, 5, 6],
                                  "adapter_tenant": [0, 1],
                                  "legacy": [9]}[case]


# ---------------------------------------------------------------------------
# IncidentAssembler
# ---------------------------------------------------------------------------


def _episode_events():
    """A scripted suspect-2 fleet episode with a bystander replica 1."""
    return [
        {"type": "fleet_suspicion", "replica": 2, "score": 0.4,
         "reason": "attribution"},
        {"type": "serve_admit", "request_id": 0, "replica": 2},
        {"type": "fleet_suspicion", "replica": 1, "score": 0.1,
         "reason": "attribution"},
        {"type": "verdict_vote", "request_id": 0, "replica": 2,
         "outcome": "outvoted"},
        {"type": "replica_transition", "replica": 2,
         "from_state": "healthy", "to_state": "draining",
         "reason": "verdict_outvoted"},
        {"type": "kv_migration", "request_id": 0, "from_replica": 2,
         "to_replica": 0, "blocks": 2, "reason": "drain"},
        {"type": "replica_transition", "replica": 2,
         "from_state": "draining", "to_state": "quarantined",
         "reason": "verdict_outvoted"},
        {"type": "fleet_suspicion", "replica": 2, "score": 0.9,
         "reason": "late"},
    ]


def _scripted_incident(side, root):
    forensics, verdicts, registry = SIDES[side]
    reg = registry.MetricsRegistry()
    trace = RecordingTrace(_episode_events())
    store = verdicts.VerdictStore(str(root / side / "V.jsonl"))
    asm = forensics.IncidentAssembler(str(root / side), trace=trace,
                                      verdicts=store, registry=reg)
    records = [
        _rec(0, [{"journal": "0:0", "block_ids": [3],
                  "migrated_from": {"journal": "2:0", "replica": 2,
                                    "block_ids": [1, 2]}}]),
        _rec(1, [{"journal": "1:0", "block_ids": [9]}])]
    path = asm.assemble(
        "replica_quarantine", tick=7, suspects=[2],
        suspect_journals=["2:0"], trigger_type="replica_transition",
        counters={"quarantines": 1, "failovers": 0}, records=records,
        refusals=[{"replica": 1, "reason": "pool_full"}],
        flight_path=str(root / "flight_004_replica_quarantine.json"))
    with open(path) as f:
        incident = json.load(f)
    memory = forensics.IncidentAssembler(None, trace=trace)
    assert memory.assemble("drill") is None
    return (Path(path).name, _strip(incident),
            [_strip(r) for r in store.read()],
            [dict(_strip(e), path=e["path"] and Path(e["path"]).name)
             if "path" in e else _strip(e)
             for e in trace.events[len(_episode_events()):]],
            reg.prometheus_text(), memory.counts_by_reason(),
            forensics.render_incident(incident),
            forensics.render_blast(incident))


def test_scripted_episode_assembles_and_renders_as_jax(tmp_path):
    port = _scripted_incident("port", tmp_path)
    assert port == _scripted_incident("jax", tmp_path)
    name, incident, verdicts, events, _, counts, shown, blast = port
    assert name == "incident_004_replica_quarantine.json"
    assert [e["seq"] for e in incident["contributing"]] == [1, 4]
    assert incident["trigger"]["seq"] == 7
    assert incident["blast_radius"]["requests"] == [0]
    assert verdicts[0]["incident_id"] == "incident_004_replica_quarantine"
    assert [e["reason"] for e in events] == ["replica_quarantine", "drill"]
    assert counts == {"drill": 1}
    assert "refused destinations:" in shown
    assert "(migrated from replica 2)" in blast


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port CPU serve run under a session with forensics, its flight
    dump and paired incident, and the run's trace and ledger files."""
    jcfg = jgpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_layer=2,
                            n_embd=32, n_head=4, dtype=jnp.float32)
    params = convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jgpt2.init_params(jax.random.PRNGKey(2), jcfg)))
    cfg = gpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_layer=2,
                          n_embd=32, n_head=4, dtype=torch.float32)
    root = tmp_path_factory.mktemp("served")
    s = ObsSession(str(root / "obs"), perf_ledger=str(root / "P.jsonl"))
    s.open_ledger()
    s.enable_forensics()
    engine = ServingEngine(params, cfg, max_slots=2, max_seq=48,
                           block_size=8, prefill_chunk=16, device="cpu",
                           obs=s)
    rng = np.random.default_rng(8)
    for i in range(4):
        engine.submit(ServeRequest(
            prompt=rng.integers(0, VOCAB, 20).tolist(), max_new_tokens=5,
            temperature=0.0, tenant="acme" if i % 2 == 0 else "beta"))
    engine.run_until_idle()
    assert engine.verify_attribution()[0]
    flight = s.dump_flight("manual", step=3, extra={"note": "drill"})
    s.finalize()
    return root / "obs", flight


def test_both_assemblers_build_the_same_incident_from_port_files(served,
                                                                 tmp_path):
    obs_dir, flight = served
    with open(obs_dir / "incident_001_manual.json") as f:
        live = json.load(f)
    _, records = read_ledger(str(obs_dir / "attribution.jsonl"))
    trace_path = str(obs_dir / "trace.jsonl")
    events = [e for e in tforensics.read_jsonl_rotated(trace_path)]
    upto = next(i for i, e in enumerate(events)
                if e["type"] == "flight_dump") + 1
    offline = {}
    for side in SIDES:
        forensics = SIDES[side][0]
        asm = forensics.IncidentAssembler(str(tmp_path / side),
                                          trace_path=trace_path,
                                          ledger=records)
        path = asm.assemble("manual", step=3, flight_path=flight,
                            tenant="acme", events=events[:upto],
                            extra={"note": "drill"})
        with open(path) as f:
            offline[side] = _strip(json.load(f))
    assert offline["port"] == offline["jax"]
    # The live incident is the offline one less the suspect tenant.
    assert {k: v for k, v in offline["port"].items()
            if k not in ("blast_radius", "tenant")} == \
        {k: v for k, v in _strip(live).items()
         if k not in ("blast_radius", "tenant")}
    assert offline["port"]["blast_radius"]["requests"] == [0, 2]
    assert live["blast_radius"]["requests"] == []
    assert offline["port"]["trigger"]["type"] == "manual"
    assert offline["port"]["trigger"]["synthetic"] is True
    for side in SIDES:
        forensics = SIDES[side][0]
        inc = forensics.find_incident(str(tmp_path / side), "1")
        assert inc is not None
    shown = {side: (SIDES[side][0].render_incident(offline["port"]),
                    SIDES[side][0].render_blast(offline["port"]))
             for side in SIDES}
    assert shown["port"] == shown["jax"]


def test_load_and_find_incidents_tolerate_torn_files_as_jax(tmp_path):
    for index, reason in ((2, "guard_trip"), (7, "rollback")):
        with open(tmp_path / f"incident_{index:03d}_{reason}.json",
                  "w") as f:
            json.dump({"incident_id": f"incident_{index:03d}_{reason}",
                       "reason": reason}, f)
    (tmp_path / "incident_009_anomaly.json").write_text("{torn")
    (tmp_path / "flight_001_x.json").write_text("{}")
    for ident in ("7", "guard", "incident_002_guard_trip", "nope", "9"):
        port = tforensics.find_incident(str(tmp_path), ident)
        assert port == jforensics.find_incident(str(tmp_path), ident)
    assert tforensics.load_incidents(str(tmp_path)) == \
        jforensics.load_incidents(str(tmp_path))
    assert [i["reason"] for i in tforensics.load_incidents(
        str(tmp_path))] == ["guard_trip", "rollback"]
    assert tforensics.load_incidents(str(tmp_path / "absent")) == []
    assert tforensics.SIGNAL_EVENTS == jforensics.SIGNAL_EVENTS
    assert tforensics.ACTION_EVENTS == jforensics.ACTION_EVENTS


# ---------------------------------------------------------------------------
# The reason vocabulary
# ---------------------------------------------------------------------------

#: Callables whose first argument is a reason, and the recorder's dump,
#: whose second is (JAX's ``artifact-reason-vocab`` lint rule).
_REASON_FIRST = {"dump_flight", "assemble", "dump"}


def test_every_literal_reason_in_the_port_is_registered():
    assert tforensics.ARTIFACT_REASONS == JREASONS
    found = set()
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, (ast.Attribute, ast.Name))):
                continue
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name not in _REASON_FIRST:
                continue
            args = list(node.args[:2]) + [k.value for k in node.keywords
                                          if k.arg == "reason"]
            for arg in args:
                if isinstance(arg, ast.Constant) and isinstance(
                        arg.value, str) and not arg.value.endswith(
                            (".json", "/")) and "/" not in arg.value:
                    assert arg.value in JREASONS, (path.name, arg.value)
                    found.add(arg.value)
    assert {"guard_trip", "rollback", "slo_breach", "anomaly",
            "compile_storm"} <= found


# ---------------------------------------------------------------------------
# The supervisor's guard_trip with forensics on
# ---------------------------------------------------------------------------


def _guard_trip_drill(side, root):
    """tests/test_obs.py's duck-typed trainer whose step stays bad, with
    forensics on: the guard trip's flight dump gets its incident beside
    it in the checkpoint directory."""
    sup_module, factory = ((supervisor, ObsSession) if side == "port"
                           else (jsupervisor, JSession))
    ckpt_dir = root / side / "ckpt"
    ckpt_dir.mkdir(parents=True)
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

        def attach_obs(self, session):
            self.obs = session

        def _train_step(self, state, batch, plan):
            return state, bad

        def load_checkpoint(self, step):
            self.global_step = step

    trainer = FakeTrainer()
    kw = {} if side == "port" else dict(cost_analysis=False)
    session = factory(str(root / side / "obs"),
                      perf_ledger=str(root / side / "P.jsonl"), **kw)
    session.enable_forensics()
    sup = sup_module.TrainingSupervisor(trainer, max_retries=1,
                                        rollback_after=2, obs=session)
    assert sup.after_step(trainer, {}, bad) is None
    names = sorted(p.name for p in ckpt_dir.iterdir())
    incidents = [_strip(json.load(open(ckpt_dir / n))) for n in names
                 if n.startswith("incident_")]
    for inc in incidents:
        inc["flight_dump"] = Path(inc["flight_dump"]).name
        inc["contributing"] = [_strip(e) for e in inc["contributing"]]
        inc["actions"] = [_strip(e) for e in inc["actions"]]
        inc["trigger"] = _strip(inc["trigger"])
    verdicts = [_strip(r) for r in session.verdicts.read()]
    session.finalize()
    return names, incidents, verdicts


def test_guard_trip_writes_its_incident_beside_the_flight_dump(tmp_path):
    port = _guard_trip_drill("port", tmp_path)
    jax_ = _guard_trip_drill("jax", tmp_path)
    assert port[0] == jax_[0]
    names, incidents, verdicts = port
    assert names == ["flight_001_guard_trip_step12.json",
                     "incident_001_guard_trip.json"]
    assert [i["reason"] for i in incidents] == ["guard_trip"]
    assert incidents[0]["flight_dump"] == names[0]
    assert incidents[0]["trigger"]["type"] == "guard_trip"
    assert [e["type"] for e in incidents[0]["contributing"]] == \
        [e["type"] for e in jax_[1][0]["contributing"]]
    assert [(r["kind"], r["outcome"], r["incident_id"], r["step"])
            for r in verdicts] == [("incident", "recorded",
                                    "incident_001_guard_trip", 12)]
    assert verdicts == jax_[2]
