"""Serving chaos and cancel on one engine, against the JAX package, on the
CPU in f32: ``ServingEngine(chaos=, replica_id=)``, the injector's serve
hook (``FaultInjector.on_serve_retire`` and the compromise states it
reads) and ``ServingEngine.cancel``.

Tiny GPT-2 (2 layers, 32 wide, 4 heads, vocab 349: a size no other test
file uses), weights made on the JAX side and converted with
``models/convert.params_from_jax``.

* The SERVE_POISON drill of JAX's ``tests/test_survival.py:176-209`` on
  the port's stripe and paged engines: request 4 flagged, request 3 not,
  one slot quarantined, ``in_service_capacity`` 1 then 2 after the
  operator's release; every request's flag equal to JAX's engine of the
  same layout on the same weights; one ``serve_poison`` fired; without
  the injector nothing is flagged.
* The replica gate: an event aimed at replica 1 does not fire on replica
  0 (and does on replica 1); the engine's trace events carry the replica.
* The hook's branch order on the same tasks as JAX's injector: an active
  ADAPTER_POISON first, then the adaptive and replica compromises, then
  the plan's event; the heals clear them.
* ``cancel`` of a queued and of an in-flight request: results, statuses,
  the trace's ``(type, request_id, status)`` sequence and the attribution
  records equal JAX's; ``quarantine=True`` impounds the request's blocks
  and its slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.chaos import FaultEvent as JEvent
from trustworthy_dl_tpu.chaos import FaultInjector as JInjector
from trustworthy_dl_tpu.chaos import FaultKind as JKind
from trustworthy_dl_tpu.chaos import FaultPlan as JPlan
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.obs import ObsSession as JSession
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu.serve.engine import OutputMonitor as JMonitor
from trustworthy_dl_tpu_torch.chaos import (FaultEvent, FaultInjector,
                                            FaultKind, FaultPlan)
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs import ObsSession
from trustworthy_dl_tpu_torch.serve import (OutputMonitor, ServeRequest,
                                            ServingEngine)
from trustworthy_dl_tpu_torch.serve.scheduler import SlotTask

pytestmark = pytest.mark.torchport

V = 349
JCFG = jgpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                        n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=V, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
LAYOUTS = {"stripe": dict(paged=False),
           "paged": dict(paged=True, block_size=8)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _drill_traffic():
    """JAX's drill: ids 0..4, prompts of 3-9 tokens, 2-5 new tokens."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(5):
        plen = int(rng.integers(3, 10))
        out.append((rng.integers(0, V, plen).tolist(),
                    int(rng.integers(2, 6))))
    return out


def _jax_engine(jparams, layout, **kw):
    knobs = dict(LAYOUTS[layout])
    if layout == "paged":
        knobs["attn_impl"] = "jnp"
    return JEngine(jparams, JCFG, max_slots=2, max_seq=48, **knobs, **kw)


def _port_engine(tparams, layout, **kw):
    return ServingEngine(tparams, CFG, max_slots=2, max_seq=48,
                         device="cpu", **LAYOUTS[layout], **kw)


@pytest.mark.parametrize("layout", ["stripe", "paged"])
def test_serve_poison_drill_matches_jax(params, layout):
    jparams, tparams = params
    flags = {}
    for side in ("jax", "port"):
        if side == "jax":
            injector = JInjector(JPlan.scripted(
                [JEvent(step=4, kind=JKind.SERVE_POISON)]))
            engine = _jax_engine(jparams, layout, monitor=JMonitor(warmup=3),
                                 chaos=injector)
            request = JRequest
        else:
            injector = FaultInjector(FaultPlan.scripted(
                [FaultEvent(step=4, kind=FaultKind.SERVE_POISON)]))
            engine = _port_engine(tparams, layout,
                                  monitor=OutputMonitor(warmup=3),
                                  chaos=injector)
            request = ServeRequest
        for prompt, new in _drill_traffic():
            engine.submit(request(prompt=prompt, max_new_tokens=new))
        results = engine.run_until_idle()
        flags[side] = {rid: bool(r.flagged) for rid, r in results.items()}
        assert results[4].flagged and not results[3].flagged
        assert len(engine.quarantined_slots) == 1
        assert engine.in_service_capacity == 1
        assert injector.counts() == {"serve_poison": 1}
        engine.release_quarantine(next(iter(engine.quarantined_slots)))
        assert engine.in_service_capacity == 2
    assert flags["port"] == flags["jax"]
    assert sum(flags["port"].values()) == 1
    # The control: the same traffic without the injector flags nothing.
    engine = _port_engine(tparams, layout, monitor=OutputMonitor(warmup=3))
    for prompt, new in _drill_traffic():
        engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
    assert not any(r.flagged for r in engine.run_until_idle().values())
    assert engine.in_service_capacity == 2


def test_replica_gate(params):
    """Request ids are replica-local: an event aimed at replica 1 never
    fires on replica 0's request of that id."""
    _, tparams = params
    fired = {}
    for replica in (0, 1):
        session = ObsSession(None)
        injector = FaultInjector(FaultPlan.scripted(
            [FaultEvent(step=4, kind=FaultKind.SERVE_POISON, target=1)]))
        engine = _port_engine(tparams, "paged", enable_monitor=False,
                              chaos=injector, replica_id=replica,
                              obs=session)
        for prompt, new in _drill_traffic():
            engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
        results = engine.run_until_idle()
        fired[replica] = (injector.counts(),
                          max(results[4].margins) == 1e3,
                          min(results[4].entropies) == 0.0)
        events = session.recorder.events()
        assert events and all(e.get("replica") == replica for e in events
                              if e["type"].startswith("serve_"))
    assert fired[0] == ({}, False, False)
    assert fired[1] == ({"serve_poison": 1}, True, True)


class _Adversary:
    """A stand-in attacker: marks what it corrupted."""

    def __init__(self):
        self.active = True

    def corrupt(self, task):
        task.entropies[:] = [-1.0] * len(task.entropies)

    def deactivate(self):
        self.active = False


def _tasks(adapter):
    jtask = type("T", (), {})()
    jtask.request_id, jtask.adapter = 4, adapter
    jtask.entropies, jtask.margins = [2.0, 2.5], [0.3, 0.4]
    task = SlotTask(request_id=4, prompt=np.zeros(1, np.int32),
                    max_new_tokens=2, temperature=0.0, adapter=adapter)
    task.entropies, task.margins = [2.0, 2.5], [0.3, 0.4]
    return jtask, task


def test_hook_branch_order_matches_jax():
    """The same compromise states armed on both injectors, the same tasks
    retired through both hooks: the same signals come out, branch by
    branch, and the heals clear the persistent states."""
    cases = [
        # (adapter poisoned, adaptive replica, poisoned replica, task's
        #  adapter, retiring replica)
        ({"ad-x": 2.0}, {1: True}, {1: 3.0}, "ad-x", 1),   # adapter first
        ({"ad-x": 2.0}, {1: True}, {1: 3.0}, None, 1),     # then adaptive
        ({}, {}, {1: 3.0}, None, 1),                       # then replica
        ({}, {}, {1: 3.0}, None, 0),                       # then the plan
        ({}, {}, {}, None, 2),                             # plan, gated
    ]
    for adapters, adaptive, replicas, adapter, replica in cases:
        outs = []
        for make_inj, event, kind in (
                (JInjector, JEvent, JKind), (FaultInjector, FaultEvent,
                                             FaultKind)):
            plan = (JPlan if make_inj is JInjector else FaultPlan).scripted(
                [event(step=4, kind=kind.SERVE_POISON, severity=5.0,
                       target=0)])
            inj = make_inj(plan)
            inj._poisoned_adapters.update(adapters)
            inj._poisoned_replicas.update(replicas)
            inj._adaptive_replicas.update(
                {r: _Adversary() for r in adaptive})
            jtask, task = _tasks(adapter)
            t = jtask if make_inj is JInjector else task
            inj.on_serve_retire(t, replica=replica)
            outs.append((list(t.entropies), list(t.margins), inj.counts(),
                         inj.replica_poisoned(1),
                         inj.adapter_poisoned("ad-x")))
            adversaries = dict(inj._adaptive_replicas)
            inj.heal_replica(1)
            inj.heal_adapter("ad-x")
            assert not inj.replica_poisoned(1)
            assert not inj.adapter_poisoned("ad-x")
            assert all(not a.active for a in adversaries.values())
        assert outs[0] == outs[1], (adapters, adaptive, replicas, adapter,
                                    replica)


def _sequence(events):
    return [(e["type"], e.get("request_id"), e.get("status"))
            for e in events]


def test_cancel_matches_jax(params):
    """Three requests on two rows: after two steps cancel the queued one
    and an in-flight one, then drain.  Then a quarantining cancel."""
    jparams, tparams = params
    traffic = _drill_traffic()[:3]
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            session = JSession(None)
            session.open_ledger()
            engine = _jax_engine(jparams, "paged", trace=session.trace,
                                 ledger=session.ledger)
            request = JRequest
        else:
            session = ObsSession(None)
            session.open_ledger()
            engine = _port_engine(tparams, "paged", obs=session)
            request = ServeRequest
        for prompt, new in traffic:
            engine.submit(request(prompt=prompt, max_new_tokens=new + 6))
        engine.step()
        engine.step()
        assert engine.queued_ids == [2] and engine.inflight_ids == [0, 1]
        assert engine.cancel(2) and engine.cancel(0, status="drained")
        assert not engine.cancel(2) and not engine.cancel(99)
        assert engine.load == 1
        results = dict(engine.run_until_idle())
        rid = engine.submit(request(prompt=traffic[0][0],
                                    max_new_tokens=10))
        engine.step()
        engine.step()
        blocks = list(engine.scheduler.tables[0]) or \
            list(engine.scheduler.tables[1])
        assert engine.cancel(rid, status="migrated", quarantine=True)
        assert set(blocks) <= engine.scheduler.blocks.quarantined
        assert engine.in_service_capacity == 1
        assert engine.verify_attribution() == (True, [])
        out[side] = (
            {r: (list(x.tokens), x.status) for r, x in results.items()},
            _sequence(session.recorder.events()),
            [{k: rec[k] for k in ("request_id", "status", "admitted",
                                  "slot", "layout", "block_ids", "tokens",
                                  "token_hash", "flagged")}
             for rec in engine.ledger.records()])
    assert out["port"] == out["jax"]
    statuses = {r: s for r, (_, s) in out["port"][0].items()}
    assert statuses == {0: "drained", 1: "completed", 2: "cancelled"}
    assert ("serve_quarantine", 3, None) in out["port"][1]
