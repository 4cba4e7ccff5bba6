"""The fleet's control plane against the JAX package, on the CPU:
``trustworthy_dl_tpu_torch/serve/control.py`` beside
``trustworthy_dl_tpu/serve/control.py``, and the control plane wired into
both packages' ``ServingFleet``.

* The primitives: ``class_for_priority``, ``ClassQueues`` (DRR ``take``,
  stale skips, ``shed_candidate``), ``ClassLatencyTracker``,
  ``TenantBuckets`` (refill, spend, refund), ``diurnal_rate``,
  ``predicted_replicas``, ``autoscale_pressure``, ``choose_scale_action``
  and ``Autoscaler`` (hysteresis, cool-downs, bounds) are fed the same
  seeded inputs on both sides and give equal results; JAX's own
  assertions of ``tests/test_fleet_control.py`` hold on both sides.
* Every fast-tier fleet case of ``tests/test_fleet_control.py`` runs on
  both fleets over the copy of JAX's ``FakeEngine`` in
  ``tests/test_torch_fleet.py``, holds JAX's assertions on both sides, and
  the two fleets' counters, states, results (with tenant and SLO class),
  trace events, ledger rows (``ttft_s`` and the stamp ``t`` left out, they
  are wall time), bucket levels, replica traces, autoscaler decisions and
  the registry values the case reads are equal.
* Real engines at JAX's tiny geometry (vocab 139, 2 layers, 32 wide, f32):
  the flood and autoscale drill, the disaggregated pools, the adapter
  quota (B9's plain twin) and the tenant on an engine's ledger and span.
  Counters, streams, scale events and ledger rows equal JAX's, and the
  drill's counters equal ``predict_fleet``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fleet import Api, FakeEngine, RecordingTrace, SIDES
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.serve import control as jcontrol
from trustworthy_dl_tpu.serve import workload as jworkload
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.serve import control as tcontrol
from trustworthy_dl_tpu_torch.serve import workload as tworkload

pytestmark = pytest.mark.torchport


class CtlApi(Api):
    """One package's fleet surface with its control plane."""

    def __init__(self, side):
        super().__init__(side)
        self.control = tcontrol if self.port else jcontrol
        self.workload = tworkload if self.port else jworkload
        for name in ("SLOClass", "DEFAULT_SLO_CLASSES", "TenantQuotaConfig",
                     "TenantBuckets", "AutoscalerConfig", "Autoscaler",
                     "ScaleSignals", "ClassQueues", "ClassLatencyTracker",
                     "PredictiveArmConfig", "autoscale_pressure",
                     "class_for_priority", "diurnal_rate",
                     "predicted_replicas", "choose_scale_action"):
            setattr(self, name, getattr(self.control, name))


def ctl_fleet(api, num_replicas=2, chaos=None, ledger=None, registry=None,
              trace=None, engine_cls=FakeEngine, **cfg_kwargs):
    """A fake fleet with the control plane's config passed through (JAX's
    ``ctl_fleet``): its trace and registry attached at construction."""
    fakes = {}

    def factory(index, **kwargs):
        fakes[index] = engine_cls(index, api, **kwargs)
        return fakes[index]

    kwargs = dict(fleet_config=api.FleetConfig(num_replicas=num_replicas,
                                               **cfg_kwargs),
                  chaos=chaos, ledger=ledger, engine_factory=factory,
                  registry=registry or api.MetricsRegistry(), trace=trace)
    if api.port:
        kwargs["device"] = "cpu"
    return api.ServingFleet(**kwargs), fakes


def complete_all(fakes):
    for fake in list(fakes.values()):
        for rid in list(fake.inflight):
            fake.complete(rid)


def view(fleet, trace=None, ledger=None, **extra):
    """What the two fleets are compared on."""
    out = {
        "counters": dict(fleet.counters),
        "states": fleet.states(),
        "results": {fid: (r.status, list(r.tokens), r.replica, r.attempts,
                          bool(r.flagged), r.tenant, r.slo_class)
                    for fid, r in fleet.results.items()},
        "rejected": fleet.rejected,
        "tick": fleet.tick,
        "replica_trace": list(fleet.replica_trace),
        "gens": [r.gen for r in fleet.replicas],
        "roles": [r.role for r in fleet.replicas],
        "journals": sorted(fleet.journals),
    }
    if fleet.autoscaler is not None:
        out["decisions"] = dict(fleet.autoscaler.decisions)
    for name in ("_buckets", "_adapter_buckets"):
        buckets = getattr(fleet, name)
        if buckets is not None:
            out[name] = dict(buckets._b)
    if fleet._classq is not None:
        out["class_depth"] = fleet._classq.depth_by_class()
    summary = fleet.metrics_summary()
    for key in ("class_queue_depth", "replicas_in_service",
                "replica_trace"):
        if key in summary:
            out[f"summary.{key}"] = summary[key]
    if "per_class" in summary:
        # The latency percentiles read each package's wall clock: the
        # counts, targets and breaches are compared.
        out["summary.per_class"] = {
            c: {k: v for k, v in s.items() if not k.endswith("_p99_ms")}
            for c, s in summary["per_class"].items()}
    if trace is not None:
        out["events"] = trace.events
    if ledger is not None:
        out["ledger"] = [{k: v for k, v in r.items()
                          if k not in ("ttft_s", "t")}
                         for r in ledger.records()]
    out.update(extra)
    return out


def _series(reg, name, **labels):
    return reg.get(name).value(**labels)


# --------------------------------------------------------------------------
# The primitives
# --------------------------------------------------------------------------


@pytest.mark.parametrize("side", SIDES)
def test_control_config_validation_and_class_mapping(side):
    api = CtlApi(side)
    for bad in (lambda: api.SLOClass("", priority=0),
                lambda: api.SLOClass("x", priority=0, weight=0.0),
                lambda: api.SLOClass("x", priority=0, ttft_target_s=-1.0),
                lambda: api.TenantQuotaConfig(capacity_tokens=0),
                lambda: api.TenantQuotaConfig(capacity_tokens=10,
                                              refill_per_tick=-1),
                lambda: api.AutoscalerConfig(min_replicas=3,
                                             max_replicas=2)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="per_tenant"):
        api.TenantQuotaConfig(capacity_tokens=10, per_tenant={"t": (0, 0.0)})
    with pytest.raises(ValueError, match="hysteresis"):
        api.AutoscalerConfig(scale_up_queue_per_replica=2.0,
                             scale_down_queue_per_replica=2.0)
    with pytest.raises(ValueError, match="hysteresis"):
        api.AutoscalerConfig(scale_up_occupancy=0.5,
                             scale_down_occupancy=0.5)
    with pytest.raises(ValueError, match="autoscale bounds"):
        api.FleetConfig(num_replicas=1, autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=4))
    classes = api.DEFAULT_SLO_CLASSES
    assert [api.class_for_priority(classes, p).name
            for p in (0, 1, 2, 7, -3)] == \
        ["batch", "standard", "premium", "premium", "batch"]


def _errors(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return None


FLEET_CONFIGS = [
    dict(num_replicas=2, pool_roles=("prefill",)),
    dict(num_replicas=2, pool_roles=("prefill", "mixed")),
    dict(num_replicas=2, pool_roles=("decode", "decode")),
    dict(num_replicas=3, pool_roles=("prefill", "decode", "decode")),
    dict(num_replicas=1, autoscale="2-4"),
    dict(num_replicas=5, autoscale="2-4"),
    dict(num_replicas=3, autoscale="2-4"),
    dict(num_replicas=2, slo_classes="default", tenant_quota=40.0,
         adapter_quota=10.0),
    dict(class_queue_limit=0),
]


@pytest.mark.parametrize("kwargs", FLEET_CONFIGS,
                         ids=[str(i) for i in range(len(FLEET_CONFIGS))])
def test_fleet_config_takes_the_control_plane_with_jax_validation(kwargs):
    """The control-plane fields are accepted, and what JAX refuses the
    port refuses with JAX's type and message."""
    def build(api):
        kw = dict(kwargs)
        if kw.get("autoscale") == "2-4":
            kw["autoscale"] = api.AutoscalerConfig(min_replicas=2,
                                                   max_replicas=4)
        if kw.get("slo_classes") == "default":
            kw["slo_classes"] = api.DEFAULT_SLO_CLASSES
        for name in ("tenant_quota", "adapter_quota"):
            if name in kw:
                kw[name] = api.TenantQuotaConfig(capacity_tokens=kw[name])
        return api.FleetConfig(**kw)

    want = _errors(lambda: build(CtlApi("jax")))
    assert _errors(lambda: build(CtlApi("port"))) == want


def _drr_trace(api, seed):
    rng = np.random.default_rng(seed)
    classes = (api.SLOClass("small", priority=0, weight=1.0),
               api.SLOClass("mid", priority=1, weight=2.0),
               api.SLOClass("big", priority=2, weight=3.5))
    cq = api.ClassQueues(classes, quantum_tokens=int(rng.integers(4, 16)),
                         per_class_limit=12)
    out = []
    fid = 0
    dead = set()
    for _ in range(30):
        for _ in range(int(rng.integers(0, 5))):
            name = classes[int(rng.integers(3))].name
            out.append(("push", cq.push(name, fid, int(rng.integers(1, 30)))))
            fid += 1
        if rng.random() < 0.3 and fid:
            dead.add(int(rng.integers(fid)))
        alive = (lambda f: f not in dead)
        taken = cq.take(int(rng.integers(0, 6)), alive)
        out.append(("take", taken))
        if taken and rng.random() < 0.3:
            cq.push_front(*taken[-1])
        if rng.random() < 0.2:
            out.append(("shed", cq.shed_candidate(alive)))
        out.append(("depth", cq.depth(), cq.depth_by_class(),
                    dict(cq._deficit)))
    return out


def _bucket_trace(api, seed):
    rng = np.random.default_rng(seed)
    cfg = api.TenantQuotaConfig(capacity_tokens=40.0, refill_per_tick=1.5,
                                per_tenant={"vip": (100.0, 7.0)})
    b = api.TenantBuckets(cfg)
    out = []
    tick = 0
    for _ in range(60):
        tick += int(rng.integers(0, 4))
        tenant = ("t", "u", "vip")[int(rng.integers(3))]
        cost = float(rng.integers(1, 40))
        op = rng.random()
        if op < 0.6:
            out.append(("spend", b.try_spend(tenant, cost, tick)))
        elif op < 0.8:
            b.refund(tenant, cost, tick)
        out.append(("level", b.level(tenant, tick)))
    return out, dict(b._b)


def _latency_trace(api, seed):
    rng = np.random.default_rng(seed)
    classes = (api.SLOClass("batch", priority=0),
               api.SLOClass("std", priority=1, ttft_target_s=0.5,
                            itl_target_s=0.05))
    tr = api.ClassLatencyTracker(classes, min_count=4)
    out = []
    for _ in range(40):
        name = ("batch", "std", "other")[int(rng.integers(3))]
        tr.observe(name, ttft_s=float(rng.exponential(0.3)),
                   itl_s=[float(x) for x in rng.exponential(0.03, 3)])
        out.append((tr.any_breached(), tr.summary("std"),
                    tr.summary("batch")))
    return out


def _autoscaler_trace(api, seed):
    rng = np.random.default_rng(seed)
    pred = api.PredictiveArmConfig(mean_rps=16.0, burstiness=0.6,
                                   burst_period_s=4.0, per_replica_rps=6.0,
                                   lead_s=0.5,
                                   role_share={"prefill": 0.4,
                                               "decode": 0.6})
    cfg = api.AutoscalerConfig(min_replicas=1, max_replicas=4,
                               scale_up_queue_per_replica=4.0,
                               scale_down_queue_per_replica=1.0,
                               scale_up_occupancy=0.9,
                               scale_down_occupancy=0.3,
                               itl_p99_target_s=0.2,
                               scale_up_cooldown_ticks=3,
                               scale_down_cooldown_ticks=4,
                               scale_down_idle_ticks=2, predictive=pred)
    a = api.Autoscaler(cfg)
    out = []
    n = 2
    for tick in range(80):
        sig = api.ScaleSignals(
            tick=tick, in_service=n,
            queue_per_replica=float(rng.choice([0.0, 0.5, 2.0, 6.0])),
            occupancy=float(rng.choice([0.1, 0.5, 0.95])),
            itl_p99=(None if rng.random() < 0.5
                     else float(rng.exponential(0.1))),
            slo_burning=bool(rng.random() < 0.1),
            predicted_replicas=(None if rng.random() < 0.5 else
                                api.predicted_replicas(pred, tick)),
            down_candidates=bool(rng.random() < 0.9))
        d = a.observe(sig)
        n = min(max(n + d, 1), 4)
        out.append((api.autoscale_pressure(cfg, sig), d,
                    api.choose_scale_action(cfg, sig, 1, 4),
                    api.choose_scale_action(cfg, sig, 2, 2),
                    api.predicted_replicas(pred, tick, role="prefill"),
                    api.predicted_replicas(pred, tick, role="decode")))
    return out, dict(a.decisions)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_primitives_equal_jax_on_seeded_inputs(seed):
    jax_api, port_api = CtlApi("jax"), CtlApi("port")
    for trace in (_drr_trace, _bucket_trace, _latency_trace,
                  _autoscaler_trace):
        assert trace(port_api, seed) == trace(jax_api, seed), trace.__name__
    for t in np.linspace(0.0, 9.0, 37):
        assert port_api.diurnal_rate(16.0, 0.6, 4.0, float(t)) == \
            jax_api.diurnal_rate(16.0, 0.6, 4.0, float(t))
    # The workload reads the control plane's envelope: one spelling.
    assert tworkload.diurnal_rate is tcontrol.diurnal_rate


@pytest.mark.parametrize("side", SIDES)
def test_token_bucket_refill_is_tick_deterministic(side):
    api = CtlApi(side)
    b = api.TenantBuckets(api.TenantQuotaConfig(
        capacity_tokens=40, refill_per_tick=2.0,
        per_tenant={"vip": (100, 10.0)}))
    assert b.try_spend("t", 30, 0)
    assert not b.try_spend("t", 30, 0)
    assert b.try_spend("t", 30, 10)
    assert b.level("t", 10) == 0.0
    assert b.level("t", 30) == 40.0
    assert b.try_spend("vip", 90, 0)
    assert b.try_spend("vip", 90, 9)
    assert b.level("t", 30) == 40.0


@pytest.mark.parametrize("side", SIDES)
def test_drr_dequeue_is_token_weighted_and_skips_stale(side):
    api = CtlApi(side)
    classes = (api.SLOClass("small", priority=0, weight=1.0),
               api.SLOClass("big", priority=1, weight=3.0))
    cq = api.ClassQueues(classes, quantum_tokens=8, per_class_limit=8)
    for i in range(8):
        assert cq.push("small", i, 8)
    assert not cq.push("small", 99, 8)
    for i in range(100, 108):
        assert cq.push("big", i, 8)
    dead = {2, 103}
    taken = cq.take(8, lambda fid: fid not in dead)
    by_class = {"small": 0, "big": 0}
    for name, fid, _cost in taken:
        assert fid not in dead
        by_class[name] += 1
    assert by_class["big"] >= 2 * by_class["small"] > 0
    assert cq.shed_candidate(lambda fid: fid not in dead) == ("small", 7)


@pytest.mark.parametrize("side", SIDES)
def test_autoscaler_hysteresis_cooldown_and_bounds(side):
    api = CtlApi(side)
    cfg = api.AutoscalerConfig(min_replicas=1, max_replicas=3,
                               scale_up_queue_per_replica=4.0,
                               scale_down_queue_per_replica=1.0,
                               scale_up_occupancy=0.9,
                               scale_down_occupancy=0.3,
                               scale_up_cooldown_ticks=5,
                               scale_down_cooldown_ticks=5,
                               scale_down_idle_ticks=3)

    def sig(tick, n, q, occ=0.0, **kw):
        return api.ScaleSignals(tick=tick, in_service=n,
                                queue_per_replica=q, occupancy=occ, **kw)

    assert [api.autoscale_pressure(cfg, s) for s in (
        sig(0, 1, 5.0), sig(0, 1, 2.0), sig(0, 1, 0.5),
        sig(0, 1, 0.5, occ=0.95), sig(0, 1, 0.5, slo_burning=True),
        sig(0, 1, 0.5, predicted_replicas=2))] == [1, 0, -1, 1, 1, 1]
    a = api.Autoscaler(cfg)
    got = [a.observe(sig(t, n, q)) for t, n, q in (
        (1, 1, 8.0), (2, 2, 8.0), (6, 2, 8.0), (11, 3, 8.0), (12, 3, 0.0),
        (13, 3, 0.0), (14, 3, 8.0), (15, 3, 0.0), (16, 3, 0.0),
        (17, 3, 0.0), (18, 2, 0.0))]
    assert got == [1, 0, 1, 0, 0, 0, 0, 0, 0, -1, 0]
    assert a.decisions == {"up": 2, "down": 1}
    # Occupancy pressure under a quiet queue asks for a wider TP group
    # only where there is TP headroom; queue pressure always scales out.
    busy = sig(0, 2, 1.0, occ=0.95)
    assert api.choose_scale_action(cfg, busy, 1, 2) == "up"
    assert api.choose_scale_action(cfg, busy, 2, 2) == "out"
    assert api.choose_scale_action(cfg, sig(0, 2, 9.0, occ=0.95), 1,
                                   2) == "out"


@pytest.mark.parametrize("side", SIDES)
def test_predictive_arm_matches_workload_envelope_and_leads_it(side):
    api = CtlApi(side)
    wl = api.workload.WorkloadConfig(seed=3, num_requests=8, mean_rps=16.0,
                                     burstiness=0.6, burst_period_s=4.0)
    for t in (0.0, 0.7, 1.3, 2.9):
        expected = wl.mean_rps * (1.0 + wl.burstiness * math.sin(
            2.0 * math.pi * t / wl.burst_period_s))
        expected = max(expected, wl.mean_rps * (1.0 - wl.burstiness), 1e-6)
        assert api.diurnal_rate(wl.mean_rps, wl.burstiness,
                                wl.burst_period_s, t) == \
            pytest.approx(expected)
    kw = dict(mean_rps=16.0, burstiness=0.6, burst_period_s=4.0,
              per_replica_rps=8.0, tick_duration_s=0.05)
    assert api.predicted_replicas(
        api.PredictiveArmConfig(lead_s=0.0, **kw), 0) == 2
    assert api.predicted_replicas(
        api.PredictiveArmConfig(lead_s=1.0, **kw), 0) == 4
    with pytest.raises(ValueError):
        api.PredictiveArmConfig(mean_rps=0.0, burstiness=0.5,
                                burst_period_s=1.0, per_replica_rps=1.0)
    with pytest.raises(ValueError, match="sum to <= 1.0"):
        api.PredictiveArmConfig(role_share={"prefill": 0.6,
                                            "decode": 0.6}, **kw)
    with pytest.raises(ValueError, match="declares no share"):
        api.predicted_replicas(api.PredictiveArmConfig(**kw), 0,
                               role="decode")


def test_workload_items_equal_jax_after_the_envelope_moved():
    """The seeded workload is item for item JAX's, its envelope now read
    from the control plane."""
    cfg = dict(seed=5, num_requests=20, mean_rps=16.0, burstiness=0.6,
               prompt_median=6, output_median=5, max_output=8)
    got = tworkload.generate_workload(tworkload.WorkloadConfig(**cfg),
                                      139, 48)
    want = jworkload.generate_workload(jworkload.WorkloadConfig(**cfg),
                                       139, 48)
    assert [dataclasses.astuple(i) for i in got] == \
        [dataclasses.astuple(i) for i in want]


@pytest.mark.parametrize("side", SIDES)
def test_predict_fleet_flood_and_scale_arithmetic(side):
    api = CtlApi(side)
    plan = api.FaultPlan.scripted([
        api.FaultEvent(step=5, kind=api.FaultKind.TENANT_FLOOD, severity=12,
                       tenant="flood"),
        api.FaultEvent(step=400, kind=api.FaultKind.TENANT_FLOOD,
                       severity=3, tenant="flood")])
    blind = plan.predict_fleet()
    assert blind["tenant_floods"] == 2 and blind["throttles"] == 0
    assert blind["scale_ups"] == blind["scale_downs"] == 0
    pinned = plan.predict_fleet(autoscale=True, quota_tokens=40,
                                flood_request_tokens=8)
    assert pinned["throttles"] == 7
    assert pinned["scale_ups"] == pinned["scale_downs"] == 2
    assert pinned["drains"] == 2
    with pytest.raises(ValueError, match="flood_request_tokens"):
        plan.predict_fleet(quota_tokens=40)


# --------------------------------------------------------------------------
# The fleet cases (JAX's fast tier), each returning its view
# --------------------------------------------------------------------------


def tenant_flood_throttles_itself(api):
    reg = api.MetricsRegistry()
    trace = RecordingTrace()
    inj = api.injector([(3, "TENANT_FLOOD", dict(severity=10,
                                                 tenant="flood"))])
    fleet, fakes = ctl_fleet(
        api, num_replicas=2, chaos=inj, registry=reg, trace=trace,
        slo_classes=api.DEFAULT_SLO_CLASSES,
        tenant_quota=api.TenantQuotaConfig(
            capacity_tokens=10_000, refill_per_tick=0.0,
            per_tenant={"flood": (24, 0.0)}))
    ok = [fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                        tenant="acme", priority=2))
          for _ in range(2)]
    assert all(fid is not None for fid in ok)
    for _ in range(3):
        fleet.step()
    assert fleet.counters["tenant_floods"] == 1
    assert fleet.counters["throttles"] == 7
    throttles = trace.of("tenant_throttle")
    assert len(throttles) == 7
    assert all(e["tenant"] == "flood" and e["tokens"] == 8
               for e in throttles)
    throttled = _series(reg, "tddl_fleet_tenant_throttled_total",
                        tenant="flood")
    assert throttled == 7.0
    for _ in range(6):
        complete_all(fakes)
        fleet.step()
    assert not fleet.busy
    by_tenant = {}
    for r in fleet.results.values():
        by_tenant.setdefault(r.tenant, []).append(r.status)
    assert by_tenant == {"acme": ["completed"] * 2,
                         "flood": ["completed"] * 3}
    assert all(r.slo_class == "batch" for r in fleet.results.values()
               if r.tenant == "flood")
    return view(fleet, trace, throttled=throttled,
                depth=_series(reg, "tddl_fleet_class_queue_depth",
                              slo_class="batch"))


def autoscaler_cycle(api):
    reg = api.MetricsRegistry()
    trace = RecordingTrace()
    fleet, fakes = ctl_fleet(
        api, num_replicas=2, registry=reg, trace=trace, restart_ticks=1,
        autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=3, scale_up_queue_per_replica=3.0,
            scale_down_queue_per_replica=0.4, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=2,
            scale_down_cooldown_ticks=2, scale_down_idle_ticks=2))
    fids = [fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2))
            for _ in range(8)]
    fleet.step()
    assert fleet.counters["scale_ups"] == 1 and len(fleet.replicas) == 3
    assert fleet.replicas[2].state is api.ReplicaState.RESTARTING
    for _ in range(8):
        complete_all(fakes)
        fleet.step()
    assert fleet.counters["scale_downs"] == 1
    assert fleet.replicas[2].state is api.ReplicaState.RETIRED
    assert fleet.replicas[2].engine is None and "2:0" in fleet.journals
    assert all(fleet.results[f].status == "completed" for f in fids)
    retired = _series(reg, "tddl_fleet_replicas", state="retired")
    assert retired == 1.0
    assert [(e["direction"], e["from_replicas"], e["to_replicas"])
            for e in trace.of("fleet_scale")] == [("up", 2, 3),
                                                   ("down", 3, 2)]
    assert [n for _, n in fleet.replica_trace] == [2, 3, 2]
    assert fleet.chips_in_service() == 2
    fids2 = [fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2))
             for _ in range(8)]
    fleet.step()
    assert fleet.counters["scale_ups"] == 2 and fleet.replicas[2].gen == 1
    assert "2:1" in fleet.journals
    for _ in range(8):
        complete_all(fakes)
        fleet.step()
    assert all(fleet.results[f].status == "completed" for f in fids2)
    return view(fleet, trace, retired=retired,
                ups=_series(reg, "tddl_fleet_scale_events_total",
                            direction="up"),
                chips=_series(reg, "tddl_fleet_chips"))


def scale_down_runs_out(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=3, drain_grace_ticks=1,
        autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=3, scale_up_queue_per_replica=50.0,
            scale_down_queue_per_replica=2.0, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=1,
            scale_down_cooldown_ticks=1, scale_down_idle_ticks=2))
    fids = [fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2))
            for _ in range(3)]
    victim = next(f for f in fids if 2 in fleet.requests[f].live)
    fleet.step()
    fleet.step()
    assert fleet.counters["scale_downs"] == 1
    rep = fleet.replicas[2]
    assert rep.state is api.ReplicaState.DRAINING
    for _ in range(4):
        fleet.step()
    assert rep.state is api.ReplicaState.DRAINING
    assert fleet.requests[victim].live.keys() == {2}
    assert fleet.counters["failovers"] == 0
    fakes[2].complete(fleet.requests[victim].live[2].local_id,
                      tokens=(9, 9))
    fleet.step()
    fleet.step()
    assert fleet.results[victim].status == "completed"
    assert fleet.results[victim].replica == 2
    assert rep.state is api.ReplicaState.RETIRED
    return view(fleet)


def class_breach_sheds_lowest(api):
    classes = (api.SLOClass("batch", priority=0, weight=1.0),
               api.SLOClass("premium", priority=2, weight=4.0,
                            ttft_target_s=0.001))
    fleet, fakes = ctl_fleet(api, num_replicas=2, slo_classes=classes,
                             class_latency_min_count=2)
    for fake in fakes.values():
        fake.queue_limit = 0
    batch = [fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1,
                                           priority=0)) for _ in range(3)]
    prem = [fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1,
                                          priority=2)) for _ in range(2)]
    fleet._class_latency.observe("premium", ttft_s=1.0)
    fleet._class_latency.observe("premium", ttft_s=1.0)
    assert fleet._class_latency.breached("premium")
    fleet.step()
    fleet.step()
    shed = [fid for fid, r in fleet.results.items()
            if r.status == "shed_slo"]
    assert len(shed) == 2 and set(shed) <= set(batch)
    assert all(fleet.requests.get(f) is not None for f in prem)
    summary = fleet.metrics_summary()
    assert summary["per_class"]["batch"]["shed"] == 2
    assert summary["per_class"]["premium"]["shed"] == 0
    assert summary["per_class"]["premium"]["breached"] is True
    return view(fleet)


def tenant_threads_to_ledger(api):
    ledger = api.AttributionLedger(None)
    fleet, fakes = ctl_fleet(api, num_replicas=2, ledger=ledger,
                             slo_classes=api.DEFAULT_SLO_CLASSES)
    fid = fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                        tenant="acme", priority=1))
    fleet.step()
    rep = [i for i, f in fakes.items() if f.load][0]
    fakes[rep].complete(fleet.requests[fid].live[rep].local_id)
    fleet.step()
    res = fleet.results[fid]
    assert res.tenant == "acme" and res.slo_class == "standard"
    record = [r for r in ledger.records() if r.get("admitted")][0]
    assert record["tenant"] == "acme" and record["slo_class"] == "standard"
    return view(fleet, ledger=ledger)


class _AutoComplete:
    """A closed-loop target that completes every in-flight fake request
    before each tick (JAX's ``AutoComplete``)."""

    def __init__(self, fleet, fakes, peak=None):
        self.fleet, self.fakes, self.peak = fleet, fakes, peak

    busy = property(lambda self: self.fleet.busy)
    open_requests = property(lambda self: self.fleet.open_requests)

    def submit(self, request):
        return self.fleet.submit(request)

    def step(self):
        if self.peak is not None:
            self.peak["open"] = max(self.peak["open"],
                                    self.fleet.open_requests)
        complete_all(self.fakes)
        return self.fleet.step()


def closed_loop_holds_inflight(api):
    fleet, fakes = ctl_fleet(api, num_replicas=2)
    items = api.workload.generate_workload(
        api.workload.WorkloadConfig(seed=1, num_requests=12,
                                    mean_rps=1000.0), 97, 48)
    peak = {"open": 0}
    accepted = api.workload.drive_closed_loop(
        _AutoComplete(fleet, fakes, peak), items,
        lambda item: api.ServeRequest(prompt=list(item.prompt),
                                      max_new_tokens=1, tenant=item.tenant),
        inflight_target=4)
    assert accepted == 12 and peak["open"] <= 4
    assert sorted(fleet.results) == list(range(12))
    assert all(r.status == "completed" for r in fleet.results.values())
    return view(fleet, peak=peak["open"])


def scale_down_bounds_exclude_leaving(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=3,
        autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=3, scale_up_queue_per_replica=50.0,
            scale_down_queue_per_replica=2.0, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=1,
            scale_down_cooldown_ticks=1, scale_down_idle_ticks=1))
    for _ in range(3):
        fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    fleet.step()
    fleet.step()
    assert fleet.counters["scale_downs"] == 1
    victim = next(r for r in fleet.replicas if r.retire_pending)
    for _ in range(12):
        fleet.step()
    assert fleet.counters["scale_downs"] == 1
    assert victim.state is api.ReplicaState.DRAINING
    assert len([r for r in fleet.replicas if not r.retire_pending]) == 2
    return view(fleet)


def stalled_scale_in_fails_over(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=3, heartbeat_miss_limit=3, backoff_base_ticks=0,
        autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=3, scale_up_queue_per_replica=50.0,
            scale_down_queue_per_replica=2.0, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=1,
            scale_down_cooldown_ticks=1, scale_down_idle_ticks=2))
    fids = [fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
            for _ in range(3)]
    victim = next(f for f in fids if 2 in fleet.requests[f].live)
    fleet.step()
    fleet.step()
    assert fleet.replicas[2].retire_pending
    fleet.replicas[2].stalled_until = 10 ** 9
    for _ in range(8):
        fleet.step()
    rec = fleet.requests.get(victim)
    assert rec is None or 2 not in rec.live
    assert fleet.counters["failovers"] >= 1
    assert fleet.replicas[2].state is api.ReplicaState.RETIRED
    for _ in range(6):
        complete_all(fakes)
        fleet.step()
    assert fleet.results[victim].status == "completed"
    assert fleet.results[victim].replica != 2
    return view(fleet)


def closed_loop_drops_refused_head(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=2,
        tenant_quota=api.TenantQuotaConfig(capacity_tokens=4.0,
                                           refill_per_tick=0.0))
    items = api.workload.generate_workload(
        api.workload.WorkloadConfig(seed=2, num_requests=3,
                                    mean_rps=1000.0), 97, 48)

    def make(item):
        if item is items[0]:
            return api.ServeRequest(prompt=[1] * 10, max_new_tokens=2,
                                    tenant="hog")
        return api.ServeRequest(prompt=[1], max_new_tokens=1, tenant="ok")

    accepted = api.workload.drive_closed_loop(
        _AutoComplete(fleet, fakes), items, make, inflight_target=2,
        max_ticks=500, max_refused_ticks=10)
    assert accepted == 2 and fleet.counters["throttles"] >= 10
    assert all(r.status == "completed" for r in fleet.results.values())
    return view(fleet)


def rejected_submission_refunds(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=2, slo_classes=api.DEFAULT_SLO_CLASSES,
        class_queue_limit=2,
        tenant_quota=api.TenantQuotaConfig(capacity_tokens=20.0,
                                           refill_per_tick=0.0))
    fids = [fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1,
                                          tenant="acme"))
            for _ in range(3)]
    assert fids[2] is None and fleet.rejected == 1
    assert fleet.counters["throttles"] == 0
    assert fleet._buckets.level("acme", fleet.tick) == 16.0
    for _ in range(3):
        complete_all(fakes)
        fleet.step()
    assert fleet.submit(api.ServeRequest(prompt=[1] * 15, max_new_tokens=1,
                                         tenant="acme")) is not None
    return view(fleet)


def unserved_death_refunds_once(api):
    inj = api.injector([(1, "REPLICA_CRASH", dict(target=0))])
    fleet, fakes = ctl_fleet(
        api, num_replicas=1, chaos=inj, max_retries=0,
        tenant_quota=api.TenantQuotaConfig(capacity_tokens=20.0,
                                           refill_per_tick=0.0))
    fid = fleet.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                        tenant="acme"))
    assert fleet._buckets.level("acme", fleet.tick) == 16.0
    for _ in range(4):
        fleet.step()
    assert fleet.results[fid].status == "failover_exhausted"
    assert fleet._buckets.level("acme", fleet.tick) == 20.0
    for _ in range(3):
        fleet.step()
    assert fleet._buckets.level("acme", fleet.tick) == 20.0
    fleet2, fakes2 = ctl_fleet(
        api, num_replicas=1,
        tenant_quota=api.TenantQuotaConfig(capacity_tokens=20.0,
                                           refill_per_tick=0.0))
    fid2 = fleet2.submit(api.ServeRequest(prompt=[1, 2], max_new_tokens=2,
                                          tenant="acme"))
    for _ in range(3):
        complete_all(fakes2)
        fleet2.step()
    assert fleet2.results[fid2].status == "completed"
    assert fleet2._buckets.level("acme", fleet2.tick) == 16.0
    return view(fleet), view(fleet2)


class RefusingEngine(FakeEngine):
    refusing = True

    def submit(self, request):
        if self.refusing:
            return None
        return super().submit(request)


def dispatch_failure_requeues_batch(api):
    fleet, fakes = ctl_fleet(api, num_replicas=2,
                             slo_classes=api.DEFAULT_SLO_CLASSES,
                             engine_cls=RefusingEngine)
    fids = [fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
            for _ in range(4)]
    fleet.step()
    assert fleet._classq.depth() == 4
    assert all(not fleet.requests[f].live for f in fids)
    for fake in fakes.values():
        fake.refusing = False
    for _ in range(4):
        complete_all(fakes)
        fleet.step()
    assert all(fleet.results[f].status == "completed" for f in fids)
    return view(fleet)


def no_candidate_scale_down_waits(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=3, restart_ticks=10 ** 6,
        autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=3, scale_up_queue_per_replica=50.0,
            scale_down_queue_per_replica=2.0, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=1,
            scale_down_cooldown_ticks=10 ** 6, scale_down_idle_ticks=2))
    for rep in fleet.replicas:
        rep.state = api.ReplicaState.RESTARTING
        rep.warm_until = 6
    for _ in range(4):
        fleet.step()
    assert fleet.counters["scale_downs"] == 0
    assert fleet.autoscaler.decisions["down"] == 0
    for _ in range(8):
        fleet.step()
    assert fleet.counters["scale_downs"] == 1
    assert fleet.autoscaler.decisions["down"] == 1
    return view(fleet)


def quarantined_do_not_dilute(api):
    fleet, fakes = ctl_fleet(
        api, num_replicas=3, restart_ticks=1,
        autoscale=api.AutoscalerConfig(
            min_replicas=1, max_replicas=3, scale_up_queue_per_replica=5.0,
            scale_down_queue_per_replica=0.4, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=1,
            scale_down_cooldown_ticks=1, scale_down_idle_ticks=10 ** 6))
    for rep in fleet.replicas[1:]:
        rep.state = api.ReplicaState.QUARANTINED
        rep.cooloff_until = 10 ** 6
    for _ in range(6):
        fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
    fleet.step()
    assert fleet.counters["scale_ups"] == 1 and len(fleet.replicas) == 4
    return view(fleet)


def disaggregated_pools_on_fakes(api):
    """Pool roles on the fake fleet: routing prefers the prefill replica,
    the per-pool scalers each read their own pool, and the pool gauge
    counts each role (no engine migrates here: a fake has no
    ``decode_ready_ids``)."""
    reg = api.MetricsRegistry()
    trace = RecordingTrace()
    fleet, fakes = ctl_fleet(
        api, num_replicas=3, registry=reg, trace=trace, restart_ticks=1,
        pool_roles=("prefill", "decode", "decode"),
        autoscale=api.AutoscalerConfig(
            min_replicas=1, max_replicas=3, scale_up_queue_per_replica=3.0,
            scale_down_queue_per_replica=0.4, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=2,
            scale_down_cooldown_ticks=2, scale_down_idle_ticks=2))
    fids = [fleet.submit(api.ServeRequest(prompt=[1], max_new_tokens=1))
            for _ in range(4)]
    assert all(set(fleet.requests[f].live) == {0} for f in fids)
    fleet.step()
    assert fleet.counters["scale_ups"] >= 1
    for _ in range(10):
        complete_all(fakes)
        fleet.step()
    assert all(fleet.results[f].status == "completed" for f in fids)
    return view(fleet, trace,
                pools=(_series(reg, "tddl_fleet_pool_replicas",
                               role="prefill"),
                       _series(reg, "tddl_fleet_pool_replicas",
                               role="decode")))


CASES = [tenant_flood_throttles_itself, autoscaler_cycle,
         scale_down_runs_out, class_breach_sheds_lowest,
         tenant_threads_to_ledger, closed_loop_holds_inflight,
         scale_down_bounds_exclude_leaving, stalled_scale_in_fails_over,
         closed_loop_drops_refused_head, rejected_submission_refunds,
         unserved_death_refunds_once, dispatch_failure_requeues_batch,
         no_candidate_scale_down_waits, quarantined_do_not_dilute,
         disaggregated_pools_on_fakes]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_control_plane_case_matches_jax(case):
    assert case(CtlApi("port")) == case(CtlApi("jax"))


# --------------------------------------------------------------------------
# Real engines at JAX's tiny geometry
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


def real_fleet(api, params, fleet_config, **kwargs):
    jparams, tparams = params
    if api.port:
        return api.ServingFleet(tparams, CFG, fleet_config=fleet_config,
                                device="cpu", **kwargs)
    return api.ServingFleet(jparams, JCFG, fleet_config=fleet_config,
                            **kwargs)


def one_engine_streams(params, reqs):
    """Greedy streams of one port engine, the drills' reference."""
    from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

    eng = ServingEngine(params[1], CFG, max_slots=4, max_seq=48,
                        device="cpu", enable_monitor=False)
    ids = [eng.submit(ServeRequest(prompt=list(p), max_new_tokens=n))
           for p, n in reqs]
    out = eng.run_until_idle()
    return [out[i].tokens for i in ids]


def flood_autoscale_drill(api, params):
    """JAX's acceptance drill (``tests/test_fleet_control.py``): seeded
    diurnal traffic closed-loop at 10 open requests and a TENANT_FLOOD at
    tick 8 against a 2 -> 3 fleet with the whole control plane on."""
    plan = api.FaultPlan.scripted([api.FaultEvent(
        step=8, kind=api.FaultKind.TENANT_FLOOD, severity=12,
        tenant="flood")])
    ledger = api.AttributionLedger(None)
    trace = RecordingTrace()
    classes = (api.SLOClass("batch", priority=0, weight=1.0),
               api.SLOClass("standard", priority=1, weight=2.0,
                            ttft_target_s=60.0, itl_target_s=10.0),
               api.SLOClass("premium", priority=2, weight=4.0,
                            ttft_target_s=60.0, itl_target_s=10.0))
    fleet = real_fleet(api, params, api.FleetConfig(
        num_replicas=2, max_retries=6, restart_ticks=2,
        quarantine_cooloff_ticks=10_000, slo_classes=classes,
        tenant_quota=api.TenantQuotaConfig(
            capacity_tokens=100_000, refill_per_tick=0.0,
            per_tenant={"flood": (40.0, 0.0)}),
        autoscale=api.AutoscalerConfig(
            min_replicas=2, max_replicas=3, scale_up_queue_per_replica=6.0,
            scale_down_queue_per_replica=0.5, scale_up_occupancy=1.1,
            scale_down_occupancy=1.0, scale_up_cooldown_ticks=200,
            scale_down_cooldown_ticks=8, scale_down_idle_ticks=6)),
        chaos=api.FaultInjector(plan), ledger=ledger,
        registry=api.MetricsRegistry(), max_slots=4, max_seq=48,
        queue_limit=32, enable_monitor=False)
    fleet.trace = trace
    items = api.workload.generate_workload(api.workload.WorkloadConfig(
        seed=5, num_requests=20, mean_rps=16.0, burstiness=0.6,
        prompt_median=6, output_median=5, max_output=8), V, 48)
    reqs = {}
    pending = list(items)
    ticks = 0
    while pending or fleet.busy:
        while pending and fleet.open_requests < 10:
            item = pending[0]
            fid = fleet.submit(api.ServeRequest(
                prompt=list(item.prompt), max_new_tokens=item.max_new_tokens,
                temperature=0.0, priority=item.priority,
                tenant=item.tenant))
            if fid is None:
                break
            pending.pop(0)
            reqs[fid] = (list(item.prompt), item.max_new_tokens)
        fleet.step()
        ticks += 1
        assert ticks < 4000
    for _ in range(24):
        fleet.step()
    predicted = plan.predict_fleet(autoscale=True, quota_tokens=40,
                                   flood_request_tokens=8)
    assert {k: fleet.counters[k] for k in predicted} == predicted
    assert (fleet.counters["scale_ups"], fleet.counters["scale_downs"],
            fleet.counters["throttles"]) == (1, 1, 7)
    assert [(e["direction"], e["from_replicas"], e["to_replicas"])
            for e in trace.of("fleet_scale")] == [("up", 2, 3),
                                                   ("down", 3, 2)]
    retired = [r for r in fleet.replicas
               if r.state is api.ReplicaState.RETIRED]
    assert len(retired) == 1 and f"{retired[0].index}:0" in fleet.journals
    results = fleet.results
    flood = sorted(f for f, r in results.items() if r.tenant == "flood")
    assert len(flood) == 5
    assert sorted(results) == sorted(list(reqs) + flood)
    assert all(r.status == "completed" for r in results.values())
    assert sum(1 for r in results.values() if r.replica == 2) >= 1
    per_class = fleet.metrics_summary()["per_class"]
    assert not per_class["standard"]["breached"]
    assert not per_class["premium"]["breached"]
    ok, problems = fleet.verify_attribution()
    assert ok, problems
    streams = {f: (reqs.get(f), r.tokens) for f, r in results.items()}
    return fleet, ledger, trace, streams, flood


def test_flood_autoscale_drill_matches_jax(params):
    jfleet, jledger, jtrace, jstreams, _ = flood_autoscale_drill(
        CtlApi("jax"), params)
    fleet, ledger, trace, streams, flood = flood_autoscale_drill(
        CtlApi("port"), params)
    assert streams == jstreams
    reqs = sorted((f, p) for f, (p, _) in streams.items() if p is not None)
    ref = one_engine_streams(params, [p for _, p in reqs])
    assert [streams[f][1] for f, _ in reqs] == ref
    flood_ref = one_engine_streams(params, [([0] * 4, 4)])[0]
    assert all(streams[f][1] == flood_ref for f in flood)
    assert view(fleet, trace, ledger) == view(jfleet, jtrace, jledger)


def disaggregated_pools(api, params):
    """JAX's ``tests/test_migrate.py`` case: one prefill and two decode
    replicas; every request moves once, at its first decode token."""
    trace = RecordingTrace()
    ledger = api.AttributionLedger(None)
    fleet = real_fleet(api, params, api.FleetConfig(
        num_replicas=3, pool_roles=("prefill", "decode", "decode")),
        ledger=ledger, registry=api.MetricsRegistry(), max_slots=2,
        max_seq=48, queue_limit=32)
    fleet.trace = trace
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(5):
        plen = int(rng.integers(3, 8))
        new = int(rng.integers(6, 10))
        prompt = rng.integers(0, V, plen).tolist()
        reqs.append((prompt, new))
        fleet.submit(api.ServeRequest(prompt=prompt, max_new_tokens=new))
    results = fleet.run_until_idle(max_ticks=2000)
    assert sorted(results) == list(range(5))
    assert all(r.status == "completed" for r in results.values())
    assert fleet.counters["migrations"] == 5
    migs = trace.of("kv_migration")
    assert len(migs) == 5
    assert all(e["reason"] == "disagg" and e["from_replica"] == 0
               for e in migs)
    ok, problems = fleet.verify_attribution()
    assert ok, problems
    return fleet, ledger, trace, reqs


def test_disaggregated_pools_match_jax(params):
    jfleet, jledger, jtrace, _ = disaggregated_pools(CtlApi("jax"), params)
    fleet, ledger, trace, reqs = disaggregated_pools(CtlApi("port"), params)
    assert [fleet.results[f].tokens for f in range(5)] == \
        one_engine_streams(params, reqs)
    assert view(fleet, trace, ledger) == view(jfleet, jtrace, jledger)


def adapter_quota(api, params):
    """JAX's ``tests/test_adapters.py`` case: two tenants share one hot
    adapter; the second trips the adapter's bucket and the tenant's spend
    is refunded."""
    fleet = real_fleet(api, params, api.FleetConfig(
        num_replicas=1,
        tenant_quota=api.TenantQuotaConfig(capacity_tokens=100.0),
        adapter_quota=api.TenantQuotaConfig(capacity_tokens=10.0)),
        registry=api.MetricsRegistry(), max_slots=2, max_seq=48,
        queue_limit=8, paged=True, block_size=8, num_blocks=16,
        adapter_rank=2, adapter_pool_pages=2,
        adapter_map={"t1": "ad-hot", "t2": "ad-hot"})
    ok = fleet.submit(api.ServeRequest(prompt=[1, 2, 3], max_new_tokens=5,
                                       tenant="t1"))
    assert ok is not None
    assert fleet.submit(api.ServeRequest(prompt=[1, 2, 3], max_new_tokens=5,
                                         tenant="t2")) is None
    assert fleet.counters["adapter_throttles"] == 1
    assert fleet.counters["throttles"] == 0
    assert fleet._buckets._b["t2"][0] == 100.0
    assert fleet.submit(api.ServeRequest(prompt=[1, 2, 3], max_new_tokens=5,
                                         tenant="t3")) is not None
    fleet.run_until_idle(max_ticks=200)
    return view(fleet), fleet.registry.get(
        "tddl_fleet_adapter_throttled_total").value(adapter="ad-hot")


def test_adapter_quota_matches_jax(params):
    assert adapter_quota(CtlApi("port"), params) == \
        adapter_quota(CtlApi("jax"), params)


def test_tenant_rides_engine_ledger_and_request_span(params):
    """A standalone engine stamps the tenant into its attribution record
    and the ``serve.request`` span, queue-side sheds included, in both
    packages."""
    import time

    from trustworthy_dl_tpu.obs.spans import SpanTracker as JSpans
    from trustworthy_dl_tpu.serve import ServingEngine as JEngine
    from trustworthy_dl_tpu_torch.obs.spans import SpanTracker
    from trustworthy_dl_tpu_torch.serve import ServingEngine
    from trustworthy_dl_tpu_torch.serve.fleet import ReplicaObs

    seen = []
    for side in SIDES:
        api = CtlApi(side)
        ledger = api.AttributionLedger(None)
        if api.port:
            spans = SpanTracker()
            eng = ServingEngine(params[1], CFG, max_slots=1, max_seq=32,
                                device="cpu", obs=ReplicaObs(
                                    ledger=ledger, spans=spans,
                                    registry=api.MetricsRegistry()))
        else:
            spans = JSpans()
            eng = JEngine(params[0], JCFG, max_slots=1, max_seq=32,
                          ledger=ledger, spans=spans)
        rid = eng.submit(api.ServeRequest(prompt=[1, 2, 3],
                                          max_new_tokens=2, tenant="acme"))
        eng.run_until_idle()
        record = [r for r in ledger.records() if r["request_id"] == rid][0]
        root = [s for s in spans.closed_spans()
                if s.name == "serve.request"][0]
        rid2 = eng.submit(api.ServeRequest(prompt=[1], max_new_tokens=1,
                                           tenant="acme", deadline_s=0.0))
        time.sleep(0.01)
        eng.run_until_idle()
        rec2 = [r for r in ledger.records() if r["request_id"] == rid2][0]
        seen.append((record["tenant"], root.attrs["tenant"],
                     rec2["admitted"], rec2["tenant"]))
    assert seen[0] == seen[1] == ("acme", "acme", False, "acme")
