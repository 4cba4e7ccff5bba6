"""The port's telemetry plane (``trustworthy_dl_tpu_torch/obs``) against the
JAX package's (``trustworthy_dl_tpu/obs``), host-only and fast: the same
operations, made from a numpy seed, through both packages' modules.

* Registry: the same sequence of counter, gauge and histogram updates
  gives equal ``snapshot()`` dicts and a byte-equal ``prometheus_text()``;
  the cardinality bound and the name, label, kind and bucket checks raise
  alike.
* Events: ``EventType`` and ``EVENT_SCHEMAS`` equal JAX's; the same emits
  validate or fail alike; size rotation seals the same segment files,
  read back alike.
* Watchers: ``P2Quantile`` and ``StreamingPercentiles`` equal JAX's
  exactly over the same stream; ``EwmaDetector`` scores and
  ``AnomalyWatcher`` episodes equal; an ``SLOWatcher`` breaches and clears
  at the same observations.
* Step timer, spans, flight recorder and the HBM gate: equal reports,
  Chrome traces, dumps and gate decisions (clocks and live bytes stubbed
  alike).
* Attribution: the allocators' journals and ``verify_attribution``'s
  verdicts equal.
* Sessions: the port's artifacts and event types are JAX's; an in-memory
  session's compile watch, forensics and perf tiers switch on without a
  file.
* Lint: every ``.emit(`` of the port names an ``EventType`` member, and
  every metric the port registers is named ``tddl_*``.
"""

import ast
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import pytest

from trustworthy_dl_tpu.obs import anomaly as janomaly
from trustworthy_dl_tpu.obs import attribution as jattribution
from trustworthy_dl_tpu.obs import events as jevents
from trustworthy_dl_tpu.obs import hbm as jhbm
from trustworthy_dl_tpu.obs import recorder as jrecorder
from trustworthy_dl_tpu.obs import registry as jregistry
from trustworthy_dl_tpu.obs import report as jreport
from trustworthy_dl_tpu.obs import session as jsession
from trustworthy_dl_tpu.obs import slo as jslo
from trustworthy_dl_tpu.obs import spans as jspans
from trustworthy_dl_tpu.serve import kv_slots as jkv
from trustworthy_dl_tpu_torch.obs import anomaly as tanomaly
from trustworthy_dl_tpu_torch.obs import attribution as tattribution
from trustworthy_dl_tpu_torch.obs import events as tevents
from trustworthy_dl_tpu_torch.obs import hbm as thbm
from trustworthy_dl_tpu_torch.obs import recorder as trecorder
from trustworthy_dl_tpu_torch.obs import registry as tregistry
from trustworthy_dl_tpu_torch.obs import report as treport
from trustworthy_dl_tpu_torch.obs import session as tsession
from trustworthy_dl_tpu_torch.obs import slo as tslo
from trustworthy_dl_tpu_torch.obs import spans as tspans
from trustworthy_dl_tpu_torch.serve import kv_slots as tkv

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "trustworthy_dl_tpu_torch"
SIDES = {"jax": dict(registry=jregistry, events=jevents, recorder=jrecorder,
                     report=jreport, spans=jspans, slo=jslo,
                     anomaly=janomaly, attribution=jattribution, hbm=jhbm,
                     session=jsession, kv=jkv),
         "port": dict(registry=tregistry, events=tevents, recorder=trecorder,
                      report=treport, spans=tspans, slo=tslo,
                      anomaly=tanomaly, attribution=tattribution, hbm=thbm,
                      session=tsession, kv=tkv)}
VOLATILE = ("t", "t_mono", "run_metadata", "timestamp", "start_mono")


def _strip(obj):
    """``obj`` without wall-clock and platform keys, recursively."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _canon(obj):
    """``obj`` with NaN floats spelled out, so equal results compare
    equal."""
    if isinstance(obj, float) and math.isnan(obj):
        return "nan"
    if isinstance(obj, dict):
        return {k: _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_canon(v) for v in obj)
    return obj


def _both(fn):
    """``fn(modules)`` on each side; returns {side: result}."""
    return {side: _canon(fn(mods)) for side, mods in SIDES.items()}


def _same(fn):
    out = _both(fn)
    assert out["port"] == out["jax"]
    return out["port"]


class FakeClock:
    """A ``time.perf_counter`` stand-in: 10 ms a call."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        self.now += 0.01
        return self.now


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _registry_ops(mods):
    rng = np.random.default_rng(0)
    reg = mods["registry"].MetricsRegistry(max_series=16)
    c = reg.counter("tddl_test_total", "things", labels=("kind",))
    g = reg.gauge("tddl_test_depth", "a depth")
    h = reg.histogram("tddl_test_seconds", "latency", labels=("op",),
                      buckets=(0.001, 0.01, 0.1, 1.0))
    d = reg.histogram("tddl_test_default_seconds")
    for _ in range(200):
        kind = f"k{int(rng.integers(0, 5))}"
        c.inc(float(rng.integers(0, 4)), kind=kind)
        g.set(float(rng.normal()))
        h.observe(float(rng.lognormal(-4, 2)), op=f"o{int(rng.integers(3))}")
        d.observe(float(rng.exponential(0.3)))
    c.inc(kind='quo"te\\s')
    g.set(float("inf"))
    snap = reg.snapshot()
    back = mods["registry"].MetricsRegistry.from_snapshot(snap)
    assert back.snapshot() == snap
    return snap, reg.prometheus_text(), c.value(kind="k1"), h.value(op="o0")


def test_registry_operations_give_equal_snapshots_and_exposition():
    snap, text, value, hist = _same(_registry_ops)
    assert len(snap["metrics"]) == 4 and "+Inf" in text
    assert value > 0 and hist["count"] > 0


def _registry_error(case):
    def run(mods):
        reg = mods["registry"].MetricsRegistry(max_series=2)
        try:
            if case == "cardinality":
                c = reg.counter("tddl_ids_total", labels=("id",))
                for i in range(3):
                    c.inc(id=i)
            elif case == "name":
                reg.counter("tddl bad name")
            elif case == "label":
                reg.gauge("tddl_ok", labels=("bad-label",))
            elif case == "kind":
                reg.counter("tddl_x_total")
                reg.gauge("tddl_x_total")
            elif case == "labels_drift":
                reg.counter("tddl_x_total", labels=("a",))
                reg.counter("tddl_x_total", labels=("b",))
            elif case == "buckets":
                reg.histogram("tddl_x_seconds", buckets=(1.0,))
                reg.histogram("tddl_x_seconds", buckets=(2.0,))
            elif case == "negative":
                reg.counter("tddl_x_total").inc(-1)
            elif case == "wrong_labels":
                reg.counter("tddl_x_total", labels=("a",)).inc(b=1)
            elif case == "empty_buckets":
                reg.histogram("tddl_x_seconds", buckets=())
        except ValueError as exc:
            return str(exc)
        return None
    return run


@pytest.mark.parametrize("case", ["cardinality", "name", "label", "kind",
                                  "labels_drift", "buckets", "negative",
                                  "wrong_labels", "empty_buckets"])
def test_registry_refuses_alike(case):
    assert _same(_registry_error(case)) is not None


# ---------------------------------------------------------------------------
# Events and the trace bus
# ---------------------------------------------------------------------------


def test_event_types_and_schemas_equal_jax():
    assert [(e.name, e.value) for e in tevents.EventType] == \
        [(e.name, e.value) for e in jevents.EventType]
    assert {k.value: v for k, v in tevents.EVENT_SCHEMAS.items()} == \
        {k.value: v for k, v in jevents.EVENT_SCHEMAS.items()}
    assert tevents.MIN_ROTATE_BYTES == jevents.MIN_ROTATE_BYTES


def _minimal_events():
    """For every type: its minimal valid event, and each variant with one
    required key missing; plus an unknown type."""
    cases = [{"type": "no_such_event"}]
    for etype, schema in jevents.EVENT_SCHEMAS.items():
        event = {"type": etype.value}
        for key in schema["requires"]:
            event[key] = 1
        for key in schema["fields"]:
            event[key] = 0
        cases.append(event)
        for key in schema["requires"] + schema["fields"]:
            cases.append({k: v for k, v in event.items() if k != key})
        for key in schema["requires"]:
            cases.append({**event, key: None})
    return cases


def test_the_same_emits_validate_or_fail_alike():
    def run(mods):
        out = []
        for event in _minimal_events():
            try:
                mods["events"].validate_event(dict(event))
                out.append(None)
            except ValueError as exc:
                out.append(str(exc))
        return out
    verdicts = _same(run)
    assert verdicts.count(None) == len(jevents.EVENT_SCHEMAS)


def test_rotation_seals_the_same_segments(tmp_path, monkeypatch):
    # Fixed clocks: the timestamps' digits count in the segments' bytes.
    monkeypatch.setattr(time, "time", lambda: 1722700000.125)
    monkeypatch.setattr(time, "monotonic", lambda: 8.5)

    def run(mods):
        # Directory names of one length: the rotation event's path
        # counts in the segment's bytes.
        root = tmp_path / ("port" if mods is SIDES["port"] else "jax_")
        root.mkdir()
        path = str(root / "trace.jsonl")
        reg = mods["registry"].MetricsRegistry()
        rec = mods["recorder"].FlightRecorder(64)
        bus = mods["events"].TraceBus(path, recorder=rec, registry=reg,
                                      max_bytes=100)
        EventType = mods["events"].EventType
        for i in range(120):
            bus.emit(EventType.TRAIN_STEP, step=i, loss=0.5 * i,
                     grad_norm=1.0, note="x" * (i % 7))
            if i % 9 == 0:
                bus.emit(EventType.SERVE_SUBMIT, request_id=i,
                         prompt_len=i, max_new_tokens=4)
        bus.close()
        bus.emit(EventType.RUN_END)     # after close: recorder only
        segments = [os.path.basename(p)
                    for p, _ in mods["events"].rotated_segments(path)]
        events = _strip(mods["events"].read_jsonl_rotated(path))
        for event in events:
            if "path" in event:             # the sealed segment's name
                event["path"] = os.path.basename(event["path"])
        return (bus.rotations, segments, events,
                rec.counts(), rec.total_recorded,
                reg.get("tddl_obs_events_total").value(type="trace_rotate"))
    rotations, segments, events, counts, total, rotate_count = _same(run)
    assert rotations >= 2 and segments[0] == "trace.1.jsonl"
    assert [e["seq"] for e in events] == sorted(e["seq"] for e in events)
    assert counts["run_end"] == 1 and rotate_count == rotations


# ---------------------------------------------------------------------------
# Watchers
# ---------------------------------------------------------------------------


def _stream(n=2000, seed=1):
    rng = np.random.default_rng(seed)
    xs = rng.lognormal(-3, 1, n)
    xs[::97] *= 40.0
    xs[5] = float("nan")
    xs[11] = float("inf")
    return [float(x) for x in xs]


def test_p2_quantiles_and_streaming_percentiles_equal_jax():
    def run(mods):
        slo = mods["slo"]
        ests = [slo.P2Quantile(q) for q in (0.1, 0.5, 0.9, 0.99)]
        sp = slo.StreamingPercentiles()
        trail = []
        for i, x in enumerate(_stream()):
            for est in ests:
                est.observe(x)
            sp.observe(x)
            if i % 37 == 0 or i < 8:
                trail.append([est.value for est in ests]
                             + [sp.quantile(0.5), sp.quantile(0.99)])
        return trail, sp.summary(), [e.count for e in ests]
    trail, summary, counts = _same(run)
    assert summary["count"] == counts[0] == 1998
    with pytest.raises(ValueError):
        tslo.P2Quantile(1.0)


def test_ewma_scores_and_anomaly_episodes_equal_jax(tmp_path):
    def run(mods):
        det = mods["anomaly"].EwmaDetector(alpha=0.1, warmup=8,
                                           z_threshold=4.0)
        scores = [det.observe(x) for x in _stream(300, seed=2)]
        dumps = []
        reg = mods["registry"].MetricsRegistry()
        bus = mods["events"].TraceBus(None, registry=reg)
        watcher = mods["anomaly"].AnomalyWatcher(
            registry=reg, trace=bus,
            dump=lambda reason, step=None, extra=None:
            dumps.append((reason, step, extra)))
        onsets = []
        watcher.on_anomaly(lambda sig, info: onsets.append((sig, info)))
        rng = np.random.default_rng(4)
        for step in range(1, 80):
            loss = 2.0 + float(rng.normal(0, 0.01))
            step_time = 0.1 + float(rng.normal(0, 0.002))
            if step in (40, 41):
                step_time += 1.0
            if step == 60:
                loss = float("nan")
            watcher.observe("step_time", step_time, step=step)
            watcher.observe("loss", loss, step=step)
            watcher.observe("custom_signal", float(step % 3), step=step)
        return (scores, onsets, dumps, watcher.status(), watcher.active,
                reg.snapshot())
    scores, onsets, dumps, status, active, snap = _same(run)
    assert [s for s, _ in onsets] == ["step_time", "loss"]
    assert [d[0] for d in dumps] == ["anomaly", "anomaly"]
    assert any(a for a, _ in scores)


def test_slo_watcher_breaches_and_clears_alike():
    def run(mods):
        slo = mods["slo"]
        reg = mods["registry"].MetricsRegistry()
        bus = mods["events"].TraceBus(None, registry=reg)
        dumps, onsets = [], []
        rules = (slo.SLORule("ttft", "ttft_s", target=0.2, budget=0.1,
                             window=20, min_count=5),
                 slo.SLORule("itl", "itl_s", target=0.05, budget=0.05,
                             window=40, min_count=10, burn_threshold=2.0))
        watcher = slo.SLOWatcher(rules, registry=reg, trace=bus,
                                 dump=lambda reason, step=None, extra=None:
                                 dumps.append((reason, step, extra)))
        watcher.on_breach(lambda name, info: onsets.append((name, info)))
        trail = []
        rng = np.random.default_rng(5)
        for i in range(300):
            slow = 100 <= i < 140 or 220 <= i < 230
            watcher.observe("ttft_s", float(rng.uniform(0.3, 0.5) if slow
                                            else rng.uniform(0.0, 0.1)),
                            step=i)
            watcher.observe("itl_s", float(rng.uniform(0.0, 0.05)), step=i)
            trail.append((watcher.breached, tuple(watcher.active),
                          watcher.burn_rate("ttft"), watcher.burn_rate("itl")))
        return (trail, onsets, dumps, watcher.status(),
                watcher.percentiles("ttft_s"), reg.snapshot())
    trail, onsets, dumps, status, pct, snap = _same(run)
    flips = [i for i in range(1, len(trail)) if trail[i][0] != trail[i - 1][0]]
    assert len(flips) >= 2 and onsets and dumps
    rules = tslo.default_serve_rules(1.5, 0.2)
    assert rules == tuple(tslo.SLORule(**{
        f: getattr(r, f) for f in ("name", "signal", "target", "budget",
                                   "window", "min_count", "burn_threshold")})
        for r in jslo.default_serve_rules(1.5, 0.2))


@pytest.mark.parametrize("kwargs", [dict(budget=0.0), dict(window=0),
                                    dict(min_count=10, window=5),
                                    dict(burn_threshold=0.0)])
def test_slo_rule_validation_alike(kwargs):
    def run(mods):
        try:
            mods["slo"].SLORule("r", "x", 1.0, **kwargs)
        except ValueError as exc:
            return str(exc)
        return None
    assert _same(run) is not None


# ---------------------------------------------------------------------------
# Step timer, spans, flight recorder, HBM gate
# ---------------------------------------------------------------------------


def _timed_run(mods, monkeypatch, spans=True):
    monkeypatch.setattr(time, "perf_counter", FakeClock())
    reg = mods["registry"].MetricsRegistry()
    bus = mods["events"].TraceBus(None, registry=reg,
                                  recorder=mods["recorder"].FlightRecorder())
    timer = mods["report"].StepTimeReporter(registry=reg)
    tracker = mods["spans"].SpanTracker(trace=bus) if spans else None
    timer.spans = tracker
    timer.set_model_info(1_000_000, 2048, model_kind="lm")
    timer.discard_step()
    for step in range(1, 7):
        timer.lap("data")
        timer.lap("compute")
        if step % 2:
            timer.lap("detection")
        with timer.phase("checkpoint"):
            pass
        if step == 4:
            timer.discard_step()
            continue
        timer.finish_step(step=step)
    with pytest.raises(ValueError):
        timer.lap("not_a_phase")
    return reg, bus, timer, tracker


def test_step_timer_reports_equal_jax(monkeypatch):
    def run(mods):
        reg, _, timer, _ = _timed_run(mods, monkeypatch, spans=False)
        report = _strip(timer.report())
        return report, timer.phase_fractions(), timer.num_steps, \
            reg.snapshot()
    report, fractions, steps, snap = _same(run)
    assert steps == 5 and set(fractions) == {"data", "compute", "detection",
                                             "checkpoint"}
    assert report["mfu"]["peak_flops_source"] == "cpu-nominal-estimate"
    assert tuple(treport.PHASES) == tuple(jreport.PHASES)


def test_peak_table_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("TDDL_PEAK_FLOPS_PER_CHIP", raising=False)
    peak, source = treport.peak_flops_per_chip("NVIDIA H100 80GB HBM3")
    assert peak == 989e12 and source.startswith("bf16-peak-table:h100")
    assert "data sheet" in source
    for tpu in ("TPU v5 lite", "TPU v4", "TPU v6e"):
        assert treport.peak_flops_per_chip(tpu)[1] == "cpu-nominal-estimate"
    monkeypatch.setenv("TDDL_PEAK_FLOPS_PER_CHIP", "1e12")
    assert treport.peak_flops_per_chip("cpu") == (
        1e12, "env:TDDL_PEAK_FLOPS_PER_CHIP")
    block = treport.mfu_from_throughput(1000, 10.0, device_kind="cpu")
    assert block == jreport.mfu_from_throughput(1000, 10.0,
                                                device_kind="cpu")


def test_spans_and_chrome_traces_equal_jax(monkeypatch):
    def run(mods):
        _, bus, _, tracker = _timed_run(mods, monkeypatch)
        root = tracker.start("serve.request", kind="serve", request_id=3,
                             tenant="t0")
        with tracker.span("serve.decode", kind="serve", parent_id=root,
                          request_id=3):
            pass
        tracker.end(root, status="completed")
        assert tracker.end(root) is None     # a second close is a no-op
        chrome = tracker.export_chrome()
        events = list(bus.recorder.events())
        offline = mods["spans"].chrome_trace_from_events(events)
        return chrome, _strip(offline), tracker.open_count, _strip(events)
    chrome, offline, open_count, events = _same(run)
    assert open_count == 0
    names = [e["name"] for e in chrome["traceEvents"]]
    assert names.count("train.step") == 5 and "serve.request" in names
    assert len(offline["traceEvents"]) == len(chrome["traceEvents"])


def test_flight_recorder_ring_and_dump_equal_jax(tmp_path):
    def run(mods):
        rec = mods["recorder"].FlightRecorder(capacity=5)
        for i in range(12):
            rec.record({"type": "train_step" if i % 3 else "guard_trip",
                        "step": i})
        root = tmp_path / mods["recorder"].__name__.split(".")[0]
        a = rec.dump(str(root), "rollback", step=7, extra={"why": "test"})
        b = rec.dump(str(root), "anomaly")
        with open(a) as f:
            payload = json.load(f)
        return (os.path.basename(a), os.path.basename(b), rec.counts(),
                rec.total_recorded, _strip(payload))
    _, _, counts, total, payload = _same(run)
    assert total == 12 and payload["num_events"] == 5
    with pytest.raises(ValueError):
        trecorder.FlightRecorder(0)


def test_hbm_gate_decisions_equal_jax(monkeypatch):
    live = {"dev:0": 6_000, "dev:1": 9_000}
    monkeypatch.setattr(jhbm, "live_buffer_bytes", lambda: dict(live))
    monkeypatch.setattr(thbm, "live_buffer_bytes", lambda: dict(live))

    def run(mods):
        reg = mods["registry"].MetricsRegistry()
        bus = mods["events"].TraceBus(
            None, recorder=mods["recorder"].FlightRecorder())
        mon = mods["hbm"].HbmMonitor(registry=reg, trace=bus,
                                     budget_bytes=20_000,
                                     reserve_fraction=0.1)
        out = [(mon.admit(n, what="pool"), mon.last_headroom)
               for n in (1_000, 9_000, 50_000)]
        live["dev:1"] = 12_000
        out.append(mon.sweep(step=3, emit=True))
        live["dev:1"] = 9_000
        out.append((mon.headroom_bytes(), mon.watermark_bytes,
                    mon.pressure_denials))
        unknown = mods["hbm"].HbmMonitor(budget_bytes=None)
        unknown.budget_bytes = None
        out.append((unknown.admit(10 ** 15), unknown.headroom_bytes()))
        snap = reg.snapshot()
        for entry in snap["metrics"].values():
            entry.pop("help")   # the port's says "allocated", not "jax"
        return out, snap, _strip(bus.recorder.events())
    out, snap, events = _same(run)
    assert [d for d, _ in out[:3]] == [True, True, False]
    assert [e["type"] for e in events] == ["hbm_pressure", "hbm_sweep"]


def test_hbm_budget_and_live_bytes_without_cuda(monkeypatch):
    monkeypatch.delenv("TDDL_HBM_BUDGET_BYTES", raising=False)
    assert thbm.live_buffer_bytes() == {}
    assert thbm.device_budget_bytes() is None
    monkeypatch.setenv("TDDL_HBM_BUDGET_BYTES", "1.5e9")
    assert thbm.device_budget_bytes() == jhbm.device_budget_bytes() \
        == 1_500_000_000


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------


def _allocator_script(mods):
    alloc = mods["kv"].BlockAllocator(6)
    a = alloc.alloc(3)
    b = alloc.alloc(2)
    alloc.incref(a[0])
    alloc.claim_speculative(b)
    alloc.release_speculative(b)
    for blk in a:
        alloc.release(blk)
    alloc.release(b[0], quarantine=True)
    alloc.unquarantine(b[0])
    c = alloc.alloc(2)
    return alloc, a, b, c


def test_allocator_journal_and_verdicts_equal_jax():
    def run(mods):
        alloc, a, b, c = _allocator_script(mods)
        attr = mods["attribution"]
        good = [{"request_id": 0, "block_ids": a, "prefix_block_ids": a[:1]},
                {"request_id": 1, "block_ids": c},
                {"request_id": 2, "admitted": False, "block_ids": [99]}]
        bad = [{"request_id": 3, "block_ids": [0, 5, 5, 7],
                "prefix_block_ids": [4]},
               {"request_id": 3, "block_ids": [6]},
               {"request_id": 4, "layout": "stripe", "slot": -1}]
        return (list(alloc.journal), alloc.lifetime,
                attr.verify_attribution(good, alloc),
                attr.verify_attribution(bad, alloc),
                attr.verify_attribution(good, {"r0": alloc}),
                attr.token_hash([1, 2, 3]))
    _, _, ok, bad, fleet, digest = _same(run)
    assert ok == (True, []) and not bad[0] and len(bad[1]) >= 5
    assert fleet[0] is False        # no journal key on the records
    assert digest == tattribution.token_hash(np.array([1, 2, 3]))


def test_ledger_file_round_trip_equal_jax(tmp_path):
    def run(mods):
        path = tmp_path / (mods["attribution"].__name__.split(".")[0]
                           + ".jsonl")
        ledger = mods["attribution"].AttributionLedger(str(path), keep=2)
        for i in range(3):
            ledger.append({"request_id": i, "tokens": i, "t": float(i)})
        ledger.close()
        ledger.append({"request_id": 9, "t": 9.0})    # ring only
        header, records = mods["attribution"].read_ledger(str(path))
        return (sorted(header), records, ledger.records(), ledger.total)
    header, records, ring, total = _same(run)
    assert header == ["header", "run_metadata"] and len(records) == 3
    assert [r["request_id"] for r in ring] == [2, 9] and total == 4


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------


def test_session_artifacts_are_jax_less_the_deferred_tiers(tmp_path,
                                                           monkeypatch):
    monkeypatch.delenv("TDDL_PERF_LEDGER", raising=False)

    def run(mods):
        root = tmp_path / mods["session"].__name__.split(".")[0]
        kwargs = {} if mods is SIDES["port"] else dict(cost_analysis=False)
        s = mods["session"].ObsSession(str(root), metrics_snapshot_every=2,
                                       **kwargs)
        s.enable_spans()
        s.install_watchers()
        s.open_ledger()
        s.enable_hbm()
        for step in range(1, 5):
            s.step_timer.lap("data")
            s.step_timer.lap("compute")
            s.step_timer.finish_step(step=step)
            s.on_step(step)
        s.dump_flight("drill", step=4)
        s.finalize()
        s.finalize()                       # idempotent
        types = [e["type"] for e in
                 mods["events"].read_jsonl(str(root / "trace.jsonl"))]
        return sorted(os.listdir(root)), types
    out = _both(run)
    assert set(out["port"][0]) == set(out["jax"][0])
    assert "PERF_LEDGER.jsonl" in out["port"][0]
    assert out["port"][1] == out["jax"][1]
    s = tsession.ObsSession(None)
    assert s.enable_compile_watch() is s.compilewatch
    assert s.enable_forensics() is s.forensics and s.verdicts is None
    assert s.write_perf() is None and s.cost_ledger is None
    assert s.snapshot_metrics() is None and s.dump_flight("manual") is None
    assert s.forensics.incidents == []
    assert s.write_report()["num_steps"] == 0
    s.finalize()


# ---------------------------------------------------------------------------
# Lint: typed emits and tddl_ metric names
# ---------------------------------------------------------------------------


def _port_calls():
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                yield path.relative_to(REPO), node


def test_every_port_emit_names_a_schema_type():
    found = []
    for rel, call in _port_calls():
        func = call.func
        if not (isinstance(func, ast.Attribute) and func.attr == "emit"):
            continue
        first = call.args[0] if call.args else None
        ok = (isinstance(first, ast.Attribute)
              and isinstance(first.value, ast.Name)
              and first.value.id == "EventType"
              and first.attr in tevents.EventType.__members__)
        # TraceBus.emit's own recursion re-emits TRACE_ROTATE by name.
        assert ok, f"{rel}:{call.lineno}: emit without an EventType member"
        found.append(first.attr)
    assert {"TRAIN_STEP", "SERVE_RETIRE", "GUARD_TRIP", "CHAOS_FAULT",
            "CKPT_COMMIT", "ADAPTER_SWAP", "HBM_PRESSURE", "ATTRIBUTION",
            "SPAN", "SLO_BREACH", "ANOMALY"} <= set(found)


def _metric_name(call):
    """The literal name a registration call passes, or None when the call
    registers nothing."""
    func = call.func
    name_arg = None
    if isinstance(func, ast.Attribute) and func.attr in (
            "counter", "gauge", "histogram") and call.args:
        name_arg = call.args[0]
    elif isinstance(func, ast.Name) and func.id == "metric" \
            and len(call.args) >= 2:
        name_arg = call.args[1]     # the engine's degrade-on-conflict wrapper
    if isinstance(name_arg, ast.Constant) and isinstance(name_arg.value,
                                                         str):
        return name_arg.value
    if isinstance(name_arg, ast.JoinedStr):
        head = name_arg.values[0]
        return head.value if isinstance(head, ast.Constant) else ""
    return None


def test_every_port_metric_is_named_tddl():
    names = []
    for rel, call in _port_calls():
        name = _metric_name(call)
        if name is not None:
            assert name.startswith("tddl_"), f"{rel}:{call.lineno}: {name}"
            names.append(name)
    assert {"tddl_serve_tokens_total", "tddl_supervisor_actions_total",
            "tddl_hbm_pressure_total", "tddl_slo_burn_rate",
            "tddl_anomaly_active", "tddl_obs_events_total"} <= set(names)
    assert math.isfinite(len(names))


def test_obs_ab_session_ladder_adds_one_attachment_an_arm(tmp_path):
    from trustworthy_dl_tpu_torch.utils import obs_ab

    attached = []
    for arm in obs_ab.SERVE_LADDER[1:]:
        session = obs_ab.serve_session(str(tmp_path / arm), arm)
        attached.append([key for key in ("spans", "ledger", "slo", "anomaly",
                                         "hbm")
                         if getattr(session, key) is not None])
        session.finalize()
    assert attached == [[], ["spans"], ["spans", "ledger"],
                        ["spans", "ledger", "slo", "anomaly"],
                        ["spans", "ledger", "slo", "anomaly", "hbm"]]
    assert obs_ab.SERVE_LADDER[-1] == "on"
    assert obs_ab.SERVE_ARMS == obs_ab.SERVE_LADDER + ("on_memory",)
    in_memory = obs_ab.serve_session(None)
    assert in_memory.obs_dir is None and in_memory.hbm is not None
    in_memory.finalize()


def test_obs_ab_profile_summary_and_gc_clock():
    import cProfile
    import gc

    from trustworthy_dl_tpu_torch.utils import obs_ab

    profiler = cProfile.Profile()
    with obs_ab._GcClock() as clock:
        profiler.enable()
        gauge = tregistry.MetricsRegistry().gauge("tddl_ab_test")
        for i in range(200):
            gauge.set(float(i))
        gc.collect()
        profiler.disable()
    summary = obs_ab.profile_summary(profiler, top=3)
    by_module = summary["by_module_s"]
    assert {"obs/registry.py", "builtin"} <= set(by_module)
    assert summary["seconds"] == pytest.approx(sum(by_module.values()))
    assert len(summary["top"]) == 3
    assert all(row["own_ms"] <= row["cum_ms"] + 1e-9
               for row in summary["top"])
    assert clock.seconds > 0.0
    assert all(getattr(cb, "__self__", None) is not clock
               for cb in gc.callbacks)
