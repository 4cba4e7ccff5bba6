"""Telemetry through the port's serving engine, against the JAX engine's, on
the CPU in f32 (tiny GPT-2: 2 layers, 32 wide, 4 heads, vocab 293, a size
no other test file uses, so this file's JAX programs are its own).

* With all the attachments (trace, registry, spans, attribution ledger,
  SLO and anomaly watchers, HBM monitor) the port's engine serves
  bit-identical streams to the same engine without them; every trace line
  validates, ``trace_events.json`` holds one ``serve.request`` span per
  request, ``metrics.prom`` counts the tokens emitted and the ledger
  reconciles with the block allocator's journal.
* The trace's ``(type, request_id, status)`` sequence and the attribution
  records (slot, blocks, prefix blocks and publishers, ``token_hash``)
  equal the JAX engine's on the same requests and weights.  (No adapters:
  the port scopes prefix reuse by adapter on purpose.)
* A breached SLO sheds the same queued request in both engines.
* The HBM gate's decisions and the shrunk KV and adapter pools equal
  JAX's, with the live bytes stubbed alike; the shrunk engine serves the
  same streams.
* ``cli serve --obs-dir`` writes the artifact set JAX's writes (the perf
  ledger included) and prints the compile watch's verdict.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.obs import ObsSession as JSession
from trustworthy_dl_tpu.obs import anomaly as janomaly
from trustworthy_dl_tpu.obs import hbm as jhbm
from trustworthy_dl_tpu.obs import slo as jslo
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs import ObsSession
from trustworthy_dl_tpu_torch.obs import anomaly as tanomaly
from trustworthy_dl_tpu_torch.obs import hbm as thbm
from trustworthy_dl_tpu_torch.obs import slo as tslo
from trustworthy_dl_tpu_torch.obs.events import read_jsonl, validate_event
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

pytestmark = pytest.mark.torchport

VOCAB = 293
JCFG = jgpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_layer=2,
                      n_embd=32, n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=2, max_seq=48, block_size=8, prefill_chunk=16)
#: Watchers that see every observation and never fire on a CPU's timing.
CALM_TARGET_S = 1e9


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _traffic():
    """(prompt, new tokens, priority): prompts longer than a chunk, two
    pairs sharing full-block prefixes (prefix-cache resumes), a one-chunk
    prompt, and more requests than rows."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, VOCAB, 16).tolist()
    prompts = [rng.integers(0, VOCAB, 20).tolist(),
               shared + rng.integers(0, VOCAB, 5).tolist(),
               rng.integers(0, VOCAB, 9).tolist(),
               shared + rng.integers(0, VOCAB, 7).tolist(),
               rng.integers(0, VOCAB, 30).tolist(),
               shared + rng.integers(0, VOCAB, 3).tolist()]
    return list(zip(prompts, [8, 6, 10, 7, 5, 6], [1, 0, 2, 0, 1, 3]))


def _calm(slo, anomaly):
    """Watcher pairs of one package whose thresholds no CPU timing
    reaches: attached and fed, never shedding."""
    rules = (slo.SLORule("ttft", "ttft_s", CALM_TARGET_S, budget=0.05,
                         window=128, min_count=16),
             slo.SLORule("itl", "itl_s", CALM_TARGET_S, budget=0.01,
                         window=512, min_count=64))
    signals = {"itl": (0.05, 32, 1e12)}
    return rules, signals


def _session(factory, root, slo, anomaly, **kw):
    s = factory(str(root) if root else None, **kw)
    s.enable_spans()
    s.open_ledger()
    rules, signals = _calm(slo, anomaly)
    s.install_watchers(slo_rules=rules, anomaly_signals=signals)
    s.enable_hbm()
    return s


def _attach(s):
    """The JAX engine's telemetry arguments; the port's engine takes the
    session itself (``obs=``)."""
    return dict(trace=s.trace, registry=s.registry, spans=s.spans,
                ledger=s.ledger, slo=s.slo, anomaly=s.anomaly, hbm=s.hbm)


def _serve(engine, request_cls, traffic=None, **extra):
    for prompt, new, prio in traffic or _traffic():
        assert engine.submit(request_cls(prompt=prompt, max_new_tokens=new,
                                         priority=prio, **extra)) is not None
    return engine.run_until_idle()


def _port(params, **kw):
    return ServingEngine(params[1], CFG, device="cpu", **ENGINE, **kw)


def _jax(params, **kw):
    return JEngine(params[0], JCFG, paged=True, attn_impl="jnp", **ENGINE,
                   **kw)


def test_streams_are_bit_identical_with_every_attachment(params, tmp_path):
    bare = _serve(_port(params), ServeRequest)
    session = _session(ObsSession, tmp_path, tslo, tanomaly)
    engine = _port(params, obs=session)
    watched = _serve(engine, ServeRequest)
    assert sorted(watched) == sorted(bare) == list(range(6))
    for rid, res in watched.items():
        ref = bare[rid]
        assert (res.tokens, res.entropies, res.margins, res.status) == \
            (ref.tokens, ref.entropies, ref.margins, ref.status), rid
    assert engine.verify_attribution() == (True, [])
    summary = engine.metrics_summary()
    assert summary["requests_shed_slo"] == 0 and summary["prefix_hits"] >= 2
    # The summary's percentiles are exact; the watcher's P-square
    # estimates stand apart under "streaming", as JAX's summary gives them.
    itl = np.asarray([dt for r in watched.values() for dt in r.itl_s])
    assert summary["itl_p50_ms"] == float(np.percentile(itl, 50) * 1e3)
    assert summary["itl_samples"] == itl.size
    assert summary["streaming"]["itl_p50_ms"] == \
        session.slo.quantile("itl_s", 0.5) * 1e3
    session.finalize()
    for event in read_jsonl(str(tmp_path / "trace.jsonl")):
        validate_event(event)
    with open(tmp_path / "trace_events.json") as f:
        chrome = json.load(f)["traceEvents"]
    roots = [e for e in chrome if e["name"] == "serve.request"]
    assert sorted(e["tid"] for e in roots) == list(range(6))
    assert {e["name"] for e in chrome} >= {
        "serve.queued", "serve.prefill", "serve.decode", "serve.monitor",
        "serve.prefix_lookup", "serve.prefill_chunk", "serve.decode_tick"}
    emitted = sum(len(r.tokens) for r in watched.values())
    prom = (tmp_path / "metrics.prom").read_text().splitlines()
    assert f"tddl_serve_tokens_total {float(emitted)!r}" in prom
    assert 'tddl_serve_requests_total{status="completed"} 6.0' in prom
    with open(tmp_path / "attribution.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert lines[0]["header"] and len(lines) == 7


def _sequence(events):
    return [(e["type"], e.get("request_id"), e.get("status"), e.get("name"))
            for e in events]


def test_trace_and_attribution_records_equal_jax(params):
    results, records, traces = {}, {}, {}
    for side, make, req, factory, slo, anomaly, attach in (
            ("jax", _jax, JRequest, JSession, jslo, janomaly, _attach),
            ("port", _port, ServeRequest, ObsSession, tslo, tanomaly,
             lambda s: {"obs": s})):
        session = _session(factory, None, slo, anomaly)
        engine = make(params, **attach(session))
        results[side] = {rid: list(r.tokens) for rid, r in
                         _serve(engine, req).items()}
        records[side] = engine.ledger.records()
        traces[side] = _sequence(session.recorder.events())
        assert engine.verify_attribution() == (True, [])
    assert results["port"] == results["jax"]
    assert traces["port"] == traces["jax"]
    keys = ("request_id", "status", "admitted", "slot", "layout",
            "block_ids", "prefix_block_ids", "prefix_publishers", "kv_dtype",
            "weight_dtype", "kv_fallback_reason", "flagged", "tokens",
            "token_hash", "tenant", "adapter", "adapter_page")
    for rec, jrec in zip(records["port"], records["jax"], strict=True):
        assert {k: rec[k] for k in keys} == {k: jrec[k] for k in keys}
    assert any(r["prefix_publishers"] for r in records["port"])


def _hair_trigger(slo):
    """One TTFT rule that breaches at the first retirement and stays
    breached."""
    return (slo.SLORule("ttft", "ttft_s", 0.0, budget=1.0, window=1,
                        min_count=1),)


def test_a_breached_slo_sheds_the_same_request(params):
    statuses = {}
    for side, make, req, factory, slo, attach in (
            ("jax", _jax, JRequest, JSession, jslo, _attach),
            ("port", _port, ServeRequest, ObsSession, tslo,
             lambda s: {"obs": s})):
        session = factory(None)
        session.install_watchers(slo_rules=_hair_trigger(slo))
        engine = make(params, **attach(session))
        results = _serve(engine, req)
        statuses[side] = {rid: (r.status, list(r.tokens))
                          for rid, r in results.items()}
        assert engine.metrics_summary()["requests_shed_slo"] == \
            engine.shed_slo > 0
    assert statuses["port"] == statuses["jax"]
    shed = sorted(rid for rid, (s, _) in statuses["port"].items()
                  if s == "shed_slo")
    # The lowest priority goes first: never the priority-3 request.
    assert shed and 5 not in shed


def test_hbm_gate_shrinks_the_pools_as_jax(params, monkeypatch):
    """Budget 30,000 bytes: the 12-block KV pool (49,152 bytes in f32) is
    cut to 7 blocks; with 28,000 bytes then live, the adapter pool's 3
    pages are cut to its floor, one page."""
    def stub():
        calls = iter([{"dev:0": 0}, {"dev:0": 28_000}])
        return lambda: next(calls)

    built = {}
    for side, make, hbm, factory, attach in (
            ("jax", _jax, jhbm, JSession, _attach),
            ("port", _port, thbm, ObsSession, lambda s: {"obs": s})):
        monkeypatch.setattr(hbm, "live_buffer_bytes", stub())
        session = factory(None)
        monitor = session.enable_hbm(budget_bytes=30_000)
        engine = make(params, adapter_rank=2, adapter_pool_pages=3,
                      **attach(session))
        built[side] = (engine.scheduler.blocks.num_blocks,
                       engine.adapter_pool.pages, monitor.pressure_denials,
                       monitor.last_headroom)
    assert built["port"] == built["jax"] == (7, 1, 2, 2_000)
    monkeypatch.setattr(thbm, "live_buffer_bytes", lambda: {"dev:0": 0})
    session = ObsSession(None)
    session.enable_hbm(budget_bytes=30_000)
    small = _port(params, obs=session)
    assert small.scheduler.blocks.num_blocks == 7
    traffic = _traffic()[:4]
    shrunk = _serve(small, ServeRequest, traffic)
    full = _serve(_port(params), ServeRequest, traffic)
    assert {r: x.tokens for r, x in shrunk.items()} == \
        {r: x.tokens for r, x in full.items()}


SERVE = ["--num-requests", "4", "--max-seq", "32", "--max-new-tokens", "6",
         "--prompt-len", "6", "--block-size", "8", "--temperature", "0"]
TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=307, n_positions=48,
            seq_len=16)
#: What only an episode writes (a slow first compile may trigger one): the
#: verdict store's rows, the flight dumps and their incidents.
DEFERRED = ("VERDICTS.jsonl",)


def _artifacts(root):
    return sorted(n for n in os.listdir(root) if n not in DEFERRED
                  and not n.startswith(("flight_", "incident_")))


def test_cli_serve_obs_dir_writes_the_jax_artifacts(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.delenv("TDDL_PERF_LEDGER", raising=False)
    monkeypatch.delenv("TDDL_VERDICT_STORE", raising=False)
    empty = str(tmp_path / "no_checkpoints")
    assert jcli.serve_main(SERVE + ["--checkpoint-dir", empty, "--obs-dir",
                                    str(tmp_path / "j")],
                           model_overrides=dict(TINY,
                                                dtype=jnp.float32)) == 0
    jout = capsys.readouterr().out
    assert cli.serve_main(SERVE + ["--checkpoint-dir", empty, "--obs-dir",
                                   str(tmp_path / "t"), "--device", "cpu"],
                          model_overrides=dict(TINY,
                                               dtype=torch.float32)) == 0
    out = capsys.readouterr().out
    assert "block-lifecycle reconciliation OK" in jout
    assert "block-lifecycle reconciliation OK" in out
    # What the watchers shed is printed, so telemetry never drops a
    # request unseen.
    assert "  requests_shed_slo: 0\n" in out
    assert "compiles: 0 (0.00s), decode storms: 0\n" in out
    assert "perf sentinel: within the noise band" in out
    assert _artifacts(tmp_path / "t") == _artifacts(tmp_path / "j")
    assert "attribution.jsonl" in _artifacts(tmp_path / "t")
    events = read_jsonl(str(tmp_path / "t" / "trace.jsonl"))
    for event in events:
        validate_event(event)
    assert [e["type"] for e in events].count("serve_retire") == 4
    assert events[-1]["type"] == "run_end"
    assert any(e["type"] == "hbm_sweep" for e in events)
