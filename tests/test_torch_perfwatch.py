"""The port's performance tier (``obs/compilewatch.py``, the cost ledger of
``obs/hbm.py``, ``obs/report.py``'s analyzed MFU, ``obs/sentinel.py`` and
the ``obs`` command) against the JAX package's, on the CPU (tiny GPT-2:
2 layers, 32 wide, 4 heads; vocab 313 for serving and 331 for training,
sizes no other test file uses).

* Compile watch: the registry and the watcher of both packages, fed the
  same sequence of (stage, seconds) events through their hooks (the
  port's ``ops.note_compile``; JAX's ``jax.monitoring`` dispatcher), give
  equal summaries, status, storm totals, dumps, ``(type, scope)`` event
  order and Prometheus text (stage names and help strings mapped).  A CPU
  serve run under the watch shows zero storms and streams bit-identical
  to a run without it; a ``library_load`` forced through the hook inside
  a guarded decode after warmup is one storm episode with one flight
  dump and its paired incident.
* FLOPs: each kernel's shape count equals ``FlopCounterMode``'s count of
  its plain twin, exactly; the f32-out product (``aten::mm.dtype``) is
  counted; ``analyze_programs``' decode and prefill counts equal the
  counted programs, exactly; the tiny train step's count equals a closed
  form written here (JAX's XLA count is printed beside it, the ratio not
  gated), and a counted run's trajectory is bit-identical to an
  uncounted one.
* Sentinel: fingerprints, ledger trim, verdicts and their events,
  ``load_perf_artifact`` and ``render_diff`` equal JAX's; a session's
  ``finalize`` appends to the resolved ledger and two sessions band.
* The ``obs`` command prints what JAX's prints over one directory (the
  program name aside), in a process that never imports torch.
"""

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu.core.config import TrainingConfig as JConfig
from trustworthy_dl_tpu.data import get_dataloader as jloader
from trustworthy_dl_tpu.engine import trainer as jtrainer
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.obs import compilewatch as jcw
from trustworthy_dl_tpu.obs import hbm as jhbm
from trustworthy_dl_tpu.obs import registry as jregistry
from trustworthy_dl_tpu.obs import sentinel as jsentinel
from trustworthy_dl_tpu_torch import cli, ops
from trustworthy_dl_tpu_torch.core.config import TrainingConfig
from trustworthy_dl_tpu_torch.data import get_dataloader
from trustworthy_dl_tpu_torch.detect import stats as st
from trustworthy_dl_tpu_torch.engine.trainer import DistributedTrainer
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.obs import ObsSession
from trustworthy_dl_tpu_torch.obs import compilewatch as tcw
from trustworthy_dl_tpu_torch.obs import hbm as thbm
from trustworthy_dl_tpu_torch.obs import registry as tregistry
from trustworthy_dl_tpu_torch.obs import sentinel as tsentinel
from trustworthy_dl_tpu_torch.ops import flash_attention as fa
from trustworthy_dl_tpu_torch.ops import fused_ce
from trustworthy_dl_tpu_torch.ops import fused_dequant_matmul as fdm
from trustworthy_dl_tpu_torch.ops import fused_stats as fs
from trustworthy_dl_tpu_torch.ops import paged_attention as pattn
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine
from trustworthy_dl_tpu_torch.serve import scheduler as tscheduler
from trustworthy_dl_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parents[1]
VOCAB = 313
CFG = gpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_layer=2,
                      n_embd=32, n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=2, max_seq=48, block_size=8, prefill_chunk=16,
              device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


class RecordingTrace:
    def __init__(self):
        self.events = []

    def emit(self, type, **data):
        self.events.append({"type": getattr(type, "value", type), **data})


# ---------------------------------------------------------------------------
# Compile registry and watcher against JAX's
# ---------------------------------------------------------------------------

#: The port's stages and the jax.monitoring events standing for them: a
#: library load is the counted compile (JAX's backend compile), an nvcc
#: build a recorded stage that is not counted (JAX's lowering).
STAGE_EVENTS = {"library_load": jcw.BACKEND_COMPILE_EVENT,
                "nvcc_build": "/jax/core/compile/jaxpr_to_mlir_module"
                              "_duration"}
STAGE_NAMES = {"library_load": "backend_compile",
               "nvcc_build": "jaxpr_to_mlir_module"}

#: (guard scope or None, [(stage, seconds)], reset scope before) per call.
COMPILE_SCRIPT = [
    ("serve_decode", [("nvcc_build", 12.5), ("library_load", 0.25)], None),
    ("serve_decode", [], None),
    ("serve_decode", [("library_load", 0.125)], None),          # storm
    ("serve_decode", [("library_load", 0.5),
                      ("library_load", 0.0625)], None),         # same ep.
    (None, [("library_load", 0.75)], None),                    # unguarded
    ("serve_decode", [], None),                                # closes
    ("serve_decode", [("nvcc_build", 3.0), ("library_load", 0.25)], None),
    ("train_step", [("library_load", 1.5)], None),              # warmup
    ("train_step", [("library_load", 0.25)], "train_step"),     # reset
    ("train_step", [("library_load", 0.375)], None),            # storm
]


def _drive_compiles(side, tmp_path):
    trace = RecordingTrace()
    registry = (tregistry if side == "port" else jregistry).MetricsRegistry()
    dumps = []
    mod = tcw if side == "port" else jcw
    compiles = mod.CompileRegistry(trace=trace, registry=registry).install()
    watcher = mod.CompileWatcher(
        compiles, trace=trace, registry=registry,
        dump=lambda reason, step=None, extra=None: dumps.append(
            (reason, step, extra)))

    def fire(stage, seconds):
        if side == "port":
            ops.note_compile(stage, "paged_attention", seconds)
        else:
            jcw._dispatch_duration(STAGE_EVENTS[stage], seconds)

    try:
        for step, (scope, events, reset) in enumerate(COMPILE_SCRIPT):
            if reset is not None:
                watcher.reset(reset)
            with mod.guarded(watcher if scope else None, scope or "-",
                             step=step):
                for stage, seconds in events:
                    fire(stage, seconds)
    finally:
        compiles.uninstall()
    fire("library_load", 9.0)          # after uninstall: not recorded
    summary = compiles.summary()
    if side == "port":
        summary["by_stage"] = {STAGE_NAMES[k]: v for k, v in
                               summary["by_stage"].items()}
    text = registry.prometheus_text()
    for stage, name in STAGE_NAMES.items():
        text = text.replace(f'stage="{stage}"', f'stage="{name}"')
    text = "\n".join(line for line in text.splitlines()
                     if not line.startswith("# HELP"))
    events = [(e["type"], e.get("scope"), e.get("compiles"))
              for e in trace.events]
    return (summary, watcher.status(), watcher.storm_total, dumps, events,
            text)


def test_compile_registry_and_watcher_match_jax(tmp_path):
    port = _drive_compiles("port", tmp_path)
    jax_ = _drive_compiles("jax", tmp_path)
    assert port == jax_
    summary, status, storms, dumps, events, text = port
    assert summary["total"] == 9 and storms == 5
    assert status["serve_decode"] == {"calls": 6, "storms": 4,
                                      "warm": True}
    assert [d[0] for d in dumps] == ["compile_storm"] * 3
    assert [e for e in events if e[0] == "compile_storm"] == [
        ("compile_storm", "serve_decode", 1),
        ("compile_storm", "serve_decode", 2),
        ("compile_storm", "serve_decode", 1),
        ("compile_storm", "train_step", 1)]
    assert 'tddl_compile_storms_total{scope="serve_decode"} 4' in text


def test_watcher_rejects_zero_warmup_and_guarded_none_is_shared():
    reg = tcw.CompileRegistry()
    with pytest.raises(ValueError):
        tcw.CompileWatcher(reg, warmup_calls=0)
    assert tcw.guarded(None, "x") is tcw.guarded(None, "y")


# ---------------------------------------------------------------------------
# Compile watch on a CPU serve run
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jcfg = jgpt2.GPT2Config(vocab_size=VOCAB, n_positions=64, n_layer=2,
                            n_embd=32, n_head=4, dtype=jnp.float32)
    jparams = jgpt2.init_params(jax.random.PRNGKey(1), jcfg)
    return convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))


def _traffic(n=5, seed=4, lo=18, hi=30):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, int(rng.integers(lo, hi))).tolist(),
             int(rng.integers(4, 9))) for _ in range(n)]


def _serve(engine, traffic):
    for prompt, new in traffic:
        assert engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new,
                                          temperature=0.0)) is not None
    return {rid: r.tokens for rid, r in engine.run_until_idle().items()}


@pytest.mark.parametrize("spec_k", [0, 2], ids=["decode", "spec"])
def test_clean_cpu_serve_under_the_watch_has_no_storm(params, spec_k):
    traffic = _traffic()
    bare = _serve(ServingEngine(params, CFG, spec_k=spec_k, **ENGINE),
                  traffic)
    s = ObsSession(None)
    watcher = s.enable_compile_watch()
    engine = ServingEngine(params, CFG, spec_k=spec_k, obs=s, **ENGINE)
    assert engine.compilewatch is watcher
    assert _serve(engine, traffic) == bare
    assert watcher.storm_total == 0 and s.compiles.total == 0
    scopes = ({"serve_spec_draft", "serve_spec_verify"} if spec_k
              else {"serve_decode"})
    assert scopes <= set(watcher.status())
    assert all(v["calls"] > 1 for k, v in watcher.status().items()
               if k in scopes)
    s.finalize()
    assert tcw._ACTIVE == set()


def test_forced_library_load_is_one_storm_episode(params, tmp_path,
                                                  monkeypatch):
    """A library load forced through the ops hook inside the third
    guarded decode: warm by then, so one storm, one episode, one flight
    dump and its paired incident; the streams are unchanged."""
    traffic = _traffic(n=3, seed=5)
    bare = _serve(ServingEngine(params, CFG, **ENGINE), traffic)
    calls = []
    real = tscheduler._paged_decode_impl

    def decode(*args, **kwargs):
        calls.append(1)
        if len(calls) == 3:
            ops.note_compile("library_load", "paged_attention", 0.25)
        return real(*args, **kwargs)

    monkeypatch.setattr(tscheduler, "_paged_decode_impl", decode)
    s = ObsSession(str(tmp_path), perf_ledger=str(tmp_path / "P.jsonl"))
    s.enable_forensics()
    watcher = s.enable_compile_watch()
    engine = ServingEngine(params, CFG, obs=s, **ENGINE)
    assert _serve(engine, traffic) == bare
    assert len(calls) > 4
    assert watcher.storm_total == 1
    assert watcher.status()["serve_decode"]["storms"] == 1
    assert s.registry.get("tddl_compile_storms_total").value(
        scope="serve_decode") == 1
    s.finalize()
    names = sorted(os.listdir(tmp_path))
    assert [n for n in names if n.startswith("flight_")] == \
        ["flight_001_compile_storm.json"]
    assert [n for n in names if n.startswith("incident_")] == \
        ["incident_001_compile_storm.json"]
    with open(tmp_path / "incident_001_compile_storm.json") as f:
        incident = json.load(f)
    assert incident["trigger"]["type"] == "compile_storm"
    assert incident["trigger"]["scope"] == "serve_decode"
    assert incident["extra"] == {"scope": "serve_decode", "compiles": 1}
    assert incident["flight_dump"].endswith("flight_001_compile_storm.json")
    fp = tsentinel.PerfLedger(str(tmp_path / "P.jsonl")).last()
    assert fp["compile_total"] == 1.0 and fp["compile_seconds"] == 0.25


def test_engine_libraries_by_configuration():
    from trustworthy_dl_tpu_torch.serve.engine import engine_libraries

    assert engine_libraries("kernel", "model", 0, 0) == ["paged_attention"]
    assert engine_libraries("kernel", "int8", 0, 4) == [
        "paged_attention", "adapter_delta", "fused_dequant_matmul"]
    assert engine_libraries("kernel", "model", 2, 0) == [
        "paged_attention", "fused_dequant_matmul"]
    assert engine_libraries("plain", "int8", 0, 4) == [
        "fused_dequant_matmul"]


# ---------------------------------------------------------------------------
# Kernel FLOP functions against FlopCounterMode over the plain twins
# ---------------------------------------------------------------------------


def _counted(fn, *args):
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return counter.get_total_flops()


def _pool_case(quantized, t, g):
    r, h, dh, nb, bsz, nbps = 3, 2, 16, 9, 8, 4
    q = torch.randn(r, h, t, dh, generator=g)
    if quantized:
        pk = torch.randint(-127, 128, (nb, h, bsz, dh), generator=g,
                           dtype=torch.int8)
        pv = torch.randint(-127, 128, (nb, h, bsz, dh), generator=g,
                           dtype=torch.int8)
        scales = (torch.rand(nb, h, bsz, generator=g),
                  torch.rand(nb, h, bsz, generator=g))
    else:
        pk = torch.randn(nb, h, bsz, dh, generator=g)
        pv = torch.randn(nb, h, bsz, dh, generator=g)
        scales = ()
    table = torch.randint(0, nb, (r, nbps), generator=g, dtype=torch.int32)
    start = torch.tensor([0, 5, 11], dtype=torch.int32)
    args = (q, pk, pv, table, start, *scales)
    return args, pattn.paged_attention_flops(r, h, t, dh, nbps * bsz)


def _flop_case(name, g):
    """(plain twin, its arguments, the kernel's shape count)."""
    if name == "fused_moments":
        segs = [torch.randn(n, generator=g) for n in (7, 300, 33)]
        return fs.fused_moments_plain, (segs,), fs.fused_moments_flops(
            [7, 300, 33])
    if name.startswith("flash"):
        bh, t, d = 3, 64, 16
        q, k, v, do = (torch.randn(bh, t, d, generator=g) for _ in range(4))
        lse = torch.randn(bh, t, generator=g)
        delta = torch.randn(bh, t, generator=g)
        if name == "flash_fwd":
            return fa.flash_fwd_plain, (q, k, v), fa.flash_fwd_flops(bh, t, d)
        if name == "flash_bwd_dq":
            return (fa.flash_bwd_dq_plain, (q, k, v, do, lse, delta),
                    fa.flash_bwd_dq_flops(bh, t, d))
        return (fa.flash_bwd_dkv_plain, (q, k, v, do, lse, delta),
                fa.flash_bwd_dkv_flops(bh, t, d))
    if name == "dequant_matmul":
        x = torch.randn(5, 48, generator=g)
        w = torch.randint(-127, 128, (48, 32), generator=g,
                          dtype=torch.int8)
        return (fdm.dequant_matmul_plain, (x, w, torch.rand(32, generator=g)),
                fdm.dequant_matmul_flops(5, 48, 32))
    if name in ("paged_decode", "paged_decode_int8", "paged_prefill",
                "paged_prefill_int8"):
        args, flops = _pool_case(name.endswith("int8"),
                                 1 if "decode" in name else 16, g)
        twin = (pattn.paged_attention_plain if "decode" in name
                else pattn.paged_prefill_attention_plain)
        return twin, args, flops
    if name == "logit_trust_stats":
        return (pattn.logit_trust_stats_plain,
                (torch.randn(4, 300, generator=g),),
                pattn.logit_trust_stats_flops(4, 300))
    if name == "fused_verify_tail":
        return (pattn.fused_verify_tail_plain,
                (torch.randn(6, 32, generator=g),
                 torch.randn(300, 32, generator=g)),
                pattn.fused_verify_tail_flops(6, 32, 300))
    rows, t, d, rank, pages = 3, 5, 32, 4, 4
    x = torch.randn(rows, t, d, generator=g)
    page_ids = torch.tensor([0, 3, 1], dtype=torch.int32)
    if name == "adapter_delta_int8":
        a = torch.randint(-127, 128, (pages, d, rank), generator=g,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (pages, rank, d), generator=g,
                          dtype=torch.int8)
        scales = (torch.rand(pages, generator=g),
                  torch.rand(pages, generator=g))
    else:
        a = torch.randn(pages, d, rank, generator=g)
        b = torch.randn(pages, rank, d, generator=g)
        scales = ()
    return (pattn.adapter_delta_plain, (x, a, b, page_ids, *scales),
            pattn.adapter_delta_flops(rows, t, d, rank))


@pytest.mark.parametrize("name", [
    "fused_moments", "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
    "dequant_matmul", "paged_decode", "paged_decode_int8", "paged_prefill",
    "paged_prefill_int8", "logit_trust_stats", "fused_verify_tail",
    "adapter_delta", "adapter_delta_int8"])
def test_kernel_flop_function_equals_the_counted_plain_twin(name):
    twin, args, flops = _flop_case(name, torch.Generator().manual_seed(0))
    assert _counted(twin, *args) == flops
    assert (flops == 0) == (name in ("fused_moments", "logit_trust_stats"))


def test_count_flops_tallies_launches_and_counts_the_f32_out_product():
    a = torch.empty(6, 16, dtype=torch.bfloat16, device="meta")
    b = torch.empty(16, 8, dtype=torch.bfloat16, device="meta")
    with thbm.count_flops() as cost:
        torch.mm(a, b, out_dtype=torch.float32)
        ops.tally_flops("flash_attention_fwd", 1000)
        ops.tally_flops("flash_attention_fwd", 24)
    assert cost == {"flops": float(2 * 6 * 16 * 8 + 1024),
                    "library_flops": 2 * 6 * 16 * 8,
                    "kernel_flops": {"flash_attention_fwd": 1024},
                    "flops_source": thbm.FLOPS_SOURCE,
                    "bytes_accessed": None}
    ops.tally_flops("flash_attention_fwd", 5)     # no tally open: dropped


# ---------------------------------------------------------------------------
# analyze_programs against the counted programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("knobs", [
    {}, dict(weight_dtype="int8", kv_dtype="int8", kv_parity_check=False),
    dict(adapter_rank=4, adapter_pool_pages=2,
         adapter_map={"ta": "ad-a", "tb": "ad-b"})],
    ids=["model", "int8", "adapters"])
def test_analyze_programs_equal_the_counted_programs(params, monkeypatch,
                                                     knobs):
    """The paged engine's programs under JAX's names: the decode step, a
    prompt's final chunk and the dense local prefill (the last request's
    prompt fits one chunk and has no adapter), each equal to
    ``count_flops`` over one run."""
    counted = {"decode": [], "chunk": [], "prefill": []}
    real_decode = tscheduler._paged_decode_impl
    real_chunk = tscheduler._paged_chunk_impl
    real_prefill = tscheduler._paged_prefill_impl

    def decode(*args, **kwargs):
        with thbm.count_flops() as cost:
            out = real_decode(*args, **kwargs)
        counted["decode"].append(cost)
        return out

    def chunk(*args, **kwargs):
        with thbm.count_flops() as cost:
            out = real_chunk(*args, **kwargs)
        if out is not None:             # a prompt's final chunk
            counted["chunk"].append(cost)
        return out

    def prefill(*args, **kwargs):
        with thbm.count_flops() as cost:
            out = real_prefill(*args, **kwargs)
        counted["prefill"].append(cost)
        return out

    monkeypatch.setattr(tscheduler, "_paged_decode_impl", decode)
    monkeypatch.setattr(tscheduler, "_paged_chunk_impl", chunk)
    monkeypatch.setattr(tscheduler, "_paged_prefill_impl", prefill)
    engine = ServingEngine(params, CFG, **ENGINE, **knobs)
    for i, (prompt, new) in enumerate(_traffic(n=4, seed=6)):
        engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new,
                                   temperature=0.0,
                                   tenant="ta" if i % 2 else "tb"))
    short = np.random.default_rng(7).integers(0, VOCAB, 10).tolist()
    engine.submit(ServeRequest(prompt=short, max_new_tokens=3,
                               temperature=0.0))
    engine.run_until_idle()
    ledger = engine.analyze_programs(thbm.CostLedger())
    assert set(ledger.programs) == {"serve.paged_decode",
                                    "serve.paged_chunk",
                                    "serve.paged_prefill"}
    assert counted["decode"] and counted["chunk"] and counted["prefill"]
    for program, runs in counted.items():
        entry = ledger.programs[f"serve.paged_{program}"]
        assert {c["flops"] for c in runs} == {entry["flops"]}, program
        assert entry["flops_source"] == thbm.FLOPS_SOURCE
        assert entry["bytes_accessed"] is None
    decode = ledger.programs["serve.paged_decode"]
    assert decode["rows"] == 2 and decode["positions"] == 1
    assert decode["keys"] == 48
    kernels = set(decode["kernel_flops"])
    assert kernels == ({"paged_attention_int8", "dequant_matmul"}
                       if knobs.get("weight_dtype") else
                       {"paged_attention", "adapter_delta"}
                       if knobs.get("adapter_rank") else
                       {"paged_attention"})


# ---------------------------------------------------------------------------
# The counted train step
# ---------------------------------------------------------------------------

TINY_TRAIN = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=331,
                  n_positions=32, seq_len=16)
TRAIN = dict(model_name="gpt2", batch_size=8, num_nodes=4,
             learning_rate=3e-3, detector_warmup=4, async_host_depth=0,
             prefetch_depth=0)


def _closed_form_step_flops(param_sizes):
    """Products of one trusted step of the tiny GPT-2 (4 nodes x 2
    sequences of 16 tokens, full attention), written out:

    * forward: per token and layer the four block matrices, 2 D (3D + D +
      4D + 4D); per sequence and layer QK^T and PV, 4 H T^2 Dh; the tied
      head, 2 D Vp a token, Vp the vocab zero-padded for the head
      (``fused_ce.pad_vocab``).  The backward is twice the forward (each
      product's two input gradients);
    * per node, the detector's mean-logit row, 2 D Vp;
    * per node, the gradient battery's chunked cosine: 4 chunks of the
      strided gradient sample, a [4, S/4] x [S/4, 4] product;
    * the output features' pairwise cosine, [n, V] x [V, n];
    * the trust-weighted aggregation, a [1, n] x [n, P] product a leaf.
    """
    d, h, layers, v, t = 32, 4, 2, 331, 16
    vp = fused_ce.pad_vocab(torch.zeros(v, 1), torch.float32).shape[0]
    nodes, seqs = 4, 8
    tokens = seqs * t
    forward = (tokens * layers * 2 * d * (3 * d + d + 4 * d + 4 * d)
               + seqs * layers * 4 * h * t * t * (d // h)
               + tokens * 2 * d * vp)
    sample = st.strided_sample_of_leaves(
        [torch.zeros(n) for n in param_sizes], 16384).numel()
    chunk = sample // 4
    return (3 * forward + nodes * 2 * d * vp + nodes * 2 * 4 * chunk * 4
            + 2 * nodes * v * nodes + 2 * nodes * sum(param_sizes))


def _port_trainer():
    tr = DistributedTrainer(TrainingConfig(**TRAIN), model_overrides=dict(
        TINY_TRAIN, dtype=torch.float32), device="cpu")
    tr.initialize()
    return tr


def _loader():
    return get_dataloader("openwebtext", batch_size=8, seq_len=16,
                          vocab_size=331, num_examples=32)


def test_train_step_count_equals_the_closed_form(tmp_path, monkeypatch):
    monkeypatch.delenv("TDDL_PERF_LEDGER", raising=False)
    bare = _port_trainer()
    bare.train(_loader(), num_epochs=1)
    tr = _port_trainer()
    s = ObsSession(str(tmp_path))
    s.enable_compile_watch()
    tr.attach_obs(s)
    tr.train(_loader(), num_epochs=1)
    # Counting reads shapes only: the same trajectory, bit for bit.
    assert [r["loss"] for r in tr.batch_history] == \
        [r["loss"] for r in bare.batch_history]
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tr.state.params),
                   tree_leaves(bare.state.params)))
    s.finalize()
    sizes = [p.numel() for p in tree_leaves(tr.state.params)]
    entry = s.cost_ledger.programs["train_step"]
    assert entry["flops"] == float(_closed_form_step_flops(sizes))
    assert entry["kernel_flops"] == {}      # CPU: the twins, counted
    assert s.compilewatch.status()["train_step"]["calls"] == 4
    with open(tmp_path / "obs_report.json") as f:
        report = json.load(f)
    analyzed = report["mfu_analyzed"]
    assert analyzed["flops_per_step"] == entry["flops"]
    assert analyzed["flops_source"] == thbm.FLOPS_SOURCE
    # The counted step's wall stands apart; the rate is over the others.
    n = report["num_steps"]
    assert analyzed["counted_step_s"] > 0.0
    assert analyzed["step_time_s"] == pytest.approx(
        (report["step_time_s"]["mean"] * n - analyzed["counted_step_s"])
        / (n - 1), rel=1e-12)
    assert analyzed["mfu"] == pytest.approx(
        entry["flops"] / analyzed["step_time_s"]
        / analyzed["peak_flops_per_chip"], rel=1e-12)
    assert report["cost_ledger"]["train_step"] == entry
    assert (tmp_path / "PERF_LEDGER.jsonl").exists()

    # JAX's count of the same step: XLA's cost analysis of the lowered
    # program (products and elementwise work).  Recorded, not gated.
    jtr = jtrainer.DistributedTrainer(
        JConfig(**TRAIN), model_overrides=dict(TINY_TRAIN,
                                               dtype=jnp.float32))
    jtr.initialize()
    batch = next(iter(jloader("openwebtext", batch_size=8, seq_len=16,
                              vocab_size=331, num_examples=32)))
    cost = jhbm.analyze_program(jtr._train_step, jtr.state,
                                jtr._node_batch(batch), jtr.attack_plan,
                                memory=False)
    ratio = cost["flops"] / entry["flops"]
    print(f"train_step FLOPs: port {entry['flops']:.0f}, JAX XLA "
          f"{cost['flops']:.0f}, ratio {ratio:.4f}")
    assert ratio > 0


# ---------------------------------------------------------------------------
# Sentinel, ledger and diff against JAX's
# ---------------------------------------------------------------------------


def _fp(mod, tokens, **extra):
    return mod.fingerprint("bench", metric="tokens_per_s",
                           tokens_per_s=tokens, step_time_s=1.0 / tokens,
                           phase_fractions={"compute": 0.61234567,
                                            "data": 0.2},
                           compile_total=2, run_metadata={
                               "platform": "cpu", "device_kind": "cpu",
                               "num_devices": 1}, **extra)


def _strip(row):
    return {k: v for k, v in row.items() if k not in ("t", "run_metadata")}


def _sentinel_run(mod, regmod, root):
    ledger = mod.PerfLedger(str(root / "PERF_LEDGER.jsonl"), keep=6)
    for tokens in (100.0, 101.0, 99.0, 100.5, 100.2, 99.8, 100.1, 99.9):
        ledger.append(_fp(mod, tokens))
    with open(ledger.path, "a") as f:
        f.write("{torn line\n")
    trace = RecordingTrace()
    registry = regmod.MetricsRegistry()
    sentinel = mod.PerfSentinel(ledger, trace=trace, registry=registry)
    verdicts = [sentinel.check(_fp(mod, t, accepted_rate=a))
                for t, a in ((100.0, None), (80.0, None), (130.0, 0.9))]
    return ([_strip(r) for r in ledger.read()], verdicts,
            [_strip(e) for e in trace.events],
            registry.prometheus_text())


def test_fingerprint_ledger_and_sentinel_match_jax(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    port = _sentinel_run(tsentinel, tregistry, tmp_path / "t")
    jax_ = _sentinel_run(jsentinel, jregistry, tmp_path / "j")
    assert port == jax_
    rows, verdicts, events, _ = port
    assert len(rows) == 6 and rows[0]["tokens_per_s"] == 99.0
    assert [v["regressed"] for v in verdicts] == [False, True, False]
    assert [e["metric"] for e in events] == ["tokens_per_s", "step_time_s"]
    assert tsentinel.SENTINEL_METRICS == jsentinel.SENTINEL_METRICS
    assert tsentinel.FINGERPRINT_SCHEMA == jsentinel.FINGERPRINT_SCHEMA
    meta = tsentinel.fingerprint("session", run_metadata={
        "platform": "gpu", "device_kind": "NVIDIA H100", "num_devices": 1,
        "torch_version": "2", "cuda_version": "12", "hostname": "h"})
    assert meta["key"] == "session:-:gpu:NVIDIA H100"
    assert set(meta["run_metadata"]) == {"platform", "device_kind",
                                         "num_devices", "torch_version",
                                         "cuda_version"}


def _write_report(directory, step_mean, flops):
    directory.mkdir(parents=True, exist_ok=True)
    report = {"num_steps": 10,
              "step_time_s": {"mean": step_mean, "p95": step_mean * 1.5},
              "mfu": {"mfu": 0.25, "tokens_per_s_per_chip": 1234.5,
                      "peak_flops_source": "x"},
              "mfu_analyzed": {"mfu": 0.31},
              "phases": {"compute": {"fraction": 0.8},
                         "data": {"fraction": 0.2}},
              "cost_ledger": {"train_step": {"flops": flops}},
              "compile": {"total": 3, "seconds": 1.5}}
    with open(directory / "obs_report.json", "w") as f:
        json.dump(report, f)
    return directory


@pytest.mark.parametrize("kind", ["dir", "report", "ledger"])
def test_load_perf_artifact_and_render_diff_match_jax(tmp_path, kind):
    a = _write_report(tmp_path / "a", 0.5, 1.0e12)
    b = _write_report(tmp_path / "b", 0.25, 1.5e12)
    for d, tokens in ((a, 100.0), (b, 150.0)):
        jsentinel.PerfLedger(str(d / "PERF_LEDGER.jsonl")).append(
            _fp(jsentinel, tokens))
    paths = {"dir": (str(a), str(b)),
             "report": (str(a / "obs_report.json"),
                        str(b / "obs_report.json")),
             "ledger": (str(a / "PERF_LEDGER.jsonl"),
                        str(b / "PERF_LEDGER.jsonl"))}[kind]
    views = {m: [m.load_perf_artifact(p) for p in paths]
             for m in (tsentinel, jsentinel)}
    assert views[tsentinel] == views[jsentinel]
    text = tsentinel.render_diff(*views[tsentinel])
    assert text == jsentinel.render_diff(*views[jsentinel])
    assert ("flops[train_step]" in text) == (kind != "ledger")
    with pytest.raises(FileNotFoundError):
        tsentinel.load_perf_artifact(str(tmp_path / "empty.json"))


def test_session_perf_ledger_resolution_and_banding(tmp_path, monkeypatch):
    monkeypatch.delenv("TDDL_PERF_LEDGER", raising=False)
    assert ObsSession(str(tmp_path / "a")).perf_ledger_path == \
        str(tmp_path / "a" / "PERF_LEDGER.jsonl")
    assert ObsSession(None).perf_ledger_path is None
    assert ObsSession(None).write_perf() is None
    monkeypatch.setenv("TDDL_PERF_LEDGER", str(tmp_path / "env.jsonl"))
    assert ObsSession(str(tmp_path / "b")).perf_ledger_path == \
        str(tmp_path / "env.jsonl")
    shared = str(tmp_path / "shared.jsonl")
    verdicts = []
    for run in range(4):
        s = ObsSession(str(tmp_path / f"run{run}"), perf_ledger=shared)
        s.step_timer.set_model_info(1000, 64)
        for step in range(3):
            s.step_timer.lap("data")
            s.step_timer.lap("compute")
            s.step_timer.finish_step(step=step)
        s.finalize()
        verdicts.append(s.perf_verdict)
    assert [v["baseline_n"] for v in verdicts] == [0, 1, 2, 3]
    rows = tsentinel.PerfLedger(shared).read()
    assert len(rows) == 4 and rows[0]["key"] == "session:lm:cpu:cpu"
    assert not (tmp_path / "run0" / "PERF_LEDGER.jsonl").exists()


# ---------------------------------------------------------------------------
# The obs command against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def obs_dirs(tmp_path_factory, params):
    """Two obs directories the port wrote (a served run under every
    tier, an incident from a drill dump), read by both commands."""
    root = tmp_path_factory.mktemp("obs_cli")
    dirs = []
    for run in range(2):
        d = root / f"run{run}"
        s = ObsSession(str(d), perf_ledger=str(root / "P.jsonl"))
        s.enable_spans()
        s.open_ledger()
        s.enable_forensics()
        s.enable_compile_watch()
        s.install_watchers()
        engine = ServingEngine(params, CFG, obs=s, **ENGINE)
        _serve(engine, _traffic(n=3, seed=7 + run))
        engine.analyze_programs(s.cost_ledger)
        s.dump_flight("drill", step=run)
        s.finalize()
        dirs.append(str(d))
    return dirs


def _cli_outputs(capsys, argv):
    outs = []
    for main in (cli.obs_main, jcli.obs_main):
        rc = main(list(argv))
        outs.append((rc, capsys.readouterr().out.replace(
            "python -m trustworthy_dl_tpu_torch.cli obs",
            "trustworthy-dl-obs")))
    return outs


@pytest.mark.parametrize("case", [
    "summary", "tail", "type", "request", "report", "slo", "chrome",
    "diff", "incident_list", "incident_show", "incident_blast",
    "incident_missing", "no_dir"])
def test_obs_command_prints_what_jax_prints(obs_dirs, capsys, tmp_path,
                                            case):
    a, b = obs_dirs
    argv = {"summary": [a], "tail": [a, "--tail", "4"],
            "type": [a, "--type", "span", "--tail", "3"],
            "request": [a, "--request-id", "1"],
            "report": [a, "--report"], "slo": [a, "--slo"],
            "chrome": [a, "--chrome", str(tmp_path / "c.json")],
            "diff": ["diff", a, b],
            "incident_list": ["incident", "list", "--dir", a],
            "incident_show": ["incident", "show", "1", "--dir", a],
            "incident_blast": ["incident", "blast", "drill", "--dir", b],
            "incident_missing": ["incident", "show", "nope", "--dir", a],
            "no_dir": [str(tmp_path / "absent")]}[case]
    port, jax_ = _cli_outputs(capsys, argv)
    assert port == jax_
    assert port[0] == (2 if case in ("incident_missing", "no_dir") else 0)
    if case == "summary":
        assert "incidents: incident_001_drill.json" in port[1]
        assert "VERDICTS.jsonl: 1 row(s) — incident:recorded=1" in port[1]
    if case == "diff":
        assert "flops[serve.paged_decode]" in port[1]


def test_obs_command_never_imports_torch(obs_dirs):
    a, b = obs_dirs
    code = (
        "import sys\n"
        "from trustworthy_dl_tpu_torch.cli import main\n"
        f"for argv in ([{a!r}], ['diff', {a!r}, {b!r}],\n"
        f"             ['incident', 'list', '--dir', {a!r}],\n"
        f"             ['incident', 'show', '1', '--dir', {a!r}],\n"
        f"             [{a!r}, '--report', '--slo']):\n"
        "    assert main(['obs'] + argv) == 0, argv\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'jaxlib', 'trustworthy_dl_tpu')]\n"
        "assert not bad, bad[:5]\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    assert "incident_001_drill" in proc.stdout
