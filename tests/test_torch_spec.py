"""The port's speculative decoding (trustworthy_dl_tpu_torch/serve: the int8
self-draft, the batched verify pass, acceptance and rollback) against the
JAX ``ServingEngine`` at ``spec_k`` 3, 4 and 8 over the model-dtype and the
int8 KV pools, on the CPU in f32, and against the port's own spec-off
engine.

Both packages serve the same greedy traffic (prompts longer than a chunk,
two sharing a full-block prefix, budgets that end mid-window): token
streams identical, and ``spec_proposed``/``spec_accepted``/
``spec_near_tie_flips``/``spec_ticks`` equal, on both of the port's
attention paths (the kernel path's plain twins and the gathered-view
path).  k = 8 sends the verify window (T = 9) through the chunked-prefill
attention.  Sampled streams are checked within the port: spec on equals
spec off, since a sampled token is a function of (seed, emission index,
logits).  On CPU tensors no kernel launches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.core.config import validate_spec as jvalidate_spec
from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu_torch import ops
from trustworthy_dl_tpu_torch.cli import serve_main
from trustworthy_dl_tpu_torch.core.config import (SPEC_K_MAX, ServeConfig,
                                                  validate_spec)
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.quant import int8 as q8
from trustworthy_dl_tpu_torch.serve import ServeRequest, ServingEngine

pytestmark = pytest.mark.torchport

# vocab 239: no other test file uses it (the JAX engines' programs are this
# file's own in the process-wide jit cache).
JCFG = jgpt2.GPT2Config(vocab_size=239, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=239, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=3, max_seq=48, block_size=8, queue_limit=32,
              kv_parity_check=False)
COUNTERS = ("spec_proposed", "spec_accepted", "spec_near_tie_flips",
            "spec_ticks", "spec_fallback_ticks")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _counters_stay_zero():
    ops.reset_launch_counts()
    yield
    assert all(n == 0 for n in ops.launch_counts().values())


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(2), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _traffic():
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 239, 16).tolist()        # two full blocks
    reqs = [(rng.integers(0, 239, int(n)).tolist(), int(m))
            for n, m in zip(rng.integers(3, 20, 4), rng.integers(2, 10, 4))]
    return reqs + [(shared + [5], 6), (shared + [7, 8], 7), ([9, 9, 4], 1)]


def _serve(engine, traffic, temperature=0.0):
    for prompt, new in traffic:
        engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new,
                                   temperature=temperature))
    return {rid: r.tokens for rid, r in engine.run_until_idle().items()}


@pytest.fixture(scope="module")
def jax_runs(params):
    jparams, _ = params
    runs = {}
    for kv in ("model", "int8"):
        for k in (3, 4, 8):
            engine = JEngine(jparams, JCFG, paged=True, spec_k=k,
                             kv_dtype=kv, enable_monitor=False, **ENGINE)
            for prompt, new in _traffic():
                engine.submit(JRequest(prompt=prompt, max_new_tokens=new))
            res = engine.run_until_idle()
            summary = engine.metrics_summary()
            runs[kv, k] = ({rid: r.tokens for rid, r in res.items()},
                           {c: summary[c] for c in COUNTERS})
    return runs


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
@pytest.mark.parametrize("k", [3, 4, 8])
def test_spec_streams_and_counters_match_jax(params, jax_runs, kv_dtype, k):
    _, tparams = params
    ref_tokens, ref_counts = jax_runs[kv_dtype, k]
    assert ref_counts["spec_proposed"] > 0
    off = _serve(ServingEngine(tparams, CFG, device="cpu", kv_dtype=kv_dtype,
                               enable_monitor=False, **ENGINE), _traffic())
    assert off == ref_tokens
    for impl in ("kernel", "plain"):
        streamed = {}
        engine = ServingEngine(tparams, CFG, device="cpu", spec_k=k,
                               kv_dtype=kv_dtype, attn_impl=impl,
                               enable_monitor=False, **ENGINE)
        for prompt, new in _traffic():
            engine.submit(ServeRequest(
                prompt=prompt, max_new_tokens=new,
                on_token=lambda rid, tok: streamed.setdefault(
                    rid, []).append(tok)))
        results = engine.run_until_idle()
        got = {rid: r.tokens for rid, r in results.items()}
        summary = engine.metrics_summary()
        assert got == ref_tokens
        assert streamed == got               # every burst token streamed
        assert {c: summary[c] for c in COUNTERS} == ref_counts
        assert all(r.status == "completed" for r in results.values())
        assert 0.0 <= summary["accepted_rate"] <= 1.0
        assert summary["spec_k"] == k
        sched = engine.scheduler
        # No block leaked: after idle only the prefix cache holds blocks,
        # and no speculative claim is outstanding.
        assert not sched._spec_claims
        assert sched.blocks_in_use == len(sched.prefix)
        assert engine.scheduler.kv.quantized == (kv_dtype == "int8")


def test_sampled_streams_spec_on_equal_spec_off(params):
    _, tparams = params
    runs = []
    for k in (0, 4):
        engine = ServingEngine(tparams, CFG, device="cpu", spec_k=k, seed=11,
                               kv_dtype="int8", enable_monitor=False,
                               **ENGINE)
        runs.append(_serve(engine, _traffic(), temperature=0.9))
    assert runs[0] == runs[1]
    greedy = _serve(ServingEngine(tparams, CFG, device="cpu", seed=11,
                                  enable_monitor=False, **ENGINE),
                    _traffic())
    assert runs[0] != greedy                 # the draws do sample


def test_eos_inside_an_accepted_window_stops_the_stream(params):
    _, tparams = params
    prompt = [9, 4, 33]
    ref = _serve(ServingEngine(tparams, CFG, device="cpu",
                               enable_monitor=False, **ENGINE),
                 [(prompt, 8)])[0]
    eos = ref[3]
    stop = ref.index(eos) + 1
    engine = ServingEngine(tparams, CFG, device="cpu", spec_k=4,
                           prefix_cache=False, enable_monitor=False,
                           **ENGINE)
    rid = engine.submit(ServeRequest(prompt=prompt, max_new_tokens=8,
                                     eos_id=eos))
    result = engine.run_until_idle()[rid]
    assert result.status == "completed"
    assert result.tokens == ref[:stop] and len(result.tokens) < 8
    summary = engine.metrics_summary()
    assert summary["spec_accepted"] >= stop - 2   # stopped inside a window
    assert engine.scheduler.allocator.free_count == 3
    assert engine.scheduler.blocks_in_use == 0


def test_validate_spec_errors_match_jax():
    cases = [(-1, True, "model"), (SPEC_K_MAX + 1, True, "model"),
             (2, False, "model"), (2, True, "int8")]
    for case in cases:
        with pytest.raises(ValueError) as jerr:
            jvalidate_spec(*case)
        with pytest.raises(ValueError) as terr:
            validate_spec(*case)
        assert str(terr.value) == str(jerr.value)
    validate_spec(SPEC_K_MAX, True, "model")
    with pytest.raises(ValueError, match="spec_k"):
        ServeConfig(spec_k=SPEC_K_MAX + 1)
    with pytest.raises(ValueError, match="weight_dtype"):
        ServeConfig(spec_k=2, weight_dtype="int8")


def test_from_config_threads_knobs_and_builds_the_int8_draft(params):
    _, tparams = params
    with pytest.raises(ValueError, match="weight_dtype"):
        ServingEngine(tparams, CFG, device="cpu", spec_k=2,
                      weight_dtype="int8", **ENGINE)
    config = ServeConfig(max_slots=2, max_seq=48, block_size=8, spec_k=2,
                         kv_dtype="int8", kv_parity_check=False)
    engine = ServingEngine.from_config(tparams, CFG, config, device="cpu")
    sched = engine.scheduler
    assert engine.spec_k == sched.spec_k == 2
    assert engine.kv_dtype == "int8" and sched.kv.quantized
    assert all(q8.is_quantized_dense(layer["mlp"]["fc"])
               for layer in sched.draft_view["layers"])
    assert not q8.is_quantized_dense(sched.view["layers"][0]["mlp"]["fc"])
    assert sched.draft_view["wte_head"] is sched.view["wte_head"]
    off = ServingEngine.from_config(
        tparams, CFG, ServeConfig(max_slots=2, max_seq=48, block_size=8),
        device="cpu")
    assert off.spec_k == 0 and off.scheduler.draft_view is None
    assert "spec_k" not in off.metrics_summary()


def test_cli_serves_spec_and_int8_tiers_on_cpu(capsys, tmp_path):
    overrides = dict(n_layer=1, n_embd=16, n_head=2, vocab_size=64,
                     n_positions=32, dtype=torch.float32)
    base = ["--device", "cpu", "--num-requests", "3", "--max-seq", "32",
            "--checkpoint-dir", str(tmp_path / "none"),
            "--max-new-tokens", "5", "--prompt-len", "6", "--block-size", "8"]
    assert serve_main(base + ["--spec-k", "3", "--kv-dtype", "int8"],
                      model_overrides=overrides) == 0
    out = capsys.readouterr().out
    assert "requests_completed: 3" in out and "spec_ticks" in out
    assert serve_main(base + ["--weight-dtype", "int8"],
                      model_overrides=overrides) == 0
    assert "requests_completed: 3" in capsys.readouterr().out


def test_quarantine_under_speculation_impounds_and_releases(params):
    """A request the monitor flags retires quarantined from a spec engine:
    its row and private blocks leave service with no speculative claim
    left on them, and the operator's release returns both."""
    from trustworthy_dl_tpu_torch.serve import OutputMonitor

    _, tparams = params
    monitor = OutputMonitor(window=8, warmup=2)
    for value in (0.1, 0.12, 0.11):
        monitor.observe([value], [value])
    engine = ServingEngine(tparams, CFG, device="cpu", spec_k=4,
                           kv_dtype="int8", monitor=monitor,
                           prefix_cache=False, **ENGINE)
    rid = engine.submit(ServeRequest(prompt=[3, 4, 5], max_new_tokens=9))
    result = engine.run_until_idle()[rid]
    sched = engine.scheduler
    assert result.flagged and len(result.tokens) == 9
    assert engine.quarantined_slots == {0} and not sched._spec_claims
    assert len(sched.blocks.quarantined) == 2        # ceil(12 / 8) blocks
    assert sched.blocks_in_use == 0
    engine.release_quarantine(0)
    assert engine.quarantined_slots == set()
    assert sched.blocks.free_count == sched.num_blocks
