"""The port's paged serving slice (trustworthy_dl_tpu_torch/serve) against
the JAX ``ServingEngine`` on the same converted weights and requests, on
the CPU in f32.

Both engines serve the same greedy traffic: prompts longer than the
prefill chunk, two requests sharing a full-block prefix (the second is a
prefix-cache resume), one prompt that fits a chunk (the dense local
prefill), and more requests than slots.  The token streams must be
identical and the per-token entropy and margin within 1e-4 (f32; the
JAX engine runs the jnp gather path, the port its kernels' plain
versions).  The JAX margins are checked to stay above 1e-3 first, so no
near-tie can make the comparison fragile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.models import gpt2 as jgpt2
from trustworthy_dl_tpu.serve import OutputMonitor as JMonitor
from trustworthy_dl_tpu.serve import ServeRequest as JRequest
from trustworthy_dl_tpu.serve import ServingEngine as JEngine
from trustworthy_dl_tpu.serve import kv_slots as jkv
from trustworthy_dl_tpu_torch.cli import main as cli_main
from trustworthy_dl_tpu_torch.core.config import ServeConfig
from trustworthy_dl_tpu_torch.models import convert, gpt2
from trustworthy_dl_tpu_torch.ops import paged_attention as pa
from trustworthy_dl_tpu_torch.serve import (OutputMonitor, ServeRequest,
                                            ServingEngine)
from trustworthy_dl_tpu_torch.serve import kv_slots as tkv

pytestmark = pytest.mark.torchport

# vocab 211: no other test file uses it, so the JAX engine's paged
# programs are this file's own in the process-global jit cache.
JCFG = jgpt2.GPT2Config(vocab_size=211, n_positions=64, n_layer=2,
                        n_embd=32, n_head=4, dtype=jnp.float32)
CFG = gpt2.GPT2Config(vocab_size=211, n_positions=64, n_layer=2, n_embd=32,
                      n_head=4, dtype=torch.float32)
ENGINE = dict(max_slots=2, max_seq=48, block_size=8, prefill_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def params():
    jparams = jgpt2.init_params(jax.random.PRNGKey(0), JCFG)
    return jparams, convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams))


def _traffic():
    # Seed 3: every greedy token's JAX top-1 margin is above 0.02.
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 211, 16).tolist()       # two full blocks
    prompts = [rng.integers(0, 211, 20).tolist(),
               shared + rng.integers(0, 211, 5).tolist(),
               rng.integers(0, 211, 9).tolist(),
               shared + rng.integers(0, 211, 7).tolist(),
               rng.integers(0, 211, 30).tolist()]
    return list(zip(prompts, [8, 6, 10, 7, 5]))


@pytest.fixture(scope="module")
def jax_results(params):
    jparams, _ = params
    engine = JEngine(jparams, JCFG, paged=True, attn_impl="jnp", **ENGINE)
    for prompt, new in _traffic():
        engine.submit(JRequest(prompt=prompt, max_new_tokens=new))
    results = engine.run_until_idle()
    assert engine.metrics_summary()["prefix_hits"] >= 1
    return results


@pytest.mark.parametrize("attn_impl", ["kernel", "plain"])
def test_served_streams_match_jax(params, jax_results, attn_impl):
    _, tparams = params
    pa.reset_launch_counts()
    engine = ServingEngine(tparams, CFG, attn_impl=attn_impl, device="cpu",
                           **ENGINE)
    streamed = {}
    for prompt, new in _traffic():
        engine.submit(ServeRequest(
            prompt=prompt, max_new_tokens=new,
            on_token=lambda rid, tok: streamed.setdefault(rid, []).append(
                tok)))
    results = engine.run_until_idle()
    summary = engine.metrics_summary()
    assert streamed == {rid: r.tokens for rid, r in results.items()}
    assert summary["prefix_hits"] >= 1
    assert summary["local_prefills"] >= 1 and summary["prefill_chunks"] >= 1
    assert summary["requests_completed"] == 5
    assert all(fn.launches == 0 for fn in pa.KERNEL_WRAPPERS)
    for rid, ref in jax_results.items():
        assert min(ref.tokens) >= 0
        got = results[rid]
        assert got.status == ref.status == "completed"
        assert got.tokens == ref.tokens


def test_served_signals_match_jax(params):
    """Entropy and margin of every emitted token within 1e-4, with every
    JAX margin above 1e-3.  The JAX engine keeps the signals on its tasks
    only, so they are read as its scheduler retires each one."""
    jparams, tparams = params
    jsig, tsig = {}, {}
    jengine = JEngine(jparams, JCFG, paged=True, attn_impl="jnp",
                      enable_monitor=False, **ENGINE)
    original = jengine.scheduler.retire

    def keep_signals(task, quarantine=False):
        jsig[task.request_id] = (list(task.entropies), list(task.margins))
        return original(task, quarantine=quarantine)

    jengine.scheduler.retire = keep_signals
    tengine = ServingEngine(tparams, CFG, device="cpu",
                            enable_monitor=False, **ENGINE)
    for prompt, new in _traffic():
        jengine.submit(JRequest(prompt=prompt, max_new_tokens=new))
        tengine.submit(ServeRequest(prompt=prompt, max_new_tokens=new))
    jengine.run_until_idle()
    for rid, res in tengine.run_until_idle().items():
        tsig[rid] = (res.entropies, res.margins)
    assert set(jsig) == set(tsig)
    for rid, (j_ent, j_mar) in jsig.items():
        assert min(j_mar) > 1e-3
        np.testing.assert_allclose(tsig[rid][0], j_ent, rtol=0, atol=1e-4)
        np.testing.assert_allclose(tsig[rid][1], j_mar, rtol=0, atol=1e-4)


def test_sampled_streams_are_deterministic_per_seed(params):
    _, tparams = params

    def run():
        engine = ServingEngine(tparams, CFG, device="cpu", seed=5, **ENGINE)
        for prompt, new in _traffic():
            engine.submit(ServeRequest(prompt=prompt, max_new_tokens=new,
                                       temperature=0.9))
        return {rid: r.tokens for rid, r in engine.run_until_idle().items()}

    assert run() == run()


def test_block_allocator_and_prefix_cache_match_jax():
    """The same sequence of allocator and radix-cache operations leaves
    both packages with the same tables, refcounts and free lists."""
    tokens = list(range(40))
    states = []
    for kv in (jkv, tkv):
        blocks = kv.BlockAllocator(10)
        cache = kv.PrefixCache(8, blocks)
        log = []
        a = blocks.alloc(5)
        log.append(("alloc", a))
        log.append(("insert", cache.insert(tokens, a)))
        log.append(("lookup", cache.lookup(tokens[:24] + [99] * 8, 3)))
        for b in a:
            log.append(("release", b, blocks.release(b)))
        log.append(("evict", cache.evict(2)))
        b2 = blocks.alloc(4)
        log.append(("alloc", b2))
        log.append(("quarantine", b2[0], blocks.release(b2[0],
                                                        quarantine=True)))
        log.append(("purge", cache.purge({a[0]})))
        log.append(("span", kv.blocks_for_span(a, 8, 5, 20)))
        log.append(("state", blocks.free_count, blocks.in_use,
                    sorted(blocks.quarantined), len(cache),
                    [blocks.refcount(b) for b in range(11)]))
        states.append(log)
    assert states[0] == states[1]


def test_output_monitor_matches_jax_and_quarantines(params):
    """Flags and z on a fixed signal sequence equal the JAX monitor's; an
    outlier request's row is quarantined and released by the operator."""
    rng = np.random.default_rng(7)
    jmon = JMonitor(window=8, warmup=4, z_threshold=4.0)
    tmon = OutputMonitor(window=8, warmup=4, z_threshold=4.0)
    seq = [(rng.normal(5.0, 0.1, 6), rng.normal(0.5, 0.05, 6))
           for _ in range(10)]
    seq.insert(7, (np.full(6, 0.2), np.full(6, 9.0)))        # the outlier
    flags = []
    for ent, mar in seq:
        jf, jz = jmon.observe(ent, mar)
        tf, tz = tmon.observe(ent, mar)
        assert jf == tf
        np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
        flags.append(tf)
    assert flags.index(True) == 7 and sum(flags) == 1
    assert jmon.count == tmon.count == 10

    # Seed a monitor whose baseline no real request resembles: the next
    # finished request is flagged and its row leaves service.
    _, tparams = params
    monitor = OutputMonitor(window=8, warmup=2)
    for v in (0.1, 0.12, 0.11):
        monitor.observe([v], [v])
    engine = ServingEngine(tparams, CFG, device="cpu", monitor=monitor,
                           **ENGINE)
    rid = engine.submit(ServeRequest(prompt=[3, 4, 5], max_new_tokens=3))
    result = engine.run_until_idle()[rid]
    assert result.flagged and result.monitor_z > 4.0
    assert engine.quarantined_slots == {0}
    assert engine.metrics_summary()["requests_flagged"] == 1
    engine.release_quarantine(0)
    assert engine.quarantined_slots == set()
    assert engine.scheduler.blocks.quarantined == set()


def test_engine_defaults_to_cuda_and_raises_without_it(params):
    _, tparams = params
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tparams, CFG, **ENGINE)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["serve", "--num-requests", "1"])


def test_config_and_submit_validation(params):
    _, tparams = params
    with pytest.raises(ValueError):
        ServeConfig(attn_impl="pallas")
    with pytest.raises(ValueError):
        ServeConfig(max_seq=50, block_size=16)
    engine = ServingEngine(tparams, CFG, device="cpu", queue_limit=1,
                           **ENGINE)
    with pytest.raises(ValueError):
        engine.submit(ServeRequest(prompt=[1] * 45, max_new_tokens=4))
    with pytest.raises(ValueError):
        engine.submit(ServeRequest(prompt=[211], max_new_tokens=1))
    assert engine.submit(ServeRequest(prompt=[1], max_new_tokens=1)) == 0
    assert engine.submit(ServeRequest(prompt=[1], max_new_tokens=1)) is None


def test_cli_serves_on_cpu(capsys, tmp_path):
    from trustworthy_dl_tpu_torch.cli import serve_main

    rc = serve_main(["--device", "cpu", "--num-requests", "4",
                     "--checkpoint-dir", str(tmp_path / "none"),
                     "--max-seq", "32", "--max-new-tokens", "4",
                     "--prompt-len", "6", "--block-size", "8"],
                    model_overrides=dict(n_layer=1, n_embd=16, n_head=2,
                                         vocab_size=64, n_positions=32,
                                         dtype=torch.float32))
    out = capsys.readouterr().out
    assert rc == 0
    assert "requests_completed: 4" in out
