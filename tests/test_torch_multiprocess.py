"""Multi-process trusted training on the CPU: two worker processes
(``trustworthy_dl_tpu_torch.utils.multiproc_worker``) join one gloo
process group and run the gathered trusted step at the JAX worker's
configuration (8 nodes, GPT-2 with 2 layers, width 32, 4 heads, vocab
128, T 16, 2 rows a node, AdamW at lr 1e-3).

* (a) both exit 0 and print ``MULTIPROC_OK`` with one loss across the
  ranks (the JAX package's ``tests/test_multiprocess.py`` assertion);
* (b) the ranks' trust vectors and final-param hashes are equal;
* (c) the two-process run equals the one-process step over the same
  global batches bit for bit, for 3 steps, under the null plan and under a
  live plan (gradient and data poisoning of nodes 1 and 6, one on each
  rank, from step 1);
* (d) the one-process step at this configuration is within the port's
  step tolerance (``tests/test_torch_train.py``'s ``_check_step``) of
  JAX's ``build_train_step`` on the same params and batches;
* a rank whose peers never arrive fails within its set-up timeout
  instead of hanging, and the set-up's helpers answer without a group.

Workers are bounded by ``communicate(timeout=...)`` and killed in
``finally``; the group's own timeout bounds a collective.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu.attacks.adversarial import null_plan as jnull_plan
from trustworthy_dl_tpu.core.config import TrainingConfig as JTrainingConfig
from trustworthy_dl_tpu.engine.optimizer import \
    build_optimizer as jbuild_optimizer
from trustworthy_dl_tpu.engine.state import \
    init_train_state as jinit_train_state
from trustworthy_dl_tpu.engine.step import \
    build_train_step as jbuild_train_step
from trustworthy_dl_tpu.models.factory import create_model as jcreate_model
from trustworthy_dl_tpu_torch.core import mesh as tmesh
from trustworthy_dl_tpu_torch.core import sharding as shreg
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.utils import multiproc_worker as worker
from test_torch_train import _check_step

pytestmark = pytest.mark.torchport

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
WORKER_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    torch.set_num_threads(1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(rank, world, port, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "trustworthy_dl_tpu_torch.utils."
         "multiproc_worker", str(rank), str(world), str(port), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)


@pytest.fixture(scope="module")
def two_process_runs():
    """Both plans' worker pairs, started together: {plan: [(rc, out, err)
    per rank]}."""
    procs = {}
    for plan in worker.PLANS:
        port = _free_port()
        procs[plan] = [_spawn(r, 2, port, "--device", "cpu", "--steps",
                              str(STEPS), "--plan", plan) for r in range(2)]
    outs = {}
    try:
        for plan, pair in procs.items():
            outs[plan] = []
            for p in pair:
                out, err = p.communicate(timeout=WORKER_TIMEOUT_S)
                outs[plan].append((p.returncode, out, err))
    finally:
        for pair in procs.values():
            for p in pair:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return outs


def _ok_lines(runs):
    lines = []
    for rc, out, err in runs:
        assert rc == 0, (rc, err[-3000:])
        ok = [ln for ln in out.splitlines() if ln.startswith("MULTIPROC_OK")]
        assert len(ok) == 1, (out, err[-2000:])
        lines.append(worker.parse_ok_line(ok[0]))
    return lines


@pytest.mark.parametrize("plan", worker.PLANS)
def test_two_processes_agree_with_each_other(two_process_runs, plan):
    """(a) one loss across the ranks; (b) equal trust and params."""
    ranks = _ok_lines(two_process_runs[plan])
    assert [r["process"] for r in ranks] == [0, 1]
    assert len({r["loss"] for r in ranks}) == 1
    assert np.isfinite(ranks[0]["loss"])
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["trust"] == ranks[1]["trust"]
    assert len(ranks[0]["trust"]) == worker.SIZES["tiny"]["nodes"]
    assert ranks[0]["params"] == ranks[1]["params"]


@pytest.mark.parametrize("plan", worker.PLANS)
def test_two_processes_equal_the_one_process_step(two_process_runs, plan):
    """(c) bit for bit: losses, trust and params hash."""
    ranks = _ok_lines(two_process_runs[plan])
    ref = worker.run_steps("tiny", "cpu", STEPS, plan)
    assert ranks[0]["losses"] == ref["losses"]
    assert ranks[0]["trust"] == ref["trust"]
    assert ranks[0]["params"] == ref["params"]
    if plan == "live":
        # The attacked nodes (1 and 6, on different ranks) are gated.
        assert ref["trust"][1] < 0.5 and ref["trust"][6] < 0.5
        assert ref["trust"][0] > 0.9


def test_one_process_step_matches_jax_at_the_worker_config():
    """(d) the port's one-process step against JAX's ``build_train_step``
    on JAX's initial params, the JAX worker's configuration, 3 null-plan
    steps, at ``tests/test_torch_train.py``'s step tolerances."""
    spec = worker.SIZES["tiny"]
    n, arch = spec["nodes"], dict(spec["model"])
    del arch["dtype"]
    jbundle = jcreate_model("gpt2", dtype=jnp.float32,
                            seq_len=spec["seq_len"], **arch)
    jconfig = JTrainingConfig(
        model_name="gpt2", batch_size=n * spec["rows"], num_nodes=n,
        optimizer="adamw", learning_rate=spec["lr"],
        detector_warmup=spec["warmup"])
    jopt = jbuild_optimizer(jconfig)
    jparams = jbundle.init(jax.random.PRNGKey(0))
    jstate = jinit_train_state(
        jax.random.PRNGKey(1), jparams, jopt.init(jparams), num_nodes=n,
        trust_threshold=jconfig.trust_threshold,
        initial_trust=jconfig.initial_trust,
        decay_rate=jconfig.trust_decay_rate,
        recovery_rate=jconfig.trust_recovery_rate,
        detector_window=jconfig.detector_history)
    jstep = jax.jit(jbuild_train_step(jbundle, jconfig, jopt))
    tmetrics = []
    worker.run_steps(
        "tiny", "cpu", STEPS, "null", metrics_out=tmetrics,
        params=convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jparams)))
    fields = [f for f in tmetrics[0]._fields
              if f not in ("model_aux", "fleet_alert")]
    batches = worker.global_batches("tiny", STEPS, arch["vocab_size"])
    for s, (batch, tm) in enumerate(zip(batches, tmetrics)):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v, jnp.int32)
                                    for k, v in batch.items()},
                           jnull_plan(n))
        _check_step(s, {f: np.asarray(getattr(jm, f)) for f in fields},
                    {f: getattr(tm, f).numpy() for f in fields})


def test_a_lone_rank_fails_within_its_timeout(monkeypatch):
    """Without its peer a rank's set-up raises once the group's timeout
    passes (here shortened), and the set-up helpers answer without a
    group: rank 0 of 1, a no-op shutdown, the single-controller mesh."""
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)
    tmesh.shutdown_multihost()                    # no group: a no-op
    assert tmesh.build_mesh(4, "data").process_index is None
    # A mesh that spans processes places onto this process's position.
    spanning = tmesh.Mesh(np.array([torch.device("cpu"),
                                    torch.device("meta")], dtype=object),
                          (tmesh.DATA_AXIS,), process_index=0)
    assert shreg.replicated_placer(spanning)(torch.ones(2)).device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="do not split evenly"):
        tmesh.process_node_rows(6, 0, 4)
    assert list(tmesh.process_node_rows(8, 1, 2)) == [4, 5, 6, 7]
    monkeypatch.setattr(tmesh, "MULTIHOST_TIMEOUT",
                        datetime.timedelta(seconds=3))
    with pytest.raises(Exception):
        tmesh.initialize_multihost(f"127.0.0.1:{_free_port()}", 2, 1)
    assert tmesh.process_count() == 1
