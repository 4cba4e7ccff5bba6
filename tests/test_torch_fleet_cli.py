"""``cli serve --fleet-replicas`` against JAX's ``serve_main`` on the CPU
in f32 (tiny GPT-2: 2 layers, 32 wide, 4 heads, vocab 107).

* The same seed, flags and weights (JAX's random init, converted with
  ``models/convert.params_from_jax``) through both packages: the same
  summary lines (the fleet banner, statuses, completed tokens, replica
  states, every counter, suspicion), ``ticks`` aside (the workload is
  replayed open loop against the wall clock), and each request's greedy
  stream equal to JAX's.
* The fleet flags reach the ``FleetConfig`` as in JAX.
* The control plane's flags parse with JAX's defaults, and any value
  exits 2 naming ROADMAP item 20.
"""

import jax
import numpy as np
import pytest
import torch

from trustworthy_dl_tpu import cli as jcli
from trustworthy_dl_tpu.serve import fleet as jfleet_mod
from trustworthy_dl_tpu_torch import cli
from trustworthy_dl_tpu_torch.models import convert
from trustworthy_dl_tpu_torch.serve import fleet as fleet_mod

pytestmark = pytest.mark.torchport

TINY = dict(n_layer=2, n_embd=32, n_head=4, vocab_size=107, n_positions=48,
            seq_len=16)
FLEET = ["--fleet-replicas", "2", "--num-requests", "6", "--max-seq", "32",
         "--max-new-tokens", "6", "--prompt-len", "6", "--block-size", "8",
         "--max-slots", "2", "--temperature", "0", "--seed", "3",
         "--vote-k", "2", "--vote-outvote-limit", "3",
         "--hedge-deadline-ms", "5"]


def _capture(monkeypatch, cls):
    fleets = []
    real = cls.metrics_summary

    def summary(self):
        fleets.append(self)
        return real(self)

    monkeypatch.setattr(cls, "metrics_summary", summary)
    return fleets


def _summary_lines(out):
    start = [i for i, ln in enumerate(out) if ln.startswith("fleet served")]
    assert len(start) == 1, out
    lines = [out[start[0]]]
    for ln in out[start[0] + 1:]:
        if not ln.startswith("  "):
            break
        if not ln.startswith("  ticks:"):
            lines.append(ln)
    return lines


def test_fleet_serve_matches_jax_serve_main(tmp_path, capsys, monkeypatch):
    import jax.numpy as jnp

    torch.set_num_threads(1)
    jfleets = _capture(monkeypatch, jfleet_mod.ServingFleet)
    fleets = _capture(monkeypatch, fleet_mod.ServingFleet)
    empty = str(tmp_path / "none")
    assert jcli.serve_main(FLEET + ["--checkpoint-dir", empty],
                           model_overrides=dict(TINY,
                                                dtype=jnp.float32)) == 0
    jout = capsys.readouterr().out.splitlines()
    jparams = jax.tree_util.tree_map(np.asarray, jfleets[0]._params)
    monkeypatch.setattr(cli, "_restore_for_inference",
                        lambda trainer, d, what: convert.params_from_jax(
                            jparams))
    assert cli.serve_main(FLEET + ["--checkpoint-dir", empty, "--device",
                                   "cpu"],
                          model_overrides=dict(TINY,
                                               dtype=torch.float32)) == 0
    out = capsys.readouterr().out.splitlines()
    assert _summary_lines(out) == _summary_lines(jout)
    assert "  statuses: {'completed': 6}" in out
    jres, res = jfleets[0].results, fleets[0].results
    assert sorted(res) == sorted(jres) == list(range(6))
    for fid in res:
        assert res[fid].tokens == list(jres[fid].tokens), fid
    cfg = fleets[0].config
    assert (cfg.num_replicas, cfg.vote_k, cfg.vote_outvote_limit,
            cfg.hedge_deadline_s, cfg.live_migration) == \
        (2, 2, 3, 0.005, True)
    assert jfleets[0].config.hedge_deadline_s == cfg.hedge_deadline_s


@pytest.mark.parametrize("flag", [
    ["--autoscale-min", "1"], ["--autoscale-max", "3"],
    ["--tenant-quota", "100"], ["--tenant-quota-refill", "2.0"],
    ["--slo-class", "default"], ["--pool-roles", "prefill,decode"]])
def test_control_plane_flags_exit_2_naming_item_20(flag, capsys):
    assert cli.serve_main(["--device", "cpu", "--fleet-replicas", "2"]
                          + flag) == 2
    assert "item 20" in capsys.readouterr().out


def test_fleet_flags_parse_with_jax_defaults():
    dests = ("fleet_replicas", "pool_roles", "no_live_migration",
             "hedge_deadline_ms", "vote_k", "vote_outvote_limit",
             "autoscale_min", "autoscale_max", "tenant_quota",
             "tenant_quota_refill", "slo_class")
    args = cli.build_serve_parser().parse_args([])
    jargs = jcli.build_serve_parser().parse_args([])
    assert {d: getattr(args, d) for d in dests} == \
        {d: getattr(jargs, d) for d in dests}
    assert set(cli.CONTROL_PLANE_FLAGS) <= set(dests)
