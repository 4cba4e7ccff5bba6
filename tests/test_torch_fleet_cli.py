"""``cli serve --fleet-replicas`` against JAX's ``serve_main`` on the CPU
in f32 (tiny GPT-2: 2 layers, 32 wide, 4 heads, vocab 107).

* The same seed, flags and weights (JAX's random init, converted with
  ``models/convert.params_from_jax``) through both packages: the same
  summary lines (the fleet banner, statuses, completed tokens, replica
  states, every counter, suspicion), ``ticks`` aside (the workload is
  replayed open loop against the wall clock), and each request's greedy
  stream equal to JAX's.
* The fleet flags reach the ``FleetConfig`` as in JAX.
* The control plane's six flags parse with JAX's defaults to JAX's
  values (``_parse_slo_classes``, ``_parse_autoscale``, the quota and the
  pool roles) and refuse what JAX refuses with JAX's message, and a tiny
  autoscaled, quota'd, class-scheduled fleet run completes.
"""

import dataclasses


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


def _jax_control_plane(args):
    """What JAX's ``_serve_fleet`` hands its ``FleetConfig`` from the
    flags."""
    quota = None
    if args.tenant_quota is not None:
        from trustworthy_dl_tpu.serve import TenantQuotaConfig

        quota = TenantQuotaConfig(
            capacity_tokens=args.tenant_quota,
            refill_per_tick=(args.tenant_quota_refill
                             if args.tenant_quota_refill is not None
                             else args.tenant_quota / 64.0))
    roles = (tuple(r.strip() for r in args.pool_roles.split(","))
             if args.pool_roles else None)
    return dict(slo_classes=jcli._parse_slo_classes(args.slo_class),
                autoscale=jcli._parse_autoscale(args),
                tenant_quota=quota, pool_roles=roles)


def _plain(value):
    if dataclasses.is_dataclass(value):
        return dataclasses.asdict(value)
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    return value


@pytest.mark.parametrize("flags", [
    ["--autoscale-min", "1"], ["--autoscale-max", "3"],
    ["--tenant-quota", "100"], ["--tenant-quota", "100",
                                "--tenant-quota-refill", "2.0"],
    ["--slo-class", "default"],
    ["--slo-class", "bulk:0:-:-:1", "--slo-class", "gold:2:500:40:3.5",
     "--pool-roles", "prefill, decode", "--obs-dir", "x"]],
    ids=["autoscale-min", "autoscale-max", "tenant-quota",
         "tenant-quota-refill", "slo-class", "classes-and-pools"])
def test_control_plane_flags_parse_to_jax_values(flags):
    base = ["--fleet-replicas", "2", "--max-slots", "4"]
    args = cli.build_serve_parser().parse_args(base + flags)
    jargs = jcli.build_serve_parser().parse_args(base + flags)
    got, want = cli._control_plane(args), _jax_control_plane(jargs)
    assert {k: _plain(v) for k, v in got.items()} == \
        {k: _plain(v) for k, v in want.items()}
    assert any(v is not None for v in got.values())


@pytest.mark.parametrize("flags", [
    ["--slo-class", "gold:2:500"], ["--slo-class", "gold:x:1:1:1"],
    ["--slo-class", "gold:1:-:-:0"], ["--autoscale-min", "3"],
    ["--autoscale-max", "1"]])
def test_control_plane_flags_refuse_with_jax_message(flags):
    base = ["--fleet-replicas", "2"]
    errors = []
    for parse, build in ((cli._control_plane, cli.build_serve_parser),
                         (_jax_control_plane, jcli.build_serve_parser)):
        with pytest.raises(ValueError) as exc:
            parse(build().parse_args(base + flags))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_control_plane_fleet_run_completes(tmp_path, capsys):
    """A tiny ``--fleet-replicas 2 --autoscale-min 2 --autoscale-max 3
    --tenant-quota ... --slo-class default`` run serves every request and
    prints the control plane's summary keys; a bad value exits 2."""
    torch.set_num_threads(1)
    run = FLEET[:-6] + ["--checkpoint-dir", str(tmp_path / "none"),
                        "--device", "cpu", "--autoscale-min", "2",
                        "--autoscale-max", "3", "--tenant-quota", "10000",
                        "--tenant-quota-refill", "1.0", "--slo-class",
                        "default"]
    assert cli.serve_main(run, model_overrides=dict(
        TINY, dtype=torch.float32)) == 0
    out = capsys.readouterr().out
    assert "  statuses: {'completed': 6}" in out
    for key in ("replicas_in_service", "replica_trace", "per_class",
                "class_queue_depth", "fleet_throttles: 0"):
        assert f"  {key}" in out
    assert cli.serve_main(run + ["--autoscale-min", "3"],
                          model_overrides=dict(TINY,
                                               dtype=torch.float32)) == 2
    assert "control plane: --fleet-replicas 2 must start inside" in \
        capsys.readouterr().out


def test_fleet_flags_parse_with_jax_defaults():
    dests = ("fleet_replicas", "pool_roles", "no_live_migration",
             "hedge_deadline_ms", "vote_k", "vote_outvote_limit",
             "autoscale_min", "autoscale_max", "tenant_quota",
             "tenant_quota_refill", "slo_class")
    args = cli.build_serve_parser().parse_args([])
    jargs = jcli.build_serve_parser().parse_args([])
    assert {d: getattr(args, d) for d in dests} == \
        {d: getattr(jargs, d) for d in dests}
