"""The port's contract tables the rules consult.

Counterpart of ``trustworthy_dl_tpu/analysis/contracts.py``: every JAX
table entry maps to its module in ``trustworthy_dl_tpu_torch/``, and the
tables the port's spellings need (the foreign packages no module may
import, the mesh-axis names a partition spec is built from) are added.
When a module gains or sheds a contract, THIS file is the one place to
update; the rules read it through :class:`~.engine.LintConfig`, so tests
can substitute synthetic tables for fixtures.

Paths are repo-relative posix strings matched with :func:`fnmatch.
fnmatch` (``*`` crosses ``/`` — ``trustworthy_dl_tpu_torch/obs/*.py``
covers the whole subtree).
"""

from __future__ import annotations

_PKG = "trustworthy_dl_tpu_torch"

#: Modules whose decisions must be reproducible from (seed, tick) alone so
#: chaos and fleet drills can pin exact counts (``FaultPlan.predict*``,
#: ``autoscale_pressure``, ``predict_attacker_trajectory``), and the perf
#: sentinel, whose verdicts must not depend on when the comparison runs:
#: no wall clocks, no unseeded RNGs, no set iteration.
DETERMINISTIC_MODULES = (
    f"{_PKG}/serve/control.py",
    f"{_PKG}/chaos/plan.py",
    f"{_PKG}/chaos/adversary.py",
    f"{_PKG}/obs/sentinel.py",
)

#: Modules documented host-only, torch-free at import: the telemetry
#: plane (``cli obs`` reads a run on a machine whose card is the broken
#: thing, and no obs module may initialise CUDA), the fleet's control
#: plane and the adversary (host code inside the fleet tick), the command
#: line's module, the data path's host tier (loader, tokenizer, the C++
#: tier's bindings), the kernel cache and the linter itself.  A
#: module-level import chain from any of these that reaches ``torch`` is a
#: contract break even when the name is never used.
HOST_ONLY_MODULES = (
    f"{_PKG}/obs/*.py",
    f"{_PKG}/serve/control.py",
    f"{_PKG}/chaos/adversary.py",
    f"{_PKG}/cli.py",
    f"{_PKG}/utils/io.py",
    f"{_PKG}/utils/compile_cache.py",
    f"{_PKG}/native/*.py",
    f"{_PKG}/data/*.py",
    f"{_PKG}/analysis/*.py",
)

#: External top-level modules a host-only module must not reach.
DEVICE_RUNTIME_MODULES = frozenset({"torch"})

#: Top-level modules no module of the port imports anywhere, inside
#: functions included: the port runs without JAX and keeps its own copy of
#: whatever it needs from the JAX package.
FOREIGN_MODULES = frozenset({"jax", "jaxlib", "orbax",
                             "trustworthy_dl_tpu"})

#: Modules whose loops are serving and training hot paths: a
#: ``torch.tensor`` literal built per iteration is a blocking host-to-device
#: copy, and a kernel library built or loaded in a loop is a mid-run
#: compile (the port's storm).
HOT_LOOP_MODULES = (
    f"{_PKG}/serve/scheduler.py",
    f"{_PKG}/serve/engine.py",
    f"{_PKG}/engine/step.py",
    f"{_PKG}/engine/trainer.py",
    f"{_PKG}/models/generate.py",
    # The paged kernels' wrappers run inside every paged decode tick, per
    # layer: a per-call constant here is a per-tick copy.
    f"{_PKG}/ops/paged_attention.py",
)

#: module -> function names forming the latency-critical dispatch paths,
#: where an accidental device-to-host pull serialises the card and the
#: host.  The ONE intentional pull a tick is suppressed inline at its site.
HOST_SYNC_SCOPES = {
    f"{_PKG}/serve/scheduler.py": (
        "decode_tick", "_spec_tick", "_advance_prefill", "admit",
    ),
    f"{_PKG}/engine/trainer.py": ("train_epoch",),
    # The paged kernels' wrappers: a pull here would stall every decode
    # tick on every layer (these scopes allow none).
    f"{_PKG}/ops/paged_attention.py": (
        "paged_attention", "paged_attention_int8", "paged_prefill_attention",
        "paged_prefill_attention_int8", "fused_verify_tail", "adapter_delta",
        "logit_trust_stats",
    ),
}

#: Calls whose result lives on the device besides ``torch.*``: the paged
#: programs (``*_impl``), the trainer's step dispatch and the kernel
#: wrappers the hot paths call.
DEVICE_PRODUCERS = frozenset({
    "_dispatch", "_train_step", "_eval_step",
    "paged_attention", "paged_attention_int8", "paged_prefill_attention",
    "paged_prefill_attention_int8", "fused_verify_tail", "adapter_delta",
    "logit_trust_stats", "fused_moments", "flash_attention", "flash_chunk",
    "dequant_matmul",
})

#: Modules that write persistent artifacts (checkpoints, ledgers,
#: reports, experiment results): ``open(path, "w")`` without a
#: tmp-then-``os.replace`` swap in the same function truncates the old
#: artifact before the new one is durable.
ARTIFACT_MODULES = (
    f"{_PKG}/obs/*.py",
    f"{_PKG}/experiments/*.py",
    f"{_PKG}/engine/checkpoint.py",
    f"{_PKG}/trust/manager.py",
    f"{_PKG}/detect/detector.py",
    f"{_PKG}/serve/*.py",
    f"{_PKG}/utils/*.py",
)

#: Modules whose JSON artifacts must carry the run_metadata stamp.
STAMPED_ARTIFACT_MODULES = (
    f"{_PKG}/experiments/*.py",
)

#: Recovery and supervision paths where a bare ``except:`` can swallow
#: KeyboardInterrupt/SystemExit and wedge the ladder that exists to
#: recover.
RECOVERY_MODULES = (
    f"{_PKG}/engine/supervisor.py",
    f"{_PKG}/engine/checkpoint.py",
    f"{_PKG}/serve/fleet.py",
    f"{_PKG}/serve/engine.py",
    f"{_PKG}/chaos/*.py",
)

#: Function-name patterns (fnmatch) of the pure prediction functions
#: drills pin against.
PREDICT_FUNCTION_PATTERNS = (
    "predict_*",
    "autoscale_pressure",
    "diurnal_rate",
    "predicted_replicas",
)

#: The label-name vocabulary dashboards key on (JAX's).
KNOWN_METRIC_LABELS = frozenset({
    "action", "adapter", "device", "direction", "dtype", "kind", "metric",
    "node", "outcome", "path", "phase", "program", "reason", "replica",
    "role", "scope", "signal", "slo", "slo_class", "stage", "state",
    "status", "tenant", "to_state", "type",
})

#: Metric-name prefix every registered literal must carry.
METRIC_PREFIX = "tddl_"

#: The flight-dump / incident reason vocabulary (JAX's): incidents pair
#: with their flight dump and trigger events by reason string.
ARTIFACT_REASONS = frozenset({
    # training supervisor ladder (engine/supervisor.py)
    "guard_trip", "rollback", "preemption",
    # watcher-driven dumps (obs/slo.py, anomaly.py, compilewatch.py)
    "slo_breach", "anomaly", "compile_storm",
    # fleet forensic episodes (serve/fleet.py)
    "replica_quarantine", "replica_preempt", "adapter_quarantine",
    "migration_refused",
    # operator-initiated artifacts (examples, tests, CLI)
    "drill", "manual",
})

#: The adapter-resource locality contract: the per-slot adapter page-table
#: row has one spelling, in serve/adapters.py (the engine's launch
#: shapes key on it).  A definition of either name, or a partition spec
#: built inside an adapter-handling function, elsewhere is a finding.
ADAPTER_HOME_MODULE = f"{_PKG}/serve/adapters.py"
ADAPTER_LOCALITY_NAMES = ("adapter_page_row", "adapter_partition_specs")

#: The sharding-registry locality contract: a partition spec — in the port
#: a plain tuple of mesh-axis names and None (``core.sharding.
#: PartitionSpec``) — is spelled only in core/sharding.py, through its
#: logical-axis rule table.  ``core/mesh.py`` is whitelisted: its
#: axis-name tuples name a mesh's axes, they are not specs.
SHARDING_HOME_MODULE = f"{_PKG}/core/sharding.py"
SHARDING_SPEC_WHITELIST = (
    ADAPTER_HOME_MODULE,
    f"{_PKG}/core/mesh.py",
)

#: The mesh-axis names (``core/mesh.py``'s constants and their values) a
#: spec tuple is built from.
MESH_AXIS_CONSTANTS = frozenset({"DATA_AXIS", "STAGE_AXIS", "MODEL_AXIS",
                                 "SEQ_AXIS", "EXPERT_AXIS"})

#: Default committed baseline of grandfathered findings (repo-relative).
DEFAULT_BASELINE = "tddl_torch_lint_baseline.json"


def event_type_members():
    """Names of the port's ``EventType`` enum — imported lazily from the
    (host-only) events module so contract tables stay import-light."""
    from trustworthy_dl_tpu_torch.obs.events import EventType

    return frozenset(EventType.__members__)
