"""Rule registry: one instance of every shipped rule, stable order (JAX's
rule names, each with the port's spelling where it differs).

Adding a rule: subclass :class:`~..engine.Rule` in the family module it
belongs to (or a new one), give it a unique kebab-case ``name`` and a
one-line ``description``, scope it via ``applies`` against the tables
in :mod:`~..contracts`, and list it here.  Ship it with fixture tests
in ``tests/test_torch_lint.py`` (positive, negative, suppression) and
fix — or baseline, with a justification — whatever it finds in the
package.
"""

from __future__ import annotations

from typing import List

from trustworthy_dl_tpu_torch.analysis.engine import Rule
from trustworthy_dl_tpu_torch.analysis.rules.artifact import (
    ArtifactReasonRule)
from trustworthy_dl_tpu_torch.analysis.rules.determinism import (
    PredictPurityRule, TickDeterminismRule)
from trustworthy_dl_tpu_torch.analysis.rules.hygiene import (
    ArtifactMetadataRule, AtomicWriteRule, BareExceptRule,
    MutableDefaultRule)
from trustworthy_dl_tpu_torch.analysis.rules.jit import (
    HostSyncRule, RecompileHazardRule)
from trustworthy_dl_tpu_torch.analysis.rules.locality import (
    AdapterLocalityRule, ShardingRegistryRule)
from trustworthy_dl_tpu_torch.analysis.rules.obs import (
    MetricLabelRule, MetricPrefixRule, ObsEmitRule)
from trustworthy_dl_tpu_torch.analysis.rules.purity import ImportPurityRule


def all_rules() -> List[Rule]:
    """Fresh instances (rules are stateless, but cheap anyway)."""
    return [
        # obs contracts
        ObsEmitRule(),
        MetricPrefixRule(),
        MetricLabelRule(),
        # artifact contracts
        ArtifactReasonRule(),
        # determinism
        TickDeterminismRule(),
        PredictPurityRule(),
        # import purity
        ImportPurityRule(),
        # jit hazards
        RecompileHazardRule(),
        HostSyncRule(),
        # resource locality
        AdapterLocalityRule(),
        ShardingRegistryRule(),
        # hygiene
        MutableDefaultRule(),
        BareExceptRule(),
        ArtifactMetadataRule(),
        AtomicWriteRule(),
    ]
