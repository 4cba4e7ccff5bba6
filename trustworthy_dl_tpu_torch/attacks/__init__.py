"""Attack injection for experiments (``adversarial``)."""

from trustworthy_dl_tpu_torch.attacks.adversarial import (  # noqa: F401
    AdversarialAttacker, AttackPlan, null_plan, plan_from_config)
from trustworthy_dl_tpu_torch.core.config import AttackConfig  # noqa: F401
