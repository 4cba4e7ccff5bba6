"""Attack injection for experiments (``adversarial``)."""

from trustworthy_dl_tpu_torch.attacks.adversarial import ATTACK_KINDS, \
    AdversarialAttacker, AttackPlan, null_plan, plan_from_config, \
    poison_batch, poison_gradients
from trustworthy_dl_tpu_torch.core.config import AttackConfig

__all__ = ["ATTACK_KINDS", "AdversarialAttacker", "AttackConfig",
           "AttackPlan", "null_plan", "plan_from_config", "poison_batch",
           "poison_gradients"]
