"""Attack detection: the statistic batteries, rolling baselines, the
in-step verdicts, gradient verification and the host ``AttackDetector``
with its ML tier."""
