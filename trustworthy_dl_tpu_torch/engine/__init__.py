"""The trusted training step (``step``), its state (``state``), optimizers
(``optimizer``), the host loop (``trainer``), verified checkpoints
(``checkpoint``) and the self-healing supervisor (``supervisor``)."""
