"""The trusted training step (``step``), its state (``state``), optimizers
(``optimizer``) and the host loop (``trainer``)."""
