"""Parallel strategies beyond data mode: pipeline (stage) parallelism
(``pipeline``).  Tensor and sequence parallelism wait for ROADMAP Slice
4b."""
