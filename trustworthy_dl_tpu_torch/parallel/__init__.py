"""Parallel strategies beyond data mode: pipeline (stage) parallelism
(``pipeline``) and sequence parallelism, ring and Ulysses attention
(``sequence``).  Tensor parallelism waits for ROADMAP Slice 4b."""
