"""Parallel strategies beyond data mode: pipeline (stage) parallelism
(``pipeline``), sequence parallelism, ring and Ulysses attention
(``sequence``), and the tensor-parallel layout (``tensor_parallel``)."""
