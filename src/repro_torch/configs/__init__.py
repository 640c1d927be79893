"""Workload configurations of the port: the bilateral-grid configs
(``bg_denoise``) and the LM architectures (``base``, ``registry`` and one
module per arch), each a copy of its JAX twin under ``repro/configs/``."""
