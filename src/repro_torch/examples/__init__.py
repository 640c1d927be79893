"""Runnable examples of the port, the JAX package's ``examples/`` twins:
``python -m repro_torch.examples.<name>`` runs one on the CUDA card
(``--device cpu`` for the plain versions at a small size). Importing a
module runs nothing; each has ``main(argv=None)``, which prints its report
and returns its numbers."""
