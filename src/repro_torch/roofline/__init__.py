"""Roofline terms of the port on one NVIDIA H100: the card's constants
(``hw``), an aten-op cost model run by a dispatch mode (``op_cost``), and
the compute / memory / collective terms of one call (``analysis``) — the
counterpart of the JAX package's ``repro.roofline``."""
