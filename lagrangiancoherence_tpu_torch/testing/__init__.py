"""Validation fixtures of the port, numpy and scipy only (no torch, no JAX):
``flows`` (the reference's analytic test flows) and ``oracle`` (a scipy
statement of the reference's semantics).  Counterpart of
``lagrangiancoherence_tpu/testing/``."""
