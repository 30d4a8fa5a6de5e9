"""The port's example workloads, counterparts of the JAX package's
``examples/``: ``ideal_vortex`` (the acceptance test) and
``area_of_influence`` (the research workflow).  Each runs as
``python -m lagrangiancoherence_tpu_torch.examples.<name>`` with the JAX
script's flags and ``--device`` (default: the CUDA card), and its
``main(argv)`` returns the summary it prints."""
