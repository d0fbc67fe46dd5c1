"""PyTorch/CUDA port of the GOMA serving stack (the JAX package ``repro``
is the reference).

Module paths mirror ``repro``: ``core`` (the exact solver, copied
verbatim, plus ``core.hopper_mapping``, the Hopper counterpart of
``core.tpu_mapping``), ``kernels`` (the hand-written CUDA kernels for
sm_90a and their plain PyTorch versions), ``models``, ``serving`` and
``launch``.  The package imports torch and numpy, never jax and never
``repro``.
"""
