"""repro_torch — the PyTorch/CUDA port of ``repro`` for an NVIDIA H100.

Same sub-packages and module names as the JAX package, so the counterpart
of a module is found by its path; plain functions on tensors inside, an
explicit device, and kernels written by hand in CUDA C++ for ``sm_90a``
(``kernels/csrc``).  The package imports ``torch``, numpy and scipy only:
never ``jax``, and nothing of ``repro``.

Ported so far: the planning stack under ``core/`` that the main path
needs, ``obs.metrics``, the plan verifier under ``analysis/``, the conv
network configs, and ``kernels/`` for convolutions (``ops.conv2d``,
``emit.plan_emitable_network`` → ``EmittedConv.run``).
"""

__version__ = "0.1.0"
