"""PyTorch/CUDA port of the UPIR serving system.

A peer of the JAX package ``repro``, held against it by the tests: the same
module layout and names, the same UPIR program text and fingerprints, and the
same token streams. It imports ``torch`` and never ``jax`` or ``repro``; the
modules of ``repro`` that hold no JAX code (the UPIR core, the scheduler) are
copied here rather than imported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with no
card and no ``device="cpu"`` they raise.
"""
