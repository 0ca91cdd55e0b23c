"""5-point 2-D stencil with a zero boundary: the Hopper kernel, its plain
version and the wrapper.

The counterpart of the JAX package's ``kernels/stencil2d.py`` (the paper's
stencil benchmark). ``stencil2d`` runs the plain version
:func:`stencil2d_ref` for CPU tensors and launches the CUDA kernel
(``csrc/stencil2d.cu``, float32 or bfloat16, every op rounded to ``u``'s
dtype) for CUDA tensors, or raises;
``stencil2d.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import DTYPE_CODES, FLOAT, INT, PTR, function, launch, operands

stencil2d_ref = ref.stencil2d        # the plain version


def stencil2d(u, *, w_center: float = -4.0, w_side: float = 1.0,
              bm: int = 256, bn: int = 256):
    """u: [M, N]; ``w_center * u + w_side * (N + S + W + E)`` with zeros
    outside. ``bm``/``bn`` are the TPU kernel's tiles and must divide M and
    N, as there; the CUDA kernel's own tiling does not depend on them."""
    M, N = u.shape
    bm, bn = min(bm, M), min(bn, N)
    if M % bm or N % bn:
        raise ValueError(f"stencil2d: u {tuple(u.shape)}, tiles ({bm}, {bn})"
                         f" must divide (M, N)")
    if u.device.type == "cpu":
        return stencil2d_ref(u, w_center, w_side)
    code = operands("stencil2d", DTYPE_CODES, u)
    out = torch.empty_like(u)
    fn = function("stencil2d", "stencil2d_launch",
                  [PTR, PTR, INT, INT, FLOAT, FLOAT, INT])
    launch("stencil2d", fn, u.device, u.data_ptr(), out.data_ptr(), M, N,
           float(w_center), float(w_side), code)
    stencil2d.launches += 1
    return out


stencil2d.launches = 0
