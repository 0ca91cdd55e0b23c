"""AXPY ``a * x + y``: the Hopper kernel, its plain version and the wrapper.

The counterpart of the JAX package's ``kernels/axpy.py`` (the paper's Fig. 8
kernel). ``axpy`` runs the plain version :func:`axpy_ref` for CPU tensors and
launches the CUDA kernel (``csrc/axpy.cu``) for CUDA tensors, or raises;
``axpy.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import DTYPE_CODES, FLOAT, INT, LONG, PTR, function, launch, \
    operands

axpy_ref = ref.axpy                  # the plain version


def axpy(a, x, y, *, block: int = 1024):
    """a: scalar (cast to ``x``'s dtype); x/y: [N]. ``block`` is the TPU
    kernel's tile and must divide N, as there; the CUDA kernel's own tiling
    does not depend on it."""
    n = x.shape[0]
    block = min(block, n)
    if x.dim() != 1 or y.shape != x.shape or n % block:
        raise ValueError(f"axpy: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"block {block} must divide N")
    if x.device.type == "cpu":
        return axpy_ref(a, x, y)
    code = operands("axpy", DTYPE_CODES, x, y)
    out = torch.empty_like(x)
    a_cast = float(torch.as_tensor(a, dtype=x.dtype))
    fn = function("axpy", "axpy_launch", [PTR, PTR, PTR, FLOAT, LONG, INT])
    launch("axpy", fn, x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(),
           a_cast, n, code)
    axpy.launches += 1
    return out


axpy.launches = 0
