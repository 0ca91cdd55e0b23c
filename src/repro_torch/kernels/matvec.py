"""Matrix-vector product ``y = A @ x``: the Hopper kernel, its plain version
and the wrapper.

The counterpart of the JAX package's ``kernels/matvec.py`` (the paper's MV
benchmark). ``matvec`` runs the plain version :func:`matvec_ref` for CPU
tensors and launches the CUDA kernel (``csrc/matvec.cu``) for CUDA tensors,
or raises; ``matvec.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import DTYPE_CODES, INT, PTR, function, launch, operands

matvec_ref = ref.matvec              # the plain version


def matvec(a, x, *, bm: int = 512, bk: int = 1024):
    """y[M] = A[M,K] @ x[K], float32 accumulation rounded once to A's dtype.
    ``bm``/``bk`` are the TPU kernel's tiles and must divide M and K, as
    there; the CUDA kernel's own tiling does not depend on them."""
    M, K = a.shape
    bm, bk = min(bm, M), min(bk, K)
    if x.shape != (K,) or M % bm or K % bk:
        raise ValueError(f"matvec: A {tuple(a.shape)}, x {tuple(x.shape)}, "
                         f"tiles ({bm}, {bk}) must divide (M, K)")
    if a.device.type == "cpu":
        return matvec_ref(a, x)
    code = operands("matvec", DTYPE_CODES, a, x)
    out = torch.empty((M,), dtype=a.dtype, device=a.device)
    fn = function("matvec", "matvec_launch", [PTR, PTR, PTR, INT, INT, INT])
    launch("matvec", fn, a.device, a.data_ptr(), x.data_ptr(),
           out.data_ptr(), M, K, code)
    matvec.launches += 1
    return out


matvec.launches = 0
