"""Matrix product ``C = A @ B``: the Hopper kernel, its plain version and the
wrapper.

The counterpart of the JAX package's ``kernels/matmul.py`` (the paper's MM
benchmark). ``matmul`` runs the plain version :func:`matmul_ref` for CPU
tensors and launches the CUDA kernel (``csrc/matmul.cu``: bfloat16 on the
tensor cores, float32 on the CUDA cores, never TF32) for CUDA tensors, or
raises; ``matmul.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import DTYPE_CODES, INT, PTR, function, launch, operands

matmul_ref = ref.matmul              # the plain version


def matmul(a, b, *, bm: int = 256, bn: int = 256, bk: int = 256):
    """C[M,N] = A[M,K] @ B[K,N], float32 accumulation rounded once to A's
    dtype. ``bm``/``bn``/``bk`` are the TPU kernel's tiles and must divide
    the dims, as there; the CUDA kernel's own tiling does not depend on
    them."""
    M, K = a.shape
    K2, N = b.shape
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if K != K2 or M % bm or N % bn or K % bk:
        raise ValueError(f"matmul: A {tuple(a.shape)} @ B {tuple(b.shape)},"
                         f" tiles ({bm}, {bn}, {bk}) must divide the dims")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    code = operands("matmul", DTYPE_CODES, a, b)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    fn = function("matmul", "matmul_launch", [PTR, PTR, PTR, INT, INT, INT,
                                              INT])
    launch("matmul", fn, a.device, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), M, N, K, code)
    matmul.launches += 1
    return out


matmul.launches = 0
