"""Matrix product ``C = A @ B``: the Hopper kernels, their plain version and
the wrapper.

The counterpart of the JAX package's ``kernels/matmul.py`` (the paper's MM
benchmark). ``matmul`` runs the plain version :func:`matmul_ref` for CPU
tensors and, for CUDA tensors, launches the CUDA kernel
(``csrc/matmul.cu``) that :func:`matmul_route` names, or raises:

* ``"wgmma"`` — bfloat16 on ``wgmma`` fed by TMA through an ``mbarrier``
  ring, where both operands start 16-byte aligned and ``K`` and ``N`` are
  multiples of 8 (TMA's 16-byte stride rule);
* ``"mma"`` — bfloat16 on warp-level ``mma.sync``, any shape and alignment;
* ``"fma"`` — float32 on the CUDA cores, never TF32.

The route is chosen before the launch, never after a failure.
``matmul.launches`` counts kernel launches and nothing else;
``matmul.launches_by_route`` splits them by route.
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import DTYPE_CODES, INT, PTR, function, launch, operands

matmul_ref = ref.matmul              # the plain version
# the launcher's route argument
ROUTE_CODES = {"fma": 0, "mma": 1, "wgmma": 2}


def matmul_route(M: int, N: int, K: int, dtype, a_ptr: int,
                 b_ptr: int) -> str:
    """The kernel that takes A [M, K] @ B [K, N] of ``dtype`` whose data
    start at ``a_ptr`` and ``b_ptr``."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise ValueError(f"matmul: no kernel takes {dtype}")
    if a_ptr % 16 == 0 and b_ptr % 16 == 0 and K % 8 == 0 and N % 8 == 0:
        return "wgmma"
    return "mma"


def launcher():
    """``matmul_launch`` of ``csrc/matmul.cu``: (a, b, c, M, N, K, dtype
    code, route code, stream); it returns cudaErrorInvalidValue for a route
    whose preconditions fail."""
    return function("matmul", "matmul_launch", [PTR] * 3 + [INT] * 5)


def matmul(a, b, *, bm: int = 256, bn: int = 256, bk: int = 256):
    """C[M,N] = A[M,K] @ B[K,N], float32 accumulation rounded once to A's
    dtype. ``bm``/``bn``/``bk`` are the TPU kernel's tiles and must divide
    the dims, as there; the CUDA kernels' own tiling does not depend on
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
    route = matmul_route(M, N, K, a.dtype, a.data_ptr(), b.data_ptr())
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    launch("matmul", launcher(), a.device, a.data_ptr(), b.data_ptr(),
           out.data_ptr(), M, N, K, code, ROUTE_CODES[route])
    matmul.launches += 1
    matmul.launches_by_route[route] += 1
    return out


matmul.launches = 0
matmul.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
