"""Plain PyTorch oracles of the paper's kernels (the port's ``ref.py``).

The ground truth each CUDA kernel is held against, and the lowering targets
of the UPIR ``worksharing`` backend (the kernels are the ``simd`` backend).
Dtype rules follow the JAX package's ``kernels/ref.py``: products accumulate
in float32 and round once to the input dtype. The oracles of
``flash_attention`` and ``ssm_chunk_scan`` come with their kernels
(ROADMAP Q2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def axpy(a, x, y):
    """``a * x + y`` (the paper's AXPY, Fig. 8); ``a`` is cast to ``x``'s
    dtype, and the product rounds before the sum, as two separate ops."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    return a * x + y


def matmul(a, b):
    """C = A @ B (the paper's matrix multiplication kernel), float32
    accumulation."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def matvec(a, x):
    """y = A @ x (the paper's matrix-vector kernel), float32 accumulation."""
    return torch.mv(a.float(), x.float()).to(a.dtype)


def stencil2d(u, w_center: float = -4.0, w_side: float = 1.0):
    """5-point 2-D stencil with a zero boundary (the paper's stencil kernel):

    out[i,j] = w_c*u[i,j] + w_s*(((u[i-1,j] + u[i+1,j]) + u[i,j-1]) + u[i,j+1])
    """
    up = F.pad(u, (1, 1, 1, 1))
    return (w_center * u
            + w_side * (up[:-2, 1:-1] + up[2:, 1:-1]
                        + up[1:-1, :-2] + up[1:-1, 2:])).to(u.dtype)


def error_bound(kernel: str, args, want):
    """Elementwise bound on ``|kernel - oracle|`` on the card, float32.

    * float32 ``axpy`` and ``stencil2d``: 0 — the kernels round each op as
      the oracle does (no fused multiply-add), so they agree bit for bit.
    * float32 ``matvec`` / ``matmul``: ``2^-20 * (|A| @ |x|)``, 16 float32
      ulps of each output's absolute sum: summation order (the kernel's
      against cuBLAS's) moves a sum by far less, while one term lost or
      counted twice moves it by about an average ``|a x|``, far more.
    * bfloat16 adds one rounding of the output: ``2^-7 * |want|``.
    """
    bf16 = want.dtype == torch.bfloat16
    if kernel in ("axpy", "stencil2d"):
        return 2.0 ** -7 * want.float().abs() if bf16 else 0.0
    a, b = args[0].float().abs(), args[1].float().abs()
    bound = 2.0 ** -20 * (torch.mv(a, b) if kernel == "matvec" else a @ b)
    return bound + 2.0 ** -7 * want.float().abs() if bf16 else bound
