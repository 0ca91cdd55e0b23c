"""Plain PyTorch oracles of the kernels (the port's ``ref.py``).

The ground truth each CUDA kernel is held against, and the lowering targets
of the UPIR ``worksharing`` backend (the kernels are the ``simd`` backend);
the counterpart of the JAX package's ``kernels/ref.py``. Dtype rules follow
it: matrix products accumulate in float32 and round once to the input
dtype; the elementwise kernels (axpy, stencil2d) compute in the input dtype.
"""
from __future__ import annotations

import math

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

    computed in ``u``'s dtype, as the JAX package's oracle: a bfloat16 ``u``
    rounds after every multiply and add.
    """
    up = F.pad(u, (1, 1, 1, 1))
    return (w_center * u
            + w_side * (up[:-2, 1:-1] + up[2:, 1:-1]
                        + up[1:-1, :-2] + up[1:-1, 2:])).to(u.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Plain-softmax attention oracle (``src/repro/kernels/ref.py:40``).
    q/k/v: [B, S, H, hd] (same head count); float32 scores, probabilities
    and sums, the output rounded once to q's dtype. ``window`` > 0 keeps only
    the keys ``kpos > qpos - window``, as the model's ``attention_full``
    does (the reference's oracle has no window)."""
    B, S, H, hd = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / math.sqrt(hd)
    if causal or window:
        pos = torch.arange(S, device=q.device)
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        if window:
            mask &= pos[None, :] > pos[:, None] - window
        scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def ssm_chunk_scan(x, dt, A, Bm, Cm, h0=None):
    """Sequential SSD oracle (``src/repro/kernels/ref.py:53``): the state
    recurrence one step at a time, in float32.

    x [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,N] (G = 1); ``h0`` [B,H,P,N]
    (zeros by default). Returns (y [B,S,H,P] in x's dtype, h_final
    [B,H,P,N] float32).
    """
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    A = A.float()
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                              # [B,H]
        decay = torch.exp(dtt * A)
        h = decay[..., None, None] * h + torch.einsum(
            "bn,bhp->bhpn", Bm[:, t].float(),
            x[:, t].float() * dtt[..., None])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h


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
