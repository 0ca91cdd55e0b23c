"""Mamba2 SSD chunk scan (G = 1): the Hopper kernel, its plain version and the
wrapper.

The counterpart of the JAX package's ``kernels/ssm_scan.py`` (``ssm_scan``,
``:56``; ``pallas_call`` at ``:75``), the per-(batch, head) slice of
``models/mamba2.ssd_chunked`` with one B/C group. One addition to the TPU
kernel: ``ssm_chunk_scan`` takes an initial state and returns the final one,
which ``ssd_chunked`` hands to decode; ``ssm_scan`` returns ``y`` alone, as the
reference's does.

* ``ssm_chunk_scan`` — the wrapper. For a tensor on the CPU it runs the plain
  version; for a CUDA tensor it launches the CUDA kernel
  (``csrc/ssm_scan.cu``) or raises. ``ssm_scan.launches`` counts kernel
  launches, and nothing else.
* ``ssm_chunk_scan_ref`` — the plain version, ``kernels.ref.ssm_chunk_scan``
  (the state recurrence one step at a time, in float32).
"""
from __future__ import annotations

import torch

from . import ref
from ._cuda import DTYPE_CODES, INT, PTR, function, launch, operands

MAX_DIM = 128                   # P and N

ssm_chunk_scan_ref = ref.ssm_chunk_scan         # the plain version


def _launch_cuda(x, dt, A, Bm, Cm, h0):
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssm_scan: head dim {P} and state dim {N} must be "
                         f"<= {MAX_DIM}")
    code = operands("ssm_scan", DTYPE_CODES, x, Bm, Cm)
    f32 = {torch.float32: 0}
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    operands("ssm_scan (dt, A)", f32, dt, A)
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
        operands("ssm_scan (h0)", f32, h0)
        if tuple(h0.shape) != (B, H, P, N):
            raise ValueError(f"ssm_scan: h0 {tuple(h0.shape)} != "
                             f"{(B, H, P, N)}")
    for t in (dt, A, Bm, Cm):
        if t.device != x.device:
            raise ValueError(f"ssm_scan: every operand must be on {x.device}")
    y = torch.empty_like(x)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    fn = function("ssm_scan", "ssm_scan_launch", [PTR] * 8 + [INT] * 6)
    launch("ssm_scan", fn, x.device, x.data_ptr(), dt.data_ptr(),
           A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
           h0.data_ptr() if h0 is not None else None, y.data_ptr(),
           h.data_ptr(), B, S, H, P, N, code)
    ssm_scan.launches += 1
    return y, h


def ssm_chunk_scan(x, dt, A, Bm, Cm, *, chunk: int = 128, h0=None):
    """x [B,S,H,P]; dt [B,S,H]; A [H]; Bm/Cm [B,S,N] (G = 1); ``h0``
    [B,H,P,N] or None (zeros). Returns (y [B,S,H,P] in x's dtype, final
    state [B,H,P,N] float32). ``chunk`` is the TPU kernel's and must divide
    S, as there (``min(chunk, S)``); the CUDA kernel walks its own chunks."""
    B, S, H, P = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssm_scan: S = {S} must divide by chunk {chunk}")
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,) \
            or Bm.shape != Cm.shape or tuple(Bm.shape[:2]) != (B, S) \
            or Bm.dim() != 3:
        raise ValueError(f"ssm_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if x.device.type == "cpu":
        return ssm_chunk_scan_ref(x, dt, A, Bm, Cm, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan has no kernel for {x.device}")
    return _launch_cuda(x, dt, A, Bm, Cm, h0)


def ssm_scan(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """The registry's entry, as the reference's: y [B,S,H,P] alone."""
    return ssm_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk)[0]


ssm_scan.launches = 0
