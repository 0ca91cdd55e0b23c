"""Flash attention (forward): the Hopper kernel, its plain version and the
wrapper.

The counterpart of the JAX package's ``kernels/flash_attention.py``
(``flash_attention``, ``:67``; ``pallas_call`` at ``:80``): attention over
``[B, S, H, hd]`` with equal query and key/value head counts (GQA expanded
upstream), scale ``1/sqrt(hd)``, causal or not, an online softmax in float32.
One addition to the TPU kernel: an optional sliding ``window``, so the model's
windowed prefill attention runs the kernel at every length.

* ``flash_attention`` — the wrapper. For a tensor on the CPU it runs the plain
  version; for a CUDA tensor it launches the CUDA kernel
  (``csrc/flash_attention.cu``) that :func:`flash_route` names for its dtype,
  or raises. ``flash_attention.launches`` counts kernel launches, and nothing
  else; ``flash_attention.launches_by_route`` splits them by route.
* ``flash_route`` — the kernel a dtype takes: bfloat16 the tensor-core kernel
  (``"mma"``: ``mma.sync``, P split into two bf16 terms), float32 the
  CUDA-core kernel (``"fma"``), whose float32 arithmetic the float32
  tolerance needs.
* ``flash_attention_ref`` — the plain version, ``kernels.ref.flash_attention``.
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._cuda import DTYPE_CODES, FLOAT, INT, PTR, function, launch, operands

MAX_HEAD_DIM = 128
# the launcher's route argument
ROUTE_CODES = {"fma": 0, "mma": 1}

flash_attention_ref = ref.flash_attention       # the plain version


def flash_route(dtype) -> str:
    """The CUDA kernel that takes ``dtype``: ``"mma"`` (tensor cores) for
    bfloat16, ``"fma"`` (CUDA cores) for float32."""
    if dtype == torch.bfloat16:
        return "mma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"flash_attention: no kernel takes {dtype}")


def launcher():
    """``flash_attention_launch`` of ``csrc/flash_attention.cu``: (q, k, v,
    out, B, S, H, hd, scale, causal, window, dtype code, route code,
    stream); it returns cudaErrorInvalidValue for a route whose dtype does
    not match."""
    return function("flash_attention", "flash_attention_launch",
                    [PTR] * 4 + [INT] * 4 + [FLOAT] + [INT] * 4)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 256,
                    bk: int = 256, window: int = 0):
    """q/k/v: [B, S, H, hd] (same head count). Returns [B, S, H, hd] in q's
    dtype. ``bq``/``bk`` are the TPU kernel's tiles and must divide S, as
    there; the CUDA kernel's own tiling does not depend on them. ``window``
    > 0 keeps only the keys ``kpos > qpos - window``."""
    B, S, H, hd = q.shape
    bq, bk = min(bq, S), min(bk, S)
    if S % bq or S % bk:
        raise ValueError(f"flash_attention: S = {S} must divide by the tiles "
                         f"({bq}, {bk})")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must be equal "
                         f"(expand GQA upstream)")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    code = operands("flash_attention", DTYPE_CODES, q, k, v)
    route = flash_route(q.dtype)
    out = torch.empty_like(q)
    launch("flash_attention", launcher(), q.device, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), B, S, H, hd, 1.0 / math.sqrt(hd),
           int(bool(causal)), int(window), code, ROUTE_CODES[route])
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTE_CODES, 0)
