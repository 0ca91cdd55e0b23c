"""Binding and launch of the port's CUDA kernels through their plain C
interface (``ctypes``): argument types, operand checks, the stream, and the
error code each launcher returns. Nothing here runs at import time."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from .build import library

PTR, INT, LONG, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
# dtype codes of the launchers' ``dtype`` argument
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def function(lib: str, symbol: str, argtypes: Sequence):
    """``symbol`` of ``csrc/<lib>.cu``'s library with its argument types set;
    the last argument of every launcher is the CUDA stream. ctypes keeps one
    function object per library, so the types are set once."""
    fn = getattr(library(lib), symbol)
    if not fn.argtypes:
        fn.argtypes = list(argtypes) + [PTR]
        fn.restype = ctypes.c_int
    return fn


def operands(what: str, dtypes: Dict[torch.dtype, int], *tensors) -> int:
    """Check that ``tensors`` lie contiguous on one CUDA device in one dtype
    the kernel takes; returns that dtype's launcher code."""
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"{what}: every operand must be on "
                             f"{first.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.dtype != first.dtype or t.dtype not in dtypes:
            raise ValueError(f"{what}: dtypes {[x.dtype for x in tensors]}; "
                             f"the kernel takes one of {list(dtypes)}")
    return dtypes[first.dtype]


def launch(what: str, fn, device, *args) -> None:
    """Call a launcher on the current stream of ``device``; raise on the
    CUDA error it returns (a refused launch never runs, and a later
    synchronize would not report it)."""
    err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
