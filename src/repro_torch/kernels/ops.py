"""The UPIR kernel registry of the port, and the lowering of a kernel program.

A kernel program's loop names its parallelization apart from the loop
itself. A loop that carries a ``Simd`` parallelization resolves its
``KernelOp.fn`` to the hand-written CUDA kernel (backend ``cuda``); a loop
that is only ``Worksharing``-parallelized resolves to the plain PyTorch
oracle (backend ``reference``). That is the paper's separation of the
canonical loop from its parallelization strategy, made executable, as in the
JAX package's ``kernels/ops.py`` (whose ``simd`` backend is Pallas).
"""
from __future__ import annotations

from typing import Callable, Dict

from ..core import ir
from . import ref
from .axpy import axpy
from .flash_attention import flash_attention
from .matmul import matmul
from .matvec import matvec
from .ssm_scan import ssm_scan
from .stencil2d import stencil2d

SIMD: Dict[str, Callable] = {
    "axpy": axpy,
    "matmul": matmul,
    "matvec": matvec,
    "stencil2d": stencil2d,
    "flash_attention": flash_attention,
    "ssm_scan": ssm_scan,
}

# the reference's REFERENCE table has no ssm_scan (src/repro/kernels/ops.py),
# so resolve("ssm_scan", "reference") raises a KeyError here as there
REFERENCE: Dict[str, Callable] = {
    "axpy": ref.axpy,
    "matmul": ref.matmul,
    "matvec": ref.matvec,
    "stencil2d": ref.stencil2d,
    "flash_attention": ref.flash_attention,
}

BACKENDS = {"cuda": SIMD, "reference": REFERENCE}


def resolve(fn: str, backend: str = "reference") -> Callable:
    """UPIR ``KernelOp`` resolution: ``cuda`` (simd) or ``reference``
    (worksharing)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend '{backend}' is not one of "
                         f"{sorted(BACKENDS)}")
    table = BACKENDS[backend]
    if fn not in table:
        raise KeyError(f"kernel '{fn}' not registered for backend "
                       f"'{backend}': it registers {sorted(table)}")
    return table[fn]


def lower_kernel_program(prog: ir.Program) -> Callable:
    """The callable of a UPIR program's one ``KernelOp``: its innermost
    enclosing loop's parallelization picks the backend (``Simd`` ->
    ``cuda``, otherwise ``Worksharing`` -> ``reference``). Only the IR is
    read, so programs from any frontend that normalize equal lower alike."""
    kernels = ir.find_all(prog, ir.KernelOp)
    if len(kernels) != 1:
        raise ValueError(f"program '{prog.name}' has {len(kernels)} kernel "
                         f"ops; a kernel program has one")
    loops = [n for n in ir.walk(prog) if isinstance(n, ir.LoopNode)
             and any(k is kernels[0] for k in ir.walk(n))]
    if not loops:
        raise ValueError(f"program '{prog.name}': the kernel is in no loop")
    parallel = loops[-1].parallel
    if any(isinstance(p, ir.Simd) for p in parallel):
        return resolve(kernels[0].fn, "cuda")
    if any(isinstance(p, ir.Worksharing) for p in parallel):
        return resolve(kernels[0].fn, "reference")
    raise ValueError(f"program '{prog.name}': loop parallelization "
                     f"{parallel} lowers to neither simd nor worksharing")
