"""The paper's four kernels as UPIR programs, written in each frontend.

:func:`frontend_programs` writes one kernel call the way the OpenMP, OpenACC
and CUDA frontends each express it (paper Figs. 8 and 11-12):

* ``omp``: ``#pragma omp target teams distribute parallel for [simd]``;
* ``acc``: ``#pragma acc parallel loop gang vector``, with the loop's
  ``vector(simdlen)`` level attached by ``acc.simd_level`` for ``simd``;
* ``cuda``: ``kernel<<<grid, block>>>(...)``. A CUDA launch has no simd
  clause of its own; its warp-level vector parallelism is attached by the
  same UPIR transform (``simd_level``), which only edits the IR.

After normalization the three programs are equal (the paper's claim C1), and
:func:`repro_torch.kernels.ops.lower_kernel_program` lowers them alike.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ..core.frontends import acc, cuda, omp

UNITS = 256                  # threads per block / OpenMP thread limit
SIMDLEN = 32                 # one warp

# kernel -> (args, read-only, write-only, read-write), as in the paper's
# listings (AXPY updates y in place)
SIGNATURES = {
    "axpy": (("a", "x", "y"), ("a", "x"), (), ("y",)),
    "matvec": (("a", "x", "y"), ("a", "x"), ("y",), ()),
    "stencil2d": (("u", "out"), ("u",), ("out",), ()),
    "matmul": (("a", "b", "c"), ("a", "b"), ("c",), ()),
}


def symbols_of(kernel: str, operands) -> Dict[str, Tuple[tuple, str]]:
    """UPIR symbol table ``{name: (shape, dtype)}`` of the operands passed
    to a call (tensors, or a Python scalar for AXPY's ``a``), named in
    argument order; an output the call allocates has no entry."""
    args = SIGNATURES[kernel][0]
    syms = {}
    for name, t in zip(args, operands):
        if hasattr(t, "shape"):
            syms[name] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
        else:
            syms[name] = ((), "float32")
    return syms


def frontend_programs(kernel: str, symbols, extent: int, *,
                      simd: bool) -> Dict[str, object]:
    """The program of one ``kernel`` call over the outer loop ``0 <= i <
    extent`` in each frontend: ``{"omp": ..., "acc": ..., "cuda": ...}``.
    ``simd`` adds the simd level that lowers the kernel to the CUDA backend;
    without it the loop is only workshared and lowers to the oracle."""
    args, reads, writes, read_writes = SIGNATURES[kernel]
    teams = max(-(-extent // UNITS), 1)
    p_omp = omp.target(
        omp.teams(num_teams=teams, thread_limit=UNITS),
        omp.distribute_parallel_for(),
        *((omp.simd(simdlen=SIMDLEN),) if simd else ()),
        loop=omp.for_loop("i", extent), kernel=kernel, args=args,
        map_to=reads, map_from=writes, map_tofrom=read_writes,
        symbols=symbols, name=kernel)
    p_acc = acc.parallel_loop(
        kernel, num_gangs=teams, vector_length=UNITS, gang=True, vector=True,
        copyin=reads, copyout=writes, copy=read_writes, loop=("i", extent),
        kernel=kernel, args=args, symbols=symbols)
    p_cuda = cuda.launch(
        kernel, kernel=kernel, grid=(teams,), block=(UNITS,), args=args,
        extent=("i", extent), reads=reads, writes=writes,
        read_writes=read_writes, symbols=symbols)
    if simd:
        p_acc = acc.simd_level(p_acc, SIMDLEN)
        p_cuda = acc.simd_level(p_cuda, SIMDLEN)
    return {"omp": p_omp, "acc": p_acc, "cuda": p_cuda}
