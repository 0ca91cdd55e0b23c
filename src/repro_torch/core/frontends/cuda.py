"""CUDA-style frontend (paper §6.1, Figs 11-12).

A CUDA kernel launch ``axpy_kernel<<<grid, block>>>(x, y, a, n)`` is, in UPIR
terms, an offloading task wrapping a perfectly-nested SPMD region (grid = teams,
block = units) whose body is the canonical loop the kernel's thread-index
arithmetic implements::

    prog = cuda.launch(
        name="axpy", kernel="axpy", grid=(B,), block=(T,),
        args=("a", "x", "y"), extent=("i", "n"),
        reads=("a", "x"), writes=("y",), symbols={...})

The paper notes "the task and spmd IRs are always perfectly nested since they are
converted from one CUDA kernel call" — `launch` enforces exactly that shape, and
normalization makes the result identical to the OpenMP/OpenACC frontends' output
for the same semantics.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import math

from .. import ir
from ..builder import PlanBuilder
from ..passes import normalize


def launch(name: str, *, kernel: str, grid: Tuple[int, ...], block: Tuple[int, ...],
           args: Sequence[str] = (), extent: Tuple[str, Any] = ("i", "n"),
           reads: Sequence[str] = (), writes: Sequence[str] = (),
           read_writes: Sequence[str] = (),
           symbols: Optional[Dict[str, Tuple[Optional[Tuple[int, ...]], str]]] = None,
           device: int = -1, stream_async: bool = False) -> ir.Program:
    """``kernel<<<grid, block>>>(args)`` -> task{ spmd{ loop{ kernel } } }."""
    num_teams = math.prod(grid)
    num_units = math.prod(block)

    b = PlanBuilder(name).target("tpu")
    b.mesh(axes=(("teams", num_teams), ("units", num_units)),
           teams=("teams",), units=("units",))

    # CUDA has no map clauses: memory residency is explicit (cudaMemcpy/cudaMalloc).
    # The paper's UPIR for CUDA (Fig. 12) still records data usage on the task/spmd;
    # `reads`/`writes` declare it (derived from kernel signature analysis in ROSE).
    for sym in reads:
        b.data(sym, mapping="to", access="read-only")
    for sym in writes:
        b.data(sym, mapping="from", access="write-only")
    for sym in read_writes:
        b.data(sym, mapping="tofrom", access="read-write")
    if symbols:
        for s, (shape, dt) in symbols.items():
            b.symbol(s, shape, dt)

    induction, upper = extent
    # blockDim.x * blockIdx.x + threadIdx.x sweeping 0..n == a canonical loop
    # workshared over both SPMD levels with a static schedule.
    b.loop(induction, upper,
           parallel=(ir.Worksharing(schedule="static", distribute="teams,units"),))
    b.kernel(kernel, args)
    prog = b.build()
    if stream_async:
        prog = prog.with_(extensions=ir.ext_set(prog.extensions, stream_async=True))
    return normalize(prog)


def memcpy(prog: ir.Program, symbol: str, direction: str,
           is_async: bool = False) -> ir.Program:
    """cudaMemcpy(Async) — explicit MoveOp prepended to the task body (§4.2)."""
    import dataclasses

    def fix(node):
        if isinstance(node, ir.TaskNode):
            mv = ir.MoveOp(symbol=symbol, direction=direction, is_async=is_async)
            return dataclasses.replace(node, body=(mv,) + node.body)
        return node

    return ir.map_nodes(prog, fix)
