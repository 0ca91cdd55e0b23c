"""OpenACC-style frontend.

Mirrors the paper's Fig. 8 (bottom)::

    #pragma acc parallel loop gang vector copyin(x[0:n], a) copy(y[0:n]) \
        num_gangs(B) vector_length(T)
    for (i = 0; i < n; i++) y[i] += a * x[i];

expressed as::

    prog = acc.parallel_loop(
        name="axpy", num_gangs=B, vector_length=T,
        gang=True, vector=True,
        copyin=("a", "x"), copy=("y",),
        loop=("i", "n"), kernel="axpy", args=("a", "x", "y"), symbols={...})

OpenACC's gang/worker/vector levels map onto the same teams x units hierarchy that
OpenMP's teams/threads map onto — after normalization the two frontends' output is
structurally identical (paper Fig. 9).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from .. import ir
from ..builder import PlanBuilder
from ..passes import normalize


def parallel_loop(name: str, *, num_gangs: int, vector_length: int = 256,
                  num_workers: int = 0,
                  gang: bool = False, worker: bool = False, vector: bool = False,
                  seq: bool = False,
                  copyin: Sequence[str] = (), copyout: Sequence[str] = (),
                  copy: Sequence[str] = (), create: Sequence[str] = (),
                  loop: Tuple[str, Any] = ("i", "n"),
                  collapse: int = 1,
                  kernel: str = "kernel", args: Sequence[str] = (),
                  symbols: Optional[Dict[str, Tuple[Optional[Tuple[int, ...]],
                                                    str]]] = None,
                  device: str = "tpu",
                  reductions: Sequence[Tuple[str, str]] = (),
                  wait: bool = False, is_async: bool = False) -> ir.Program:
    """`#pragma acc parallel loop ...` — one combined construct, like the paper's AXPY."""
    b = PlanBuilder(name).target(device)
    b.mesh(axes=(("teams", num_gangs), ("units", vector_length)),
           teams=("teams",), units=("units",))

    for sym in copyin:
        b.data(sym, mapping="to", access="read-only")
    for sym in copyout:
        b.data(sym, mapping="from", access="write-only")
    for sym in copy:
        b.data(sym, mapping="tofrom", access="read-write")
    for sym in create:
        b.data(sym, mapping="allocate", access="read-write")
    if symbols:
        for s, (shape, dt) in symbols.items():
            b.symbol(s, shape, dt)

    parallel: list = []
    if gang and (vector or worker):
        parallel.append(ir.Worksharing(distribute="teams,units"))
    elif gang:
        parallel.append(ir.Worksharing(distribute="teams"))
    elif vector or worker:
        parallel.append(ir.Worksharing(distribute="units"))
    # acc `vector(length)` on its own loop level == simd in UPIR terms is expressed
    # by an explicit vector_simdlen extension via simd_level()

    syncs = tuple(
        ir.SyncOp(name="reduction", operation=op, data=(sym,))
        for op, sym in reductions)
    if wait:
        syncs = syncs + (ir.SyncOp(name="barrier"),)

    induction, upper = loop
    b.loop(induction, upper, collapse=collapse, parallel=parallel, sync=syncs)
    b.kernel(kernel, args)
    prog = b.build()
    return normalize(prog)


def simd_level(prog: ir.Program, simdlen: int) -> ir.Program:
    """Attach `vector(simdlen)` as an inner simd parallelization of the loop."""
    import dataclasses

    def fix(node):
        if isinstance(node, ir.LoopNode):
            return dataclasses.replace(
                node, parallel=node.parallel + (ir.Simd(simdlen=simdlen),))
        return node

    return normalize(ir.map_nodes(prog, fix))
