"""OpenMP-style frontend.

Mirrors the directive stack of the paper's Fig. 8 (top)::

    #pragma omp target teams distribute parallel for \
        map(to: x[0:n], a) map(tofrom: y[0:n]) num_teams(B) thread_limit(T)
    for (i = 0; i < n; i++) y[i] += a * x[i];

expressed as::

    prog = omp.target(
        omp.teams(num_teams=B, thread_limit=T),
        omp.distribute_parallel_for(schedule=("static", 0)),
        loop=omp.for_loop("i", "n"),
        kernel="axpy", args=("a", "x", "y"),
        map_to=("a", "x"), map_tofrom=("y",),
        symbols={...}, name="axpy")
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

from .. import ir
from ..builder import PlanBuilder
from ..passes import normalize


@dataclasses.dataclass(frozen=True)
class teams:
    num_teams: int
    thread_limit: int = 256


@dataclasses.dataclass(frozen=True)
class distribute_parallel_for:
    schedule: Tuple[str, int] = ("static", 0)


@dataclasses.dataclass(frozen=True)
class parallel_for:
    num_threads: int = 0
    schedule: Tuple[str, int] = ("static", 0)


@dataclasses.dataclass(frozen=True)
class simd:
    simdlen: int = 128


@dataclasses.dataclass(frozen=True)
class taskloop:
    grainsize: int = 0
    num_tasks: int = 0


@dataclasses.dataclass(frozen=True)
class for_loop:
    induction: str
    upper: Any
    lower: Any = 0
    step: Any = 1
    collapse: int = 1


def target(*directives, loop: for_loop, kernel: str, args: Sequence[str] = (),
           map_to: Sequence[str] = (), map_from: Sequence[str] = (),
           map_tofrom: Sequence[str] = (), map_alloc: Sequence[str] = (),
           symbols: Optional[Dict[str, Tuple[Optional[Tuple[int, ...]], str]]] = None,
           device: str = "tpu", name: str = "kernel",
           reductions: Sequence[Tuple[str, str]] = ()) -> ir.Program:
    """`#pragma omp target ...` — offloading task wrapping an SPMD region."""
    b = PlanBuilder(name).target(device)

    t = next((d for d in directives if isinstance(d, teams)), teams(1, 256))
    b.mesh(axes=(("teams", t.num_teams), ("units", t.thread_limit)),
           teams=("teams",), units=("units",))

    for sym in map_to:
        b.data(sym, mapping="to", access="read-only")
    for sym in map_from:
        b.data(sym, mapping="from", access="write-only")
    for sym in map_tofrom:
        b.data(sym, mapping="tofrom", access="read-write")
    for sym in map_alloc:
        b.data(sym, mapping="allocate", access="read-write")
    if symbols:
        for s, (shape, dt) in symbols.items():
            b.symbol(s, shape, dt)

    parallel: list = []
    for d in directives:
        if isinstance(d, distribute_parallel_for):
            parallel.append(ir.Worksharing(schedule=d.schedule[0], chunk=d.schedule[1],
                                           distribute="teams,units"))
        elif isinstance(d, parallel_for):
            parallel.append(ir.Worksharing(schedule=d.schedule[0], chunk=d.schedule[1],
                                           distribute="units"))
        elif isinstance(d, simd):
            parallel.append(ir.Simd(simdlen=d.simdlen))
        elif isinstance(d, taskloop):
            parallel.append(ir.Taskloop(grainsize=d.grainsize, num_tasks=d.num_tasks))

    syncs = tuple(
        ir.SyncOp(name="reduction", operation=op, data=(sym,))
        for op, sym in reductions)
    b.loop(loop.induction, loop.upper, lower=loop.lower, step=loop.step,
           collapse=loop.collapse, parallel=parallel, sync=syncs)
    b.kernel(kernel, args)
    return normalize(b.build())


def barrier_after(prog: ir.Program) -> ir.Program:
    """`#pragma omp barrier` appended to the SPMD region (for sync-elim demos)."""
    def fix(node):
        if isinstance(node, ir.SpmdRegion):
            return dataclasses.replace(
                node, sync=node.sync + (ir.SyncOp(name="barrier",
                                                  axes=node.mesh.units),))
        return node
    return ir.map_nodes(prog, fix)
