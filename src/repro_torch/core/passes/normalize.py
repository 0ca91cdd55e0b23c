"""Canonicalization pass.

This pass is the reason the paper's claim C1 holds mechanically: frontends may emit
cosmetically different node arrangements for the same parallel semantics (OpenACC's
``gang``/``vector`` vs OpenMP's ``teams``/``simd``, CUDA's grid/block vs ``num_teams``/
``num_units``); after normalization, semantically-identical programs are structurally
``==``.

Canonical form:
  * ``distribute("teams"|"units"|"teams,units")`` resolved to concrete mesh axis names
    using the enclosing SpmdRegion's MeshSpec;
  * data attribute lists sorted by symbol, defaults materialized;
  * degenerate loop-parallel entries dropped (e.g. worksharing over a size-1 axis);
  * sync axes default to all unit axes when unspecified;
  * ``cyclic`` distribution patterns rewritten to ``block`` with a recorded extension
    (TPU/XLA shards block-contiguously; see DESIGN.md §2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .. import ir


def normalize(prog: ir.Program) -> ir.Program:
    mesh = _find_mesh(prog)

    def fix(node):
        if isinstance(node, ir.SpmdRegion):
            return dataclasses.replace(
                node,
                data=tuple(sorted((_fix_data(d) for d in node.data),
                                  key=lambda d: d.symbol)),
                sync=tuple(_fix_sync(s, mesh) for s in node.sync))
        if isinstance(node, ir.LoopNode):
            par = tuple(p for p in (_fix_parallel(p, mesh) for p in node.parallel)
                        if p is not None)
            return dataclasses.replace(
                node, parallel=par,
                data=tuple(sorted((_fix_data(d) for d in node.data),
                                  key=lambda d: d.symbol)),
                sync=tuple(_fix_sync(s, mesh) for s in node.sync))
        if isinstance(node, ir.TaskNode):
            return dataclasses.replace(
                node,
                data=tuple(sorted((_fix_data(d) for d in node.data),
                                  key=lambda d: d.symbol)),
                sync=tuple(_fix_sync(s, mesh) for s in node.sync))
        if isinstance(node, ir.SyncOp):
            return _fix_sync(node, mesh)
        if isinstance(node, ir.DataAttr):
            return _fix_data(node)
        return node

    return ir.map_nodes(prog, fix)


def _find_mesh(prog) -> Optional[ir.MeshSpec]:
    for n in ir.walk(prog):
        if isinstance(n, ir.SpmdRegion):
            return n.mesh
    return None


def _fix_data(d: ir.DataAttr) -> ir.DataAttr:
    dist = []
    changed = False
    for dd in d.distribution:
        if dd.pattern == "cyclic":
            dist.append(dataclasses.replace(dd, pattern="block"))
            changed = True
        else:
            dist.append(dd)
    dist = tuple(sorted(dist))
    if changed:
        return d.with_(distribution=dist,
                       extensions=ir.ext_set(d.extensions, cyclic_lowered_as_block=True))
    if dist != d.distribution:
        return d.with_(distribution=dist)
    return d


def _fix_sync(s: ir.SyncOp, mesh: Optional[ir.MeshSpec]) -> ir.SyncOp:
    if not s.axes and mesh is not None and s.name not in ("taskwait", "critical",
                                                          "atomic", "single"):
        # a sync inside an SPMD region defaults to all its execution units
        axes = tuple(dict.fromkeys(mesh.teams + mesh.units))
        s = s.with_(axes=axes)
    # reduction with all participants == allreduce semantics; canonicalize the name
    if s.name == "reduction" and s.primary == "unit:*":
        s = s.with_(name="allreduce")
    return s


def _fix_parallel(p, mesh: Optional[ir.MeshSpec]):
    if isinstance(p, ir.Worksharing):
        axis = p.axis
        if not axis and mesh is not None:
            if p.distribute == "teams":
                axes = mesh.teams
            elif p.distribute == "units":
                axes = mesh.units
            else:  # "teams,units": workshared over the whole hierarchy
                axes = tuple(dict.fromkeys(mesh.teams + mesh.units))
            axis = "+".join(axes)
        if mesh is not None and axis:
            try:
                sizes = [mesh.size(a) for a in axis.split("+")]
                if all(s == 1 for s in sizes):
                    return None  # degenerate: worksharing over a single unit
            except KeyError:
                pass
        if p.schedule in ("runtime", "auto"):
            p = dataclasses.replace(p, schedule="static")
        return dataclasses.replace(p, axis=axis, distribute=_canon_level(axis, mesh)
                                   if mesh else p.distribute)
    if isinstance(p, ir.Simd):
        simdlen = p.simdlen or 128
        return dataclasses.replace(p, simdlen=simdlen)
    if isinstance(p, ir.Taskloop):
        if p.grainsize == 0 and p.num_tasks == 0:
            return dataclasses.replace(p, num_tasks=1)
        return p
    return p


def _canon_level(axis: str, mesh: ir.MeshSpec) -> str:
    parts = set(axis.split("+")) if axis else set()
    in_teams = bool(parts & set(mesh.teams))
    in_units = bool(parts & set(mesh.units))
    if in_teams and in_units:
        return "teams,units"
    if in_teams:
        return "teams"
    return "units"
