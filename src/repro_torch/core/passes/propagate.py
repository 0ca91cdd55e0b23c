"""Data-attribute completion — the paper's "data analysis module" (§6, Fig. 7).

GIMPLE's weakness called out in §2.1 is that it only carries what the user wrote;
every optimization pass re-derives the rest. UPIR instead *completes* the data
attributes once, in the IR. Here that means: for every symbol in the program's
symbol table (a flattened param/input pytree with shapes and dtypes), materialize a
full six-field ``DataAttr``, including a concrete, divisibility-checked distribution.

Distribution rules come from the planner as a Program extension ``dist_rules``:

    dist_rules = (
        (glob_pattern, ((dim, axis), (dim, axis), ...)),   # candidates, in order
        ...
    )

A candidate ``(dim, axis)`` is accepted iff the tensor has that dim, its size is
divisible by the mesh-axis size, the dim is not yet distributed, and the axis is not
yet used by this tensor. This is how the same rule set serves every architecture:
e.g. vocab-dim sharding applies to llama3 (128256 % 16 == 0) but falls through to
d_model-dim sharding for granite (49155 is odd) — recorded per-attr as an extension.
"""
from __future__ import annotations

import dataclasses
from fnmatch import fnmatch
from typing import Dict, Optional, Tuple

from .. import ir


def propagate_data_attrs(prog: ir.Program) -> ir.Program:
    mesh = None
    for n in ir.walk(prog):
        if isinstance(n, ir.SpmdRegion):
            mesh = n.mesh
            break
    if mesh is None:
        return prog

    symtab = prog.symbol_table()
    dist_rules = ir.ext_get(prog.extensions, "dist_rules", ())
    access_rules = ir.ext_get(prog.extensions, "access_rules", ())

    def complete(attr: ir.DataAttr) -> ir.DataAttr:
        shape, _dtype = symtab.get(attr.symbol, (None, None))
        if not attr.distribution and shape is not None:
            dist, notes = _apply_rules(attr.symbol, shape, mesh, dist_rules)
            if dist:
                attr = attr.with_(distribution=dist)
            if notes:
                attr = attr.with_(extensions=ir.ext_set(attr.extensions, **notes))
        if attr.access == "read-write":
            for pat, access in access_rules:
                if fnmatch(attr.symbol, pat):
                    attr = attr.with_(access=access)
                    break
        return attr

    def fix(node):
        if isinstance(node, ir.SpmdRegion):
            existing = {d.symbol: d for d in node.data}
            for sym in symtab:
                if sym not in existing:
                    existing[sym] = ir.DataAttr(symbol=sym, sharing="shared",
                                                sharing_visibility="implicit")
            data = tuple(complete(existing[s]) for s in sorted(existing))
            return dataclasses.replace(node, data=data)
        if isinstance(node, (ir.LoopNode, ir.TaskNode)) and node.data:
            return dataclasses.replace(node, data=tuple(complete(d) for d in node.data))
        return node

    return ir.map_nodes(prog, fix)


def _apply_rules(symbol: str, shape: Tuple[int, ...], mesh: ir.MeshSpec,
                 rules) -> Tuple[Tuple[ir.DataDist, ...], Dict[str, bool]]:
    for pattern, candidates in rules:
        if not fnmatch(symbol, pattern):
            continue
        chosen: list = []
        used_dims: set = set()
        used_axes: set = set()
        fell_through = False
        for cand in candidates:
            dim, axis = int(cand[0]), str(cand[1])
            if dim < 0:
                dim += len(shape)
            parts = axis.split("+")  # "pod+data" shards one dim over two axes
            if dim in used_dims or any(a in used_axes for a in parts):
                continue
            try:
                size = 1
                for a in parts:
                    size *= mesh.size(a)
            except KeyError:
                continue  # axis not in this mesh (e.g. "pod" on single-pod)
            if dim >= len(shape) or shape[dim] % size != 0:
                fell_through = True
                continue
            chosen.append(ir.DataDist(dim=dim, axis=axis))
            used_dims.add(dim)
            used_axes.update(parts)
        notes = {"dist_fallback": True} if fell_through and chosen else (
            {"dist_undivisible": True} if fell_through and not chosen else {})
        return tuple(sorted(chosen)), notes
    return (), {}
