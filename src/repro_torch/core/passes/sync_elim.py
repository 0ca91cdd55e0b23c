"""Redundant-synchronization elimination (§3.1.2, refs [14, 36] in the paper).

Because the SPMD region's IR carries a global view of every sync used inside it
(the paper's point about "analysis ... in advance of the occurrence of the actual
sync operation"), elimination is a local walk over sync tuples:

  * consecutive barriers over the same axes collapse to one;
  * a barrier immediately after a collective that already synchronizes those axes
    (allreduce / reduce_scatter / all_gather / all_to_all / broadcast) is removed;
  * duplicate collectives — same name, axes, operation and data — are deduped
    (the GIMPLE failure mode of §2.1: each pass re-reducing the same tensor).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .. import ir

_SYNCING = {"allreduce", "reduce_scatter", "all_gather", "all_to_all", "broadcast",
            "barrier", "reduction"}


def eliminate_redundant_sync(prog: ir.Program) -> ir.Program:
    def fix(node):
        if isinstance(node, (ir.SpmdRegion, ir.LoopNode, ir.TaskNode)) and node.sync:
            return dataclasses.replace(node, sync=_clean(node.sync))
        return node

    return ir.map_nodes(prog, fix)


def _clean(syncs: Tuple[ir.SyncOp, ...]) -> Tuple[ir.SyncOp, ...]:
    out: list = []
    seen_collectives: set = set()
    for s in syncs:
        prev = out[-1] if out else None
        if s.name == "barrier":
            if prev is not None and prev.name == "barrier" and \
                    set(prev.axes) >= set(s.axes):
                continue  # barrier; barrier -> barrier
            if prev is not None and prev.name in _SYNCING and not prev.is_async and \
                    set(prev.axes) >= set(s.axes):
                continue  # collective already synchronizes these axes
            out.append(s)
            continue
        key = (s.name, s.axes, s.operation, s.data, s.step)
        if s.name in _SYNCING and s.data:
            if key in seen_collectives:
                continue  # duplicate reduction of the same data
            seen_collectives.add(key)
        out.append(s)
    return tuple(out)
