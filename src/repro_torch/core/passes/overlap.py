"""Arrive-compute / wait-release splitting (§5).

The paper unifies synchronous and asynchronous syncs by modelling every collective
as two steps: *arrive-compute* (issue the operation, contribute your part) and
*wait-release* (block until everyone has). A synchronous op performs both in one
call; the compiler may split them and schedule computation in between.

TPU/JAX realization: a gradient allreduce that sits after a microbatch taskloop is
split so that the arrive side (a reduce_scatter contribution) is issued *inside*
the microbatch loop — overlapping each microbatch's gradient reduction with the
next microbatch's compute — and the wait side runs once after the loop. The
lowering reads ``schedule=pipelined`` off the arrive op and structures the
gradient-accumulation scan accordingly.

The pass only fires where overlap is legal: the sync's data must not be consumed
between arrive and wait (here: grads are only read by the optimizer after the
loop), which the planner asserts by tagging the sync ``overlap_candidate=True``.
"""
from __future__ import annotations

import dataclasses

from .. import ir


def split_arrive_wait(prog: ir.Program) -> ir.Program:
    has_taskloop = any(
        isinstance(p, ir.Taskloop)
        for loop in ir.find_all(prog, ir.LoopNode) for p in loop.parallel)

    def fix(node):
        if not isinstance(node, (ir.SpmdRegion, ir.LoopNode, ir.TaskNode)):
            return node
        if not node.sync:
            return node
        new_sync: list = []
        for s in node.sync:
            splittable = (
                s.name in ("allreduce", "reduce_scatter")
                and s.step == "both"
                and ir.ext_get(s.extensions, "overlap_candidate", False)
                and has_taskloop)
            if not splittable:
                new_sync.append(s)
                continue
            new_sync.append(s.with_(
                is_async=True, step="arrive-compute",
                extensions=ir.ext_set(s.extensions, schedule="pipelined")))
            new_sync.append(s.with_(
                is_async=True, step="wait-release", operation="",
                extensions=ir.ext_set(s.extensions, schedule="pipelined")))
        return dataclasses.replace(node, sync=tuple(new_sync))

    return ir.map_nodes(prog, fix)
