"""Synchronization fusion and decomposition (§3.1.2, §5).

Three rewrites, all enabled by having every sync as a uniform IR node:

  * **reduction + barrier -> allreduce**: the paper's example of fusing a reduction
    with the barrier that follows it;
  * **bucketing**: adjacent small allreduces with identical (axes, operation) fuse
    into one bucketed allreduce — fewer, larger collectives (the classic gradient-
    bucketing trick, expressed as an IR rewrite);
  * **ZeRO decomposition**: an allreduce whose data attr carries ``fsdp=True``
    becomes reduce_scatter (arrive side) + all_gather (release side) — on TPU this
    is the sharded-optimizer rewrite; the lowering realizes it either explicitly
    (shard_map backend) or by param/optimizer sharding specs (GSPMD backend).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .. import ir


def fuse_sync(prog: ir.Program) -> ir.Program:
    fsdp_syms = {
        d.symbol for d in ir.find_all(prog, ir.DataAttr)
        if ir.ext_get(d.extensions, "fsdp", False)
    }

    def fix(node):
        if isinstance(node, (ir.SpmdRegion, ir.LoopNode, ir.TaskNode)) and node.sync:
            return dataclasses.replace(node, sync=_fuse(node.sync, fsdp_syms))
        return node

    return ir.map_nodes(prog, fix)


def _fuse(syncs: Tuple[ir.SyncOp, ...], fsdp_syms: set) -> Tuple[ir.SyncOp, ...]:
    # 1) reduction + barrier -> allreduce
    stage1: list = []
    i = 0
    while i < len(syncs):
        s = syncs[i]
        nxt = syncs[i + 1] if i + 1 < len(syncs) else None
        if s.name in ("reduction", "allreduce") and nxt is not None and \
                nxt.name == "barrier" and set(nxt.axes) <= set(s.axes):
            stage1.append(s.with_(name="allreduce",
                                  extensions=ir.ext_set(s.extensions, fused_barrier=True)))
            i += 2
            continue
        stage1.append(s)
        i += 1

    # 2) bucket adjacent compatible allreduces
    stage2: list = []
    for s in stage1:
        prev = stage2[-1] if stage2 else None
        if (s.name == "allreduce" and prev is not None and prev.name == "allreduce"
                and prev.axes == s.axes and prev.operation == s.operation
                and prev.is_async == s.is_async and prev.step == s.step):
            stage2[-1] = prev.with_(
                data=tuple(prev.data) + tuple(s.data),
                extensions=ir.ext_set(prev.extensions, bucketed=True))
            continue
        stage2.append(s)

    # 3) ZeRO decomposition for fsdp-tagged data
    stage3: list = []
    for s in stage2:
        if s.name == "allreduce" and s.data and all(d in fsdp_syms for d in s.data):
            stage3.append(s.with_(
                name="reduce_scatter",
                extensions=ir.ext_set(s.extensions, zero_decomposed=True)))
            stage3.append(s.with_(
                name="all_gather", operation="",
                extensions=ir.ext_set(s.extensions, zero_decomposed=True)))
            continue
        stage3.append(s)
    return tuple(stage3)
