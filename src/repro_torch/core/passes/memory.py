"""Memory planning (§4): allocator intents -> remat / donation / placement decisions.

The paper separates data *attributes* (intent) from movement/allocation *operations*
(schedule), precisely so the compiler can decide when and how memory is spent. On
TPU the analogous decisions for a training/serving step are:

  * **rematerialization policy** — whether saved activations fit HBM alongside
    params+optimizer state; chosen from the planner-provided per-step activation
    estimate (``act_bytes``) against the per-device budget (``hbm_bytes``);
  * **donation** — inputs that are ``tofrom``-mapped and read-write (params,
    optimizer state, KV caches) are donated so XLA reuses their buffers;
  * **placement** — data attrs with ``large_cap_mem_alloc`` are tagged for host
    offload; ``vmem_alloc`` marks tensors that Pallas kernels keep in VMEM blocks.

Decisions are recorded as Program/DataAttr extensions; ``core.lower`` consumes them.
"""
from __future__ import annotations

import dataclasses

from .. import ir

_HBM_BYTES_DEFAULT = 16 * 2**30  # TPU v5e


def plan_memory(prog: ir.Program) -> ir.Program:
    hbm = ir.ext_get(prog.extensions, "hbm_bytes", _HBM_BYTES_DEFAULT)
    act = ir.ext_get(prog.extensions, "act_bytes", 0)
    resident = ir.ext_get(prog.extensions, "resident_bytes", 0)

    headroom = hbm - resident
    if act and headroom > 0:
        frac = act / headroom
        remat = "full" if frac > 0.35 else ("selective" if frac > 0.08 else "none")
    elif act and headroom <= 0:
        remat = "full"
    else:
        remat = ir.ext_get(prog.extensions, "remat", "none")

    def fix(node):
        if isinstance(node, ir.DataAttr):
            donate = (node.mapping == "tofrom" and node.access == "read-write"
                      and node.sharing == "shared")
            ex = {}
            if donate:
                ex["donate"] = True
            if node.allocator == "large_cap_mem_alloc":
                ex["host_offload"] = True
            if node.allocator == "vmem_alloc":
                ex["vmem_resident"] = True
            if ex:
                return node.with_(extensions=ir.ext_set(node.extensions, **ex))
        return node

    prog = ir.map_nodes(prog, fix)
    return prog.with_(extensions=ir.ext_set(prog.extensions, remat=remat))
