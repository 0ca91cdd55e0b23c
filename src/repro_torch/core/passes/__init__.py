"""UPIR transformation passes.

Every pass is a pure ``Program -> Program`` function. ``run_pipeline`` applies the
standard unified-transformation pipeline of the UPIR compiler; per the paper, the
SAME pipeline serves every frontend (OpenMP-like, OpenACC-like, CUDA-like, and the
native planner) — there is deliberately no per-frontend lowering code path.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .. import ir
from .normalize import normalize
from .propagate import propagate_data_attrs
from .sync_elim import eliminate_redundant_sync
from .sync_fusion import fuse_sync
from .overlap import split_arrive_wait
from .memory import plan_memory

PassFn = Callable[[ir.Program], ir.Program]

DEFAULT_PIPELINE: List[PassFn] = [
    normalize,
    propagate_data_attrs,
    eliminate_redundant_sync,
    fuse_sync,
    split_arrive_wait,
    plan_memory,
]


def run_pipeline(prog: ir.Program, passes: Optional[Sequence[PassFn]] = None,
                 trace: Optional[list] = None) -> ir.Program:
    """Run the unified pass pipeline; optionally record per-pass node statistics."""
    for p in (DEFAULT_PIPELINE if passes is None else passes):
        before = _stats(prog)
        prog = p(prog)
        if trace is not None:
            trace.append({"pass": p.__name__, "before": before, "after": _stats(prog)})
    return prog


def _stats(prog: ir.Program) -> Dict[str, int]:
    return {
        "sync_ops": len(ir.find_all(prog, ir.SyncOp)),
        "data_attrs": len(ir.find_all(prog, ir.DataAttr)),
        "loops": len(ir.find_all(prog, ir.LoopNode)),
        "async_syncs": sum(1 for s in ir.find_all(prog, ir.SyncOp) if s.is_async),
    }


__all__ = [
    "normalize", "propagate_data_attrs", "eliminate_redundant_sync", "fuse_sync",
    "split_arrive_wait", "plan_memory", "run_pipeline", "DEFAULT_PIPELINE",
]
