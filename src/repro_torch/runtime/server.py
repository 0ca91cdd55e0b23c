"""Serving plans from the UPIR program (PyTorch port).

``serving_plan`` builds the UPIR program of a serving step, runs it through the
unified pass pipeline and caches the resulting ``LoweredPlan`` by program
fingerprint in the ``PlanCache`` — exactly as the JAX package does, so a warm
engine skips the pipeline. The continuous-batching layer above this module
lives in ``runtime.engine``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..configs.base import ArchConfig, ShapeCfg
from ..core.lower import LoweredPlan, PlanCache, default_plan_cache


def serving_plan(cfg: ArchConfig, shape: ShapeCfg, *, backend: str = "jit",
                 plan_cache: Optional[PlanCache] = None,
                 trace: Optional[list] = None,
                 page_geometry: Optional[Tuple[int, int, int]] = None,
                 prefix_sharing: bool = False,
                 spec_decode: Optional[Tuple[str, int]] = None,
                 scheduling: Optional[Dict[str, Any]] = None,
                 fault_tolerant: bool = False,
                 traced: bool = False,
                 tiering: Optional[int] = None,
                 disaggregated: bool = False,
                 verify: bool = False
                 ) -> LoweredPlan:
    """(config, shape, backend[, page geometry, engine mode]) ->
    LoweredPlan, via the PlanCache.

    Every keyword renders into the program text exactly as in the JAX
    package (``mm(...)``, ``caps(...)``, ``sched(...)`` and the MemOps), so
    the port's plans fingerprint — and plan-cache — like the reference's.
    The port serves one device, so there is no mesh.
    """
    from ..core.plans import build_program
    cache = plan_cache if plan_cache is not None else default_plan_cache()
    prog = build_program(cfg, shape, page_geometry=page_geometry,
                         prefix_sharing=prefix_sharing,
                         spec_decode=spec_decode,
                         scheduling=scheduling,
                         fault_tolerant=fault_tolerant,
                         traced=traced,
                         tiering=tiering,
                         disaggregated=disaggregated,
                         verify=verify)
    return cache.lowered_plan(prog, backend=backend, trace=trace)
