"""Fluent builder for UPIR programs.

This is the "native" UPIR frontend: configs and the training/serving planners use it
directly, while the OpenMP/OpenACC/CUDA frontends (``core/frontends``) desugar their
model-specific idioms into these same calls — which is how the paper's unification
claim is realized (§2.4).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

from . import ir


class PlanBuilder:
    """Builds ``task(offload){ spmd(mesh){ loops, data, syncs } }`` programs."""

    def __init__(self, name: str):
        self.name = name
        self._mesh: Optional[ir.MeshSpec] = None
        self._target = "tpu"
        self._task_kind = "offload"
        self._data: Dict[str, ir.DataAttr] = {}
        self._loops: list = []
        self._syncs: list = []
        self._moves: list = []
        self._mems: list = []
        self._kernel: Optional[ir.KernelOp] = None
        self._symbols: Dict[str, Tuple[Optional[Tuple[int, ...]], str]] = {}
        self._ext: Dict[str, Any] = {}

    # ---------------------------------------------------------------- spmd / task

    def mesh(self, axes: Sequence[Tuple[str, int]], teams: Sequence[str] = (),
             units: Sequence[str] = ()) -> "PlanBuilder":
        axes = tuple((str(n), int(s)) for n, s in axes)
        names = tuple(n for n, _ in axes)
        teams = tuple(teams) or names[:1]
        units = tuple(units) or names[1:] or names
        self._mesh = ir.MeshSpec(axes=axes, teams=teams, units=units)
        return self

    def target(self, target: str) -> "PlanBuilder":
        self._target = target
        return self

    def remote(self, pod: int) -> "PlanBuilder":
        self._task_kind = "remote"
        self._target = f"pod:{pod}"
        return self

    # ----------------------------------------------------------------------- data

    def data(self, symbol: str, *, sharing: str = "shared", mapping: str = "none",
             access: str = "read-write", dist: Sequence[ir.DataDist] = (),
             allocator: str = "default_mem_alloc", memcpy: str = "default",
             explicit: bool = True, **extensions: Any) -> "PlanBuilder":
        self._data[symbol] = ir.DataAttr(
            symbol=symbol, sharing=sharing, mapping=mapping, access=access,
            distribution=tuple(dist), allocator=allocator, memcpy=memcpy,
            sharing_visibility="explicit" if explicit else "implicit",
            mapping_visibility="explicit" if explicit else "implicit",
            extensions=ir.ext(**extensions))
        return self

    def sched(self, symbol: str, **keys: Any) -> "PlanBuilder":
        """Attach admission-scheduling annotation keys (rendered by the
        printer as ``sched(...)`` — see ``printer.SCHED_EXT_KEYS``) to an
        already-declared data attribute: scheduling policy rides on the
        decode cache's attr next to ``mm(...)``/``caps(...)``, so it
        participates in the program fingerprint the same way."""
        attr = self._data.get(symbol)
        if attr is None:
            raise KeyError(f"sched() needs a prior data({symbol!r}) "
                           f"declaration to annotate")
        self._data[symbol] = ir.DataAttr(
            **{**_asdict_shallow(attr),
               "extensions": ir.ext_set(attr.extensions, **keys)})
        return self

    def symbol(self, name: str, shape: Optional[Sequence[int]], dtype: str) -> "PlanBuilder":
        self._symbols[name] = (tuple(shape) if shape is not None else None, dtype)
        return self

    def move(self, symbol: str, direction: str, is_async: bool = False) -> "PlanBuilder":
        self._moves.append(ir.MoveOp(symbol=symbol, direction=direction, is_async=is_async))
        return self

    def alloc(self, symbol: str, allocator: str = "default_mem_alloc",
              **extensions: Any) -> "PlanBuilder":
        self._mems.append(ir.MemOp(kind="alloc", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def dealloc(self, symbol: str, allocator: str = "default_mem_alloc",
                **extensions: Any) -> "PlanBuilder":
        self._mems.append(ir.MemOp(kind="dealloc", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def share(self, symbol: str, allocator: str = "default_mem_alloc",
              **extensions: Any) -> "PlanBuilder":
        """Ref-counted aliasing of already-allocated storage (prefix-shared
        KV pages): the allocator hands out an existing buffer again instead
        of fresh storage."""
        self._mems.append(ir.MemOp(kind="share", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def cow(self, symbol: str, allocator: str = "default_mem_alloc",
            **extensions: Any) -> "PlanBuilder":
        """Copy-on-write duplication: a write into shared storage first
        materializes a private copy, leaving the shared original intact."""
        self._mems.append(ir.MemOp(kind="cow", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def snapshot(self, symbol: str, allocator: str = "default_mem_alloc",
                 **extensions: Any) -> "PlanBuilder":
        """Device→host copy of the allocator's live state (fault-tolerant
        engines: KV pool + page tables to host buffers for crash-restart
        resume)."""
        self._mems.append(ir.MemOp(kind="snapshot", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def restore(self, symbol: str, allocator: str = "default_mem_alloc",
                **extensions: Any) -> "PlanBuilder":
        """Host→device restore of a previously snapshotted state; the
        inverse of :meth:`snapshot`."""
        self._mems.append(ir.MemOp(kind="restore", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def trace_emit(self, symbol: str, allocator: str = "default_mem_alloc",
                   **extensions: Any) -> "PlanBuilder":
        """Host-side request-lifecycle instrumentation point on ``symbol``
        (telemetry-enabled engines): rendered as ``upir.trace_emit``, so a
        traced plan fingerprints apart from an untraced one. Pairs with the
        ``mm(traced)`` annotation (serving contract SC007/SC008)."""
        self._mems.append(ir.MemOp(kind="trace_emit", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(**extensions)))
        return self

    def kv_transfer(self, symbol: str, *, src_pool: str, dst_pool: str,
                    allocator: str = "default_mem_alloc",
                    **extensions: Any) -> "PlanBuilder":
        """Cross-pool page movement of ``symbol``'s KV pages from
        ``src_pool`` to ``dst_pool`` — pure data movement, never recompute.
        Rendered as ``upir.kv_transfer src_pool(...) dst_pool(...)``, so
        the pool topology (tiered device↔host spill/page-in, disaggregated
        prefill→decode hand-off) fingerprints the plan apart. Pairs with
        the ``mm(tiered(...))`` / ``mm(disaggregated)`` annotations
        (serving contracts SC009/SC010)."""
        self._mems.append(ir.MemOp(kind="kv_transfer", symbol=symbol,
                                   allocator=allocator,
                                   extensions=ir.ext(src_pool=str(src_pool),
                                                     dst_pool=str(dst_pool),
                                                     **extensions)))
        return self

    # ---------------------------------------------------------------------- loops

    def loop(self, induction: str, upper: Any, *, lower: Any = 0, step: Any = 1,
             collapse: int = 1, parallel: Iterable[ir.LoopParallel] = (),
             sync: Iterable[ir.SyncOp] = (), **extensions: Any) -> "PlanBuilder":
        self._loops.append(ir.LoopNode(
            induction=induction, lower=lower, upper=upper, step=step, collapse=collapse,
            parallel=tuple(parallel), sync=tuple(sync), extensions=ir.ext(**extensions)))
        return self

    def worksharing_loop(self, induction: str, upper: Any, axis: str,
                         schedule: str = "static", chunk: int = 0,
                         distribute: str = "units", **extensions: Any) -> "PlanBuilder":
        return self.loop(induction, upper, parallel=(
            ir.Worksharing(schedule=schedule, chunk=chunk, distribute=distribute,
                           axis=axis),), **extensions)

    def simd_loop(self, induction: str, upper: Any, simdlen: int = 128,
                  block: Sequence[int] = ()) -> "PlanBuilder":
        return self.loop(induction, upper, parallel=(
            ir.Simd(simdlen=simdlen, block=tuple(block)),))

    def taskloop(self, induction: str, upper: Any, *, grainsize: int = 0,
                 num_tasks: int = 0) -> "PlanBuilder":
        return self.loop(induction, upper, parallel=(
            ir.Taskloop(grainsize=grainsize, num_tasks=num_tasks),))

    # ----------------------------------------------------------------------- sync

    def sync(self, name: str, *, axes: Sequence[str] = (), operation: str = "",
             data: Sequence[str] = (), is_async: bool = False, step: str = "both",
             primary: str = "unit:*", secondary: str = "unit:*",
             implicit: bool = False, **extensions: Any) -> "PlanBuilder":
        self._syncs.append(ir.SyncOp(
            name=name, axes=tuple(axes), operation=operation, data=tuple(data),
            is_async=is_async, step=step, primary=primary, secondary=secondary,
            implicit=implicit, extensions=ir.ext(**extensions)))
        return self

    def barrier(self, axes: Sequence[str] = (), implicit: bool = False) -> "PlanBuilder":
        return self.sync("barrier", axes=axes, implicit=implicit)

    def allreduce(self, data: Sequence[str], axes: Sequence[str],
                  operation: str = "add", is_async: bool = False) -> "PlanBuilder":
        return self.sync("allreduce", axes=axes, operation=operation, data=data,
                         is_async=is_async)

    def reduction(self, data: Sequence[str], axes: Sequence[str],
                  operation: str = "add") -> "PlanBuilder":
        return self.sync("reduction", axes=axes, operation=operation, data=data)

    # --------------------------------------------------------------------- kernel

    def kernel(self, fn: str, args: Sequence[str] = ()) -> "PlanBuilder":
        self._kernel = ir.KernelOp(fn=fn, args=tuple(args))
        return self

    def extension(self, **kv: Any) -> "PlanBuilder":
        self._ext.update(kv)
        return self

    # ---------------------------------------------------------------------- build

    def build(self) -> ir.Program:
        assert self._mesh is not None, "mesh() must be called"
        body_leaf: Tuple[ir.Node, ...] = (self._kernel,) if self._kernel else ()
        # nest loops inner-to-outer: first declared loop is outermost
        nest: Tuple[ir.Node, ...] = body_leaf
        for ln in reversed(self._loops):
            nest = (ir.LoopNode(**{**_asdict_shallow(ln), "body": nest}),)
        spmd = ir.SpmdRegion(
            mesh=self._mesh, target=self._target,
            data=tuple(self._data[k] for k in sorted(self._data)),
            sync=tuple(self._syncs),
            body=tuple(self._moves) + tuple(self._mems) + nest)
        task = ir.TaskNode(kind=self._task_kind, target=self._target, body=(spmd,))
        return ir.Program(
            name=self.name, body=(task,),
            symbols=tuple(sorted(self._symbols.items())),
            extensions=ir.ext(**self._ext))


def _asdict_shallow(node) -> dict:
    import dataclasses as _dc
    return {f.name: getattr(node, f.name) for f in _dc.fields(node)}
