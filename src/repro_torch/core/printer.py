"""MLIR-dialect export (paper §6, Figs 9 & 12).

Renders a UPIR program in the paper's textual dialect, e.g.::

    func @axpy(...) {
      %0 = upir.parallel_data_info(x, shared, implicit, tofrom, implicit, read-only)
      upir.task target(nvptx) data(%0, ...) {
        upir.spmd num_teams(...) num_units(...) target(gpu) data(...) {
          upir.loop induction-var(%i) lowerBound(0) upperBound(%n) step(1) {
            upir.loop_parallel worksharing(schedule(static) distribute(units))
          }
        }
      }
    }

The renderer is deterministic, so two equal Programs always print identically —
used by tests as a second witness of the C1 claim, and by `examples/upir_showcase`.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

from . import ir
# The mm()/caps()/sched() key vocabularies — and their rendering order —
# are declared once, as introspectable data, in ``core.keytables``; the
# well-formedness analysis pass and the docs drift gate consume the same
# tables, so a key can't be rendered (fingerprinted) without also being
# verifiable and documented. The names are re-exported here for the
# printer's existing importers (plans, lower, tests).
from .keytables import (CAP_EXT_KEYS, MM_EXT_KEYS,            # noqa: F401
                        SCHED_EXT_KEYS)


def to_mlir(prog: ir.Program) -> str:
    pr = _Printer(prog)
    return pr.render()


def program_fingerprint(prog: ir.Program) -> str:
    """Canonical ``Program`` fingerprint: sha256 of the deterministic MLIR
    rendering.

    Because the renderer is deterministic (sorted symbol table, sorted data
    attrs, fixed SSA numbering), two structurally equal programs — however
    they were built — always fingerprint identically. ``PlanCache`` in
    ``core.lower`` keys compiled serving plans on this.
    """
    return hashlib.sha256(to_mlir(prog).encode("utf-8")).hexdigest()[:16]


class _Printer:
    def __init__(self, prog: ir.Program):
        self.prog = prog
        self.lines: List[str] = []
        self.ssa: Dict[str, str] = {}
        self.counter = 0

    def render(self) -> str:
        symtab = self.prog.symbol_table()
        args = ", ".join(
            f"%{_sanitize(s)}: {_memref(shape, dt)}" for s, (shape, dt) in
            sorted(symtab.items())) if symtab else "..."
        self.lines.append(f"func @{self.prog.name}({args}) {{")
        for attr in self._collect_data():
            self._emit_data_info(attr)
        for node in self.prog.body:
            self._emit(node, 1)
        self.lines.append("}")
        return "\n".join(self.lines)

    def _collect_data(self):
        seen = {}
        for n in ir.walk(self.prog):
            if isinstance(n, ir.DataAttr) and n.symbol not in seen:
                seen[n.symbol] = n
        return [seen[k] for k in sorted(seen)]

    def _emit_data_info(self, a: ir.DataAttr):
        name = f"%{self.counter}"
        self.counter += 1
        self.ssa[a.symbol] = name
        fields = [a.symbol, a.sharing, a.sharing_visibility, a.mapping,
                  a.mapping_visibility, a.access]
        if a.distribution:
            dist = " ".join(
                f"distribute(dim({d.dim}), unit-id({d.axis}), pattern({d.pattern}))"
                for d in a.distribution)
            fields.append(dist)
        if a.allocator != "default_mem_alloc":
            fields.append(f"allocator({a.allocator})")
        if a.memcpy != "default":
            fields.append(f"memcpy({a.memcpy})")
        mm = _mm_fields(a.extensions)
        if mm:
            fields.append(mm)
        caps = _cap_fields(a.extensions)
        if caps:
            fields.append(caps)
        sched = _sched_fields(a.extensions)
        if sched:
            fields.append(sched)
        self.lines.append(
            f"  {name} = upir.parallel_data_info({', '.join(fields)})")

    def _refs(self, syms) -> str:
        return ", ".join(self.ssa.get(s, f"%{_sanitize(s)}") for s in syms)

    def _emit(self, node, depth: int):
        pad = "  " * depth
        if isinstance(node, ir.TaskNode):
            attrs = [f"target({node.target})"]
            if node.device >= 0:
                attrs.append(f"device({node.device})")
            if node.kind != "offload":
                attrs.append(f"kind({node.kind})")
            if node.depend_in:
                attrs.append(f"depend(in: {', '.join(node.depend_in)})")
            if node.depend_out:
                attrs.append(f"depend(out: {', '.join(node.depend_out)})")
            if node.data:
                attrs.append(f"data({self._refs(d.symbol for d in node.data)})")
            self.lines.append(f"{pad}upir.task {' '.join(attrs)} {{")
            for b in node.body:
                self._emit(b, depth + 1)
            self.lines.append(f"{pad}}}")
        elif isinstance(node, ir.SpmdRegion):
            attrs = [f"num_teams({node.mesh.num_teams})",
                     f"num_units({node.mesh.num_units})",
                     f"target({node.target})"]
            axes = " x ".join(f"{n}:{s}" for n, s in node.mesh.axes)
            attrs.append(f"mesh({axes})")
            if node.data:
                attrs.append(f"data({self._refs(d.symbol for d in node.data)})")
            self.lines.append(f"{pad}upir.spmd {' '.join(attrs)} {{")
            for s in node.sync:
                self._emit(s, depth + 1)
            for b in node.body:
                self._emit(b, depth + 1)
            self.lines.append(f"{pad}}}")
        elif isinstance(node, ir.LoopNode):
            attrs = [f"induction-var(%{node.induction})",
                     f"lowerBound({node.lower})", f"upperBound({node.upper})",
                     f"step({node.step})"]
            if node.collapse > 1:
                attrs.append(f"collapse({node.collapse})")
            self.lines.append(f"{pad}upir.loop {' '.join(attrs)} {{")
            for p in node.parallel:
                self.lines.append(f"{pad}  upir.loop_parallel {_parallel(p)}")
            for s in node.sync:
                self._emit(s, depth + 1)
            for b in node.body:
                self._emit(b, depth + 1)
            self.lines.append(f"{pad}}}")
        elif isinstance(node, ir.SyncOp):
            attrs = [node.name, "async" if node.is_async else "sync"]
            if node.step != "both":
                attrs.append(node.step)
            attrs.append(f"primary({node.primary})")
            attrs.append(f"secondary({node.secondary})")
            if node.operation:
                attrs.append(f"operation({node.operation})")
            if node.axes:
                attrs.append(f"axes({', '.join(node.axes)})")
            if node.data:
                attrs.append(f"data({self._refs(node.data)})")
            if node.implicit:
                attrs.append("implicit")
            self.lines.append(f"{pad}upir.sync {' '.join(attrs)}")
        elif isinstance(node, ir.MoveOp):
            a = "async " if node.is_async else ""
            self.lines.append(
                f"{pad}upir.memcpy {a}direction({node.direction}) "
                f"data({self._refs([node.symbol])})")
        elif isinstance(node, ir.MemOp):
            mm = _mm_fields(node.extensions)
            # trace_emit (instrumentation point) and kv_transfer (cross-pool
            # page movement) are not memory-state transitions — they render
            # under their own op names
            op = ("upir.trace_emit" if node.kind == "trace_emit"
                  else "upir.kv_transfer" if node.kind == "kv_transfer"
                  else f"upir.memory_{node.kind}")
            pools = ""
            if node.kind == "kv_transfer":
                src = ir.ext_get(node.extensions, "src_pool", "?")
                dst = ir.ext_get(node.extensions, "dst_pool", "?")
                pools = f"src_pool({src}) dst_pool({dst}) "
            self.lines.append(
                f"{pad}{op} allocator({node.allocator}) " + pools
                + (mm + " " if mm else "")
                + f"data({self._refs([node.symbol])})")
        elif isinstance(node, ir.KernelOp):
            args = ", ".join(node.args)
            self.lines.append(f"{pad}upir.kernel @{node.fn}({args})")


def _parallel(p) -> str:
    if isinstance(p, ir.Worksharing):
        fields = [f"schedule({p.schedule}{', ' + str(p.chunk) if p.chunk else ''})",
                  f"distribute({p.distribute})"]
        if p.axis:
            fields.append(f"axis({p.axis})")
        return f"worksharing({' '.join(fields)})"
    if isinstance(p, ir.Simd):
        s = f"simd(simdlen({p.simdlen})"
        if p.block:
            s += f" block({'x'.join(map(str, p.block))})"
        return s + ")"
    if isinstance(p, ir.Taskloop):
        fields = []
        if p.grainsize:
            fields.append(f"grainsize({p.grainsize})")
        if p.num_tasks:
            fields.append(f"num_tasks({p.num_tasks})")
        return f"taskloop({' '.join(fields)})"
    return str(p)


def _mm_fields(extensions) -> str:
    parts = []
    for key in MM_EXT_KEYS:
        v = ir.ext_get(extensions, key)
        if v is None:
            continue
        parts.append(key if v is True else f"{key}({v})")
    return f"mm({' '.join(parts)})" if parts else ""


def _cap_fields(extensions) -> str:
    parts = []
    for key in CAP_EXT_KEYS:
        v = ir.ext_get(extensions, key)
        if v is None or v is False:
            continue
        parts.append(key if v is True else f"{key}({v})")
    return f"caps({' '.join(parts)})" if parts else ""


def _sched_fields(extensions) -> str:
    parts = []
    for key in SCHED_EXT_KEYS:
        v = ir.ext_get(extensions, key)
        if v is None or v is False:
            continue
        parts.append(key if v is True else f"{key}({v})")
    return f"sched({' '.join(parts)})" if parts else ""


def _sanitize(s: str) -> str:
    return s.replace("/", "_").replace(".", "_")


def _memref(shape, dtype) -> str:
    if shape is None:
        return f"memref<*x{dtype}>"
    dims = "x".join(str(d) for d in shape)
    return f"memref<{dims}x{dtype}>"
