"""Unparse UPIR back to programming-model source (paper §6.1).

The paper unparses CUDA-derived UPIR to OpenMP so kernels can run on CPUs. We
provide the same capability for the models our frontends cover: a UPIR program can
be unparsed to OpenMP-style or OpenACC-style pseudo-source. Round-trip tests parse
the unparsed text's semantics back through the frontend and assert the UPIR is
unchanged (identity up to normalization).
"""
from __future__ import annotations

from typing import List

from . import ir


def to_openmp(prog: ir.Program) -> str:
    return "\n".join(_Unparser("omp").unparse(prog))


def to_openacc(prog: ir.Program) -> str:
    return "\n".join(_Unparser("acc").unparse(prog))


class _Unparser:
    def __init__(self, flavor: str):
        self.flavor = flavor

    def unparse(self, prog: ir.Program) -> List[str]:
        lines = [f"// {prog.name}: unparsed from UPIR ({self.flavor})"]
        for node in prog.body:
            self._node(node, lines, 0)
        return lines

    def _node(self, node, lines, depth):
        pad = "  " * depth
        if isinstance(node, ir.TaskNode):
            data = node.data
            if not data:  # attrs typically live on the child SPMD region
                for b in node.body:
                    if isinstance(b, ir.SpmdRegion):
                        data = b.data
                        break
            if self.flavor == "omp":
                clauses = self._omp_map_clauses(data)
                dev = f" device({node.device})" if node.device >= 0 else ""
                lines.append(f"{pad}#pragma omp target{dev}{clauses}")
            else:
                clauses = self._acc_data_clauses(data)
                lines.append(f"{pad}#pragma acc parallel{clauses}")
            for b in node.body:
                self._node(b, lines, depth)
        elif isinstance(node, ir.SpmdRegion):
            if self.flavor == "omp":
                lines.append(
                    f"{pad}#pragma omp teams num_teams({node.mesh.num_teams}) "
                    f"thread_limit({node.mesh.num_units})")
            else:
                lines.append(
                    f"{pad}// gangs({node.mesh.num_teams}) "
                    f"vector_length({node.mesh.num_units})")
            for b in node.body:
                self._node(b, lines, depth)
        elif isinstance(node, ir.LoopNode):
            directive = self._loop_directive(node)
            if directive:
                lines.append(f"{pad}{directive}")
            lines.append(
                f"{pad}for ({node.induction} = {node.lower}; "
                f"{node.induction} < {node.upper}; {node.induction} += {node.step}) {{")
            for b in node.body:
                self._node(b, lines, depth + 1)
            lines.append(f"{pad}}}")
        elif isinstance(node, ir.KernelOp):
            lines.append(f"{pad}{node.fn}({', '.join(node.args)});")
        elif isinstance(node, ir.SyncOp):
            if self.flavor == "omp":
                m = {"barrier": "#pragma omp barrier",
                     "allreduce": f"// reduction({node.operation or 'add'}: "
                                  f"{', '.join(node.data)})",
                     "taskwait": "#pragma omp taskwait",
                     "atomic": "#pragma omp atomic",
                     "critical": "#pragma omp critical"}
            else:
                m = {"barrier": "#pragma acc wait",
                     "allreduce": f"// reduction({node.operation or 'add'}: "
                                  f"{', '.join(node.data)})",
                     "taskwait": "#pragma acc wait"}
            lines.append(f"{pad}{m.get(node.name, f'// sync {node.name}')}")
        elif isinstance(node, (ir.MoveOp, ir.MemOp)):
            if self.flavor == "omp" and isinstance(node, ir.MoveOp):
                d = "to" if node.direction == "to" else "from"
                lines.append(f"{pad}#pragma omp target update {d}({node.symbol})")
            elif isinstance(node, ir.MoveOp):
                d = "device" if node.direction == "to" else "self"
                lines.append(f"{pad}#pragma acc update {d}({node.symbol})")
            else:
                lines.append(f"{pad}// {node.kind}({node.symbol}, {node.allocator})")

    def _loop_directive(self, node: ir.LoopNode) -> str:
        for p in node.parallel:
            if isinstance(p, ir.Worksharing):
                if self.flavor == "omp":
                    sched = f" schedule({p.schedule}" + \
                            (f", {p.chunk})" if p.chunk else ")")
                    tgt = "distribute parallel for" if "teams" in p.distribute \
                        else "parallel for"
                    return f"#pragma omp {tgt}{sched}"
                g = {"teams": "gang", "units": "worker",
                     "teams,units": "gang vector"}.get(p.distribute, "worker")
                return f"#pragma acc loop {g}"
            if isinstance(p, ir.Simd):
                if self.flavor == "omp":
                    return f"#pragma omp simd simdlen({p.simdlen})"
                return f"#pragma acc loop vector({p.simdlen})"
            if isinstance(p, ir.Taskloop):
                if self.flavor == "omp":
                    gs = f" grainsize({p.grainsize})" if p.grainsize else \
                         f" num_tasks({p.num_tasks})"
                    return f"#pragma omp taskloop{gs}"
                return "#pragma acc loop auto"
        return ""

    def _omp_map_clauses(self, data) -> str:
        groups = {"to": [], "from": [], "tofrom": [], "allocate": []}
        for d in data:
            if d.mapping in groups:
                groups[d.mapping].append(d.symbol)
        out = ""
        for k, syms in groups.items():
            if syms:
                key = "alloc" if k == "allocate" else k
                out += f" map({key}: {', '.join(syms)})"
        return out

    def _acc_data_clauses(self, data) -> str:
        m = {"to": "copyin", "from": "copyout", "tofrom": "copy",
             "allocate": "create"}
        groups: dict = {}
        for d in data:
            if d.mapping in m:
                groups.setdefault(m[d.mapping], []).append(d.symbol)
        return "".join(f" {k}({', '.join(v)})" for k, v in groups.items())
