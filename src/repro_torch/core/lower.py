"""Unified lowering: optimized UPIR ``Program`` -> execution plan (PyTorch port).

The same single transformation as the JAX package: every program arrives here as
the same IR and leaves as the same ``LoweredPlan``. This slice serves one device,
so the plan carries no shardings: ``partition_spec`` and the explicit collective
lowering (``lower_sync``) arrive with the distributed slice. What the serving
engine reads — page geometry, memory-management flags, capabilities, the
scheduling annotation, the fingerprint — is extracted exactly as the reference
extracts it.

Symbols in the IR are "params/blocks/wq"-style paths produced by ``path_str``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from fnmatch import fnmatch
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from . import ir

# ----------------------------------------------------------------------- paths


def path_str(path) -> str:
    """Render a tree path (a sequence of dict keys / indices) as 'a/b/0/c'."""
    return "/".join(str(k) for k in path)


def _flatten(tree, path=()):
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)) and not _is_leaf(tree):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (i,))
    else:
        yield path, tree


def _is_leaf(x) -> bool:
    """A ``(shape, dtype name)`` spec is a leaf; so is anything with a shape."""
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return True
    return (isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], str)
            and isinstance(x[0], tuple))


def _leaf_spec(leaf) -> Tuple[Tuple[int, ...], str]:
    if isinstance(leaf, tuple):
        shape, dt = leaf
        return tuple(int(s) for s in shape), dt
    return tuple(int(s) for s in leaf.shape), str(leaf.dtype).rsplit(".", 1)[-1]


def tree_symbols(tree, prefix: str = "") -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Flatten a tree of ``(shape, dtype name)`` specs or tensors into a UPIR
    symbol table. Dict keys are visited in sorted order — the order of
    ``jax.tree_util`` — and dtypes are spelled as JAX spells them (``float32``,
    not ``torch.float32``), so the program text matches the reference's."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for path, leaf in _flatten(tree):
        name = (prefix + "/" if prefix else "") + path_str(path)
        out[name] = _leaf_spec(leaf)
    return out


# ----------------------------------------------------------------------- plan


@dataclasses.dataclass
class LoweredPlan:
    """Everything the numeric layer needs, extracted from the optimized IR."""

    program: ir.Program
    mesh_spec: ir.MeshSpec
    donated: Tuple[str, ...]                 # symbols whose buffers are donated
    host_offload: Tuple[str, ...]
    batch_axes: Tuple[str, ...]              # mesh axes the batch loop shards over
    seq_axis: Optional[str]                  # mesh axis for sequence parallelism
    microbatches: int                        # taskloop-derived accumulation count
    remat: str                               # none | selective | full
    grad_reduce: str                         # post | pipelined
    zero: bool                               # RS+AG decomposition present
    compression: Optional[str]               # None | int8
    collectives: Tuple[ir.SyncOp, ...]       # flattened sync schedule
    fingerprint: str = ""                    # canonical program fingerprint
    # paged-KV geometry (num_pages, page_size, pages_per_slot) when the
    # program manages the decode cache through paged_kv_alloc, else None
    page_geometry: Optional[Tuple[int, int, int]] = None
    # True when the paged cache is prefix-shared: the program carries
    # share/cow MemOps and the mm(shared_prefix) annotation, and the engine
    # runs ref-counted page aliasing with copy-on-write duplication
    prefix_sharing: bool = False
    # True when the decode cache's memory contract is fault-tolerant: the
    # program carries snapshot/restore MemOps and the mm(fault_tolerant)
    # annotation, and the engine runs quarantine + replay-exact recovery
    fault_tolerant: bool = False
    # True when the program is instrumented: it carries the mm(traced)
    # annotation and a trace_emit op, and the engine records host-side
    # request-lifecycle telemetry (runtime.telemetry)
    traced: bool = False
    # Host-pool page capacity when the paged cache is memory-tiered: the
    # program carries mm(tiered(N)) and device↔host kv_transfer MemOps, and
    # the engine spills cold refcount-1 prefix pages to a host pool instead
    # of dropping them. None for single-tier programs.
    tiering: Optional[int] = None
    # True when the pool topology is disaggregated prefill/decode: the
    # program carries mm(disaggregated) and prefill→decode kv_transfer
    # MemOps, and the engine prefills into a separate pool, handing KV off
    # at prefill completion
    disaggregated: bool = False
    # ModelFamily capability flags carried by the decode cache's data attr
    # (models.api.FamilySpec -> core.plans -> printer caps(...) rendering)
    capabilities: Tuple[str, ...] = ()
    # draft/target pairing (draft_arch_name, lookahead_k) when this is a
    # speculative verify plan (caps spec_verify/draft extensions), else None
    spec_decode: Optional[Tuple[str, int]] = None
    # admission-scheduling annotation carried by the decode cache's data attr
    # (runtime.scheduling -> core.plans -> printer sched(...) rendering), as
    # canonical sorted (key, value) pairs; None when the program declares no
    # policy (pre-scheduling programs keep their fingerprints)
    scheduling: Optional[Tuple[Tuple[str, Any], ...]] = None

    def donate_symbol(self, symbol: str) -> bool:
        return any(fnmatch(symbol, d) or symbol == d for d in self.donated)


# ------------------------------------------------------------------ IR -> plan


def plan_from_program(prog: ir.Program) -> LoweredPlan:
    mesh_spec = None
    for n in ir.walk(prog):
        if isinstance(n, ir.SpmdRegion):
            mesh_spec = n.mesh
            break
    assert mesh_spec is not None, f"program {prog.name} has no SPMD region"

    donated: list = []
    offload: list = []
    for attr in ir.find_all(prog, ir.DataAttr):
        if ir.ext_get(attr.extensions, "donate", False):
            donated.append(attr.symbol)
        if ir.ext_get(attr.extensions, "host_offload", False):
            offload.append(attr.symbol)

    page_geometry = None
    prefix_sharing = False
    for attr in ir.find_all(prog, ir.DataAttr):
        if attr.allocator == "paged_kv_alloc":
            page_geometry = (ir.ext_get(attr.extensions, "num_pages", 0),
                             ir.ext_get(attr.extensions, "page_size", 0),
                             ir.ext_get(attr.extensions, "pages_per_slot", 0))
            prefix_sharing = bool(
                ir.ext_get(attr.extensions, "shared_prefix", False))
            break

    from .printer import CAP_EXT_KEYS, SCHED_EXT_KEYS
    capabilities: Tuple[str, ...] = ()
    spec_decode = None
    scheduling = None
    fault_tolerant = False
    traced = False
    tiering = None
    disaggregated = False
    for attr in ir.find_all(prog, ir.DataAttr):
        if attr.symbol == "cache":
            capabilities = tuple(k for k in CAP_EXT_KEYS
                                 if ir.ext_get(attr.extensions, k) is True)
            fault_tolerant = bool(
                ir.ext_get(attr.extensions, "fault_tolerant", False))
            traced = bool(ir.ext_get(attr.extensions, "traced", False))
            t = ir.ext_get(attr.extensions, "tiered")
            tiering = int(t) if t is not None else None
            disaggregated = bool(
                ir.ext_get(attr.extensions, "disaggregated", False))
            k = ir.ext_get(attr.extensions, "spec_verify")
            if k is not None:
                spec_decode = (str(ir.ext_get(attr.extensions, "draft", "")),
                               int(k))
            sched_pairs = tuple(
                (key, ir.ext_get(attr.extensions, key))
                for key in SCHED_EXT_KEYS
                if ir.ext_get(attr.extensions, key) is not None)
            if sched_pairs:
                scheduling = sched_pairs
            break

    batch_axes: list = []
    seq_axis = None
    microbatches = 1
    for loop in ir.find_all(prog, ir.LoopNode):
        for p in loop.parallel:
            if isinstance(p, ir.Worksharing) and p.axis:
                if loop.induction == "batch":
                    for a in p.axis.split("+"):
                        if a not in batch_axes:
                            batch_axes.append(a)
                if loop.induction in ("seq", "sequence"):
                    seq_axis = p.axis
            if isinstance(p, ir.Taskloop) and loop.induction in ("microbatch", "batch"):
                if p.num_tasks:
                    microbatches = max(microbatches, p.num_tasks)
                elif p.grainsize and isinstance(loop.upper, int):
                    microbatches = max(microbatches, loop.upper // max(p.grainsize, 1))

    syncs = tuple(s for s in ir.find_all(prog, ir.SyncOp))
    grad_reduce = "post"
    zero = False
    compression = None
    for s in syncs:
        if ir.ext_get(s.extensions, "schedule") == "pipelined":
            grad_reduce = "pipelined"
        if ir.ext_get(s.extensions, "zero_decomposed", False):
            zero = True
        c = ir.ext_get(s.extensions, "compression")
        if c:
            compression = c

    return LoweredPlan(
        program=prog, mesh_spec=mesh_spec, donated=tuple(donated),
        host_offload=tuple(offload), batch_axes=tuple(batch_axes), seq_axis=seq_axis,
        microbatches=microbatches,
        remat=ir.ext_get(prog.extensions, "remat", "none"),
        grad_reduce=grad_reduce, zero=zero, compression=compression,
        collectives=syncs, page_geometry=page_geometry,
        prefix_sharing=prefix_sharing, fault_tolerant=fault_tolerant,
        traced=traced, tiering=tiering, disaggregated=disaggregated,
        capabilities=capabilities, spec_decode=spec_decode,
        scheduling=scheduling)


# ------------------------------------------------------------------ plan cache


class PlanCache:
    """Process-wide cache of compiled serving artifacts.

    Entries are keyed by a canonical ``Program`` fingerprint
    (``printer.program_fingerprint``) plus whatever distinguishes the compiled
    artifact — backend, mesh shape, batch geometry — so a repeat request for the
    same (config, shape, backend, mesh) skips the pass pipeline, the
    IR -> plan extraction, AND the rebuild of the step functions. LRU-bounded;
    hit/miss counters feed the serving engine's stats.
    """

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self.hits = 0
        self.misses = 0
        self._entries: "OrderedDict[Any, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def get_or_build(self, key, build: Callable[[], Any]):
        """Return the cached value for ``key``, building (and caching) on miss."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
            self.misses += 1
        value = build()
        with self._lock:
            self._entries[key] = value
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return value

    def lowered_plan(self, prog: ir.Program, *, backend: str = "jit",
                     mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None,
                     trace: Optional[list] = None) -> LoweredPlan:
        """Optimized-IR + LoweredPlan for ``prog``, cached by fingerprint.

        On a hit the unified pass pipeline does not run at all; ``trace`` (the
        pass-trace list) only grows on misses, which is itself a visible
        witness of cache effectiveness.
        """
        from .passes import run_pipeline
        from .printer import program_fingerprint
        fp = program_fingerprint(prog)

        def build() -> LoweredPlan:
            plan = plan_from_program(run_pipeline(prog, trace=trace))
            plan.fingerprint = fp
            return plan

        return self.get_or_build(("plan", fp, backend, mesh_shape), build)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._entries),
                "hit_rate": self.hits / total if total else 0.0}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0


_PLAN_CACHE = PlanCache()


def default_plan_cache() -> PlanCache:
    """The process-wide PlanCache shared by server/engine entry points."""
    return _PLAN_CACHE
