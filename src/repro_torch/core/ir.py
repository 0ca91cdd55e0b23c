"""UPIR node definitions.

Faithful JAX-side realization of the UPIR specification (Wang, Yi, Yan, 2022):

  * three parallelism patterns — ``SpmdRegion`` (teams x units), ``LoopNode`` +
    ``LoopParallel`` (worksharing / simd / taskloop), ``TaskNode`` (shared-memory,
    offloading and remote tasks);
  * data attributes and explicit data movement / memory management — ``DataAttr``
    (six-field attribute per datum), ``MoveOp``, ``MemOp``;
  * unified synchronization — ``SyncOp`` with the arrive-compute / wait-release split.

All nodes are frozen dataclasses built from hashable components so that two
independently-constructed programs with the same parallel semantics compare equal —
the paper's central claim (Fig. 9: OpenMP and OpenACC AXPY produce *identical* UPIR).

Model-specific escape hatches live in ``extensions`` key/value tuples, mirroring the
paper's "UPIR extension" design (§2.4.1): language-unique features ride along without
polluting the core node schema.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

# --------------------------------------------------------------------------- helpers

Extensions = Tuple[Tuple[str, Any], ...]


def ext(**kv: Any) -> Extensions:
    """Build a canonical (sorted) extension tuple."""
    return tuple(sorted(kv.items()))


def ext_get(node_ext: Extensions, key: str, default: Any = None) -> Any:
    for k, v in node_ext:
        if k == key:
            return v
    return default


def ext_set(node_ext: Extensions, **kv: Any) -> Extensions:
    d = dict(node_ext)
    d.update(kv)
    return tuple(sorted(d.items()))


# --------------------------------------------------------------------------- §4 data

SHARING = ("shared", "private", "firstprivate", "lastprivate")
MAPPING = ("to", "from", "tofrom", "allocate", "none")
ACCESS = ("read-only", "write-only", "read-write")
VISIBILITY = ("implicit", "explicit")
PATTERNS = ("block", "cyclic", "linear", "loop")
ALLOCATORS = ("default_mem_alloc", "large_cap_mem_alloc", "vmem_alloc",
              "host_mem_alloc", "paged_kv_alloc")


@dataclass(frozen=True, order=True)
class DataDist:
    """One element of the paper's data-distribution list.

    ``dim``      — which tensor dimension is distributed (paper: array section);
    ``axis``     — the SPMD unit axis it is distributed onto (paper: unit-id; here a
                   named mesh axis such as "data" / "model" / "pod");
    ``pattern``  — block | cyclic | linear | loop.  TPU/XLA shards block-contiguously;
                   ``cyclic`` is accepted and lowered as block (recorded degeneration,
                   see DESIGN.md §2).
    """

    dim: int
    axis: str
    pattern: str = "block"

    def __post_init__(self):
        assert self.pattern in PATTERNS, self.pattern


@dataclass(frozen=True)
class DataAttr:
    """upir.data — the six-field data attribute of §4.1."""

    symbol: str                       # pytree path or variable name
    sharing: str = "shared"           # 1) shared/private attribute
    mapping: str = "none"             # 2) mapping between discrete memory spaces
    access: str = "read-write"        # 3) access mode
    memcpy: str = "default"           # 4) memcpy API to use when moved
    allocator: str = "default_mem_alloc"      # 5) mm attribute
    deallocator: str = "default_mem_dealloc"  # 5) mm attribute
    distribution: Tuple[DataDist, ...] = ()   # 6) distribution attribute
    sharing_visibility: str = "implicit"
    mapping_visibility: str = "implicit"
    extensions: Extensions = ()

    def __post_init__(self):
        assert self.sharing in SHARING, self.sharing
        assert self.mapping in MAPPING, self.mapping
        assert self.access in ACCESS, self.access
        assert self.sharing_visibility in VISIBILITY
        assert self.mapping_visibility in VISIBILITY

    def with_(self, **kv: Any) -> "DataAttr":
        return dataclasses.replace(self, **kv)


@dataclass(frozen=True)
class MoveOp:
    """upir.memcpy — explicit data movement (§4.2)."""

    symbol: str
    direction: str            # "to" (host->device) | "from" | "device-device"
    is_async: bool = False
    depend: Tuple[str, ...] = ()
    extensions: Extensions = ()


@dataclass(frozen=True)
class MemOp:
    """upir.memory_{alloc,dealloc,share,cow,snapshot,restore} — explicit
    memory management (§4.2) — plus ``upir.trace_emit`` instrumentation.

    ``alloc``/``dealloc`` bracket a buffer's lifetime; ``share`` marks a
    ref-counted aliasing of already-allocated storage (prefix-shared KV
    pages), ``cow`` marks the copy-on-write duplication that resolves a
    write into shared storage, and ``snapshot``/``restore`` are the
    device↔host state movement a fault-tolerant engine uses for
    crash-restart resume (``Engine.snapshot()``). ``trace_emit`` marks the
    host-side request-lifecycle instrumentation points of a
    telemetry-enabled engine (``runtime.telemetry``) — the printer renders
    it as ``upir.trace_emit`` rather than ``upir.memory_trace_emit``.
    ``kv_transfer`` is the cross-pool page movement op (also rendered under
    its own name, ``upir.kv_transfer``): its ``src_pool``/``dst_pool``
    extensions name the tiers the pages move between — device↔host for the
    tiered-KV spill/page-in path, prefill→decode for the disaggregated
    hand-off. All
    render into the canonical program text, so an engine that manages
    memory differently (e.g. prefix sharing, fault tolerance, tracing
    on vs off, or a tiered/disaggregated pool topology) fingerprints — and
    plan-caches — differently.
    """

    kind: str      # "alloc" | "dealloc" | "share" | "cow" | "snapshot" | "restore" | "trace_emit" | "kv_transfer"
    symbol: str
    allocator: str = "default_mem_alloc"
    extensions: Extensions = ()


# --------------------------------------------------------------------------- §5 sync

SYNC_NAMES = (
    "barrier", "reduction", "allreduce", "reduce_scatter", "all_gather",
    "broadcast", "all_to_all", "send", "recv", "shift",
    "taskwait", "single", "critical", "atomic",
)
SYNC_STEPS = ("both", "arrive-compute", "wait-release")


@dataclass(frozen=True)
class SyncOp:
    """upir.sync — unified synchronization/communication/mutex IR (§5).

    The four common fields of the paper: ``primary`` unit, ``secondary`` units,
    ``operation`` performed with the sync, and the ``data`` list.  ``is_async`` +
    ``step`` encode the arrive-compute / wait-release split that unifies the
    synchronous and asynchronous versions of every operation.

    JAX adaptation: ``axes`` names the mesh axes the collective runs over; the
    lowering turns these into ``jax.lax`` collectives (psum / all_gather /
    psum_scatter / all_to_all / ppermute) or into GSPMD sharding constraints.
    """

    name: str
    axes: Tuple[str, ...] = ()
    primary: str = "unit:*"           # e.g. "unit:0", "rank:3", "task:*"
    secondary: str = "unit:*"
    operation: str = ""               # add/max/min/concat/... for reductions
    data: Tuple[str, ...] = ()
    is_async: bool = False
    step: str = "both"
    implicit: bool = False
    extensions: Extensions = ()

    def __post_init__(self):
        assert self.name in SYNC_NAMES, self.name
        assert self.step in SYNC_STEPS, self.step

    def with_(self, **kv: Any) -> "SyncOp":
        return dataclasses.replace(self, **kv)


# ---------------------------------------------------------------- §3.2 data parallel

SCHEDULES = ("static", "dynamic", "guided", "runtime", "auto")


@dataclass(frozen=True)
class Worksharing:
    """worksharing(...) — SPMD worksharing parallelization of a canonical loop."""

    schedule: str = "static"
    chunk: int = 0                    # 0 = unspecified
    distribute: str = "units"         # "teams" | "units" | "teams,units"
    axis: str = ""                    # resolved mesh axis (filled by normalize)
    extensions: Extensions = ()

    def __post_init__(self):
        assert self.schedule in SCHEDULES, self.schedule


@dataclass(frozen=True)
class Simd:
    """simd(simdlen) — vector/tile parallelization.

    TPU adaptation: ``simdlen`` is the lane tile (128); ``block`` is the full
    VMEM block shape used when this loop lowers to a Pallas kernel.
    """

    simdlen: int = 128
    block: Tuple[int, ...] = ()
    extensions: Extensions = ()


@dataclass(frozen=True)
class Taskloop:
    """taskloop(grainsize|num_tasks) — runtime-scheduled loop parallelization.

    TPU adaptation: a taskloop over the batch axis is a gradient-accumulation
    microbatch loop (grainsize = microbatch size); a taskloop over layers/stages
    is a pipeline-parallel schedule.
    """

    grainsize: int = 0
    num_tasks: int = 0
    extensions: Extensions = ()


LoopParallel = Union[Worksharing, Simd, Taskloop]


@dataclass(frozen=True)
class LoopNode:
    """upir.loop — canonical loop, deliberately separate from its parallelization."""

    induction: str                    # logical axis name: batch/seq/layer/microbatch/...
    lower: Any = 0
    upper: Any = None                 # int or symbolic str
    step: Any = 1
    collapse: int = 1
    data: Tuple[DataAttr, ...] = ()
    sync: Tuple[SyncOp, ...] = ()
    parallel: Tuple[LoopParallel, ...] = ()
    body: Tuple["Node", ...] = ()
    extensions: Extensions = ()


# ------------------------------------------------------------------------- §3.1 SPMD


@dataclass(frozen=True)
class MeshSpec:
    """Two-level SPMD hierarchy: ``teams`` axes x ``units`` axes over named sizes."""

    axes: Tuple[Tuple[str, int], ...]           # ordered (name, size)
    teams: Tuple[str, ...] = ()                 # axis names forming the team level
    units: Tuple[str, ...] = ()                 # axis names forming the unit level

    def size(self, name: str) -> int:
        for n, s in self.axes:
            if n == name:
                return s
        raise KeyError(name)

    @property
    def num_teams(self) -> int:
        n = 1
        for a in self.teams:
            n *= self.size(a)
        return n

    @property
    def num_units(self) -> int:
        n = 1
        for a in self.units:
            n *= self.size(a)
        return n

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.axes)


@dataclass(frozen=True)
class SpmdRegion:
    """upir.spmd — SPMD region with teams x units hierarchy (§3.1)."""

    mesh: MeshSpec
    target: str = "tpu"               # cpu | gpu | tpu | pod
    data: Tuple[DataAttr, ...] = ()
    sync: Tuple[SyncOp, ...] = ()
    body: Tuple["Node", ...] = ()
    extensions: Extensions = ()


# ---------------------------------------------------------------------- §3.3 tasking


@dataclass(frozen=True)
class TaskNode:
    """upir.task — async task: shared-memory | offloading | remote (§3.3)."""

    kind: str = "offload"             # "shared" | "offload" | "remote"
    target: str = "tpu"               # device kind or "pod:<k>" for remote tasks
    device: int = -1                  # -1 = runtime-chosen
    is_async: bool = True
    depend_in: Tuple[str, ...] = ()
    depend_out: Tuple[str, ...] = ()
    sched: str = "help-first"         # work-stealing policy hint (§3.3)
    data: Tuple[DataAttr, ...] = ()
    sync: Tuple[SyncOp, ...] = ()
    body: Tuple["Node", ...] = ()
    extensions: Extensions = ()


# ---------------------------------------------------------------------- kernel leaf


@dataclass(frozen=True)
class KernelOp:
    """Leaf compute op inside a loop nest (the 'single program' body).

    ``fn`` is a registered kernel name (axpy/matmul/.../train_step_body); the
    lowering resolves it against the kernel/step registry.
    """

    fn: str
    args: Tuple[str, ...] = ()
    extensions: Extensions = ()


Node = Union[SpmdRegion, LoopNode, TaskNode, KernelOp, SyncOp, MoveOp, MemOp]


# ------------------------------------------------------------------------- program


@dataclass(frozen=True)
class Program:
    """A UPIR translation unit: one step function / kernel and its plan."""

    name: str
    body: Tuple[Node, ...] = ()
    # symbol table: name -> (shape tuple | None, dtype str | None); optional, used by
    # the propagate pass ("data analysis module") and the lowering.
    symbols: Tuple[Tuple[str, Tuple[Optional[Tuple[int, ...]], str]], ...] = ()
    extensions: Extensions = ()

    def symbol_table(self):
        return dict(self.symbols)

    def with_body(self, body) -> "Program":
        return dataclasses.replace(self, body=tuple(body))

    def with_(self, **kv: Any) -> "Program":
        return dataclasses.replace(self, **kv)


# ------------------------------------------------------------------------- walking

# Node classes the walk descends into when found inside tuple-valued fields
# (body/data/sync/symbols-adjacent tuples) ...
_TUPLE_WALK_TYPES = (SpmdRegion, LoopNode, TaskNode, KernelOp, SyncOp,
                     MoveOp, MemOp, DataAttr, Program)
# ... and when found as a direct (scalar) dataclass field. DataAttr/Program
# never appear as scalar fields of another node, and MeshSpec/LoopParallel
# are deliberately *not* walked — they are attributes of their owner, not
# ops; analyses read them through the owning node.
_FIELD_WALK_TYPES = (SpmdRegion, LoopNode, TaskNode, KernelOp, SyncOp,
                     MoveOp, MemOp)


def walk_with_path(node: Any, _path: str = "", _stack: Optional[set] = None):
    """Yield ``(op_path, node)`` for every node in a program/subtree.

    Traversal contract (the analysis passes depend on it — do not change
    without updating the reference package's ``analysis``):

    * **pre-order**: a node is yielded before any of its children;
    * **deterministic**: children are visited in dataclass field
      declaration order, tuple elements left-to-right — so two equal
      programs always produce the same (path, node) sequence, and an
      ``op_path`` is a stable address usable in diagnostics and tests;
    * **path syntax**: ``/``-joined steps, ``field[i]`` for the *i*-th
      element of a tuple field and ``field`` for a scalar field, relative
      to the root (whose path is ``""``), e.g.
      ``body[0]/body[0]/body[3]`` = 4th op in the SPMD region's body;
    * **cycle-safe**: a node already on the current ancestor stack is
      skipped instead of recursed into (frozen dataclasses make cycles
      hard to build by accident, but ``object.__setattr__`` can — the
      walk must terminate regardless). Shared *acyclic* subtrees (DAGs)
      are still visited once per occurrence, each with its own path.
    """
    stack = _stack if _stack is not None else set()
    marker = id(node)
    if marker in stack:
        return
    yield _path, node
    stack.add(marker)
    try:
        fields = dataclasses.fields(node) if dataclasses.is_dataclass(node) else ()
        for f in fields:
            v = getattr(node, f.name)
            step = (_path + "/" if _path else "") + f.name
            if isinstance(v, tuple):
                for i, item in enumerate(v):
                    if isinstance(item, _TUPLE_WALK_TYPES):
                        yield from walk_with_path(item, f"{step}[{i}]", stack)
            elif isinstance(v, _FIELD_WALK_TYPES):
                yield from walk_with_path(v, step, stack)
    finally:
        stack.discard(marker)


def walk(node: Any):
    """Yield every node in a program/subtree, pre-order.

    Same traversal (and the same determinism/cycle-safety guarantees) as
    :func:`walk_with_path`, without the path bookkeeping.
    """
    for _, n in walk_with_path(node):
        yield n


def find_all(node: Any, cls) -> list:
    return [n for n in walk(node) if isinstance(n, cls)]


def map_nodes(node: Any, fn):
    """Structurally rebuild ``node``, applying ``fn`` bottom-up to every IR node.

    ``fn`` may return a replacement node or ``None`` to delete (only valid for
    nodes inside tuples).
    """
    if not dataclasses.is_dataclass(node):
        return node
    changes = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, tuple) and v and any(dataclasses.is_dataclass(x) for x in v):
            new_items = []
            for item in v:
                if dataclasses.is_dataclass(item) and not isinstance(item, type):
                    r = map_nodes(item, fn)
                    if r is not None:
                        new_items.append(r)
                else:
                    new_items.append(item)
            new_v = tuple(new_items)
            if new_v != v:
                changes[f.name] = new_v
    rebuilt = dataclasses.replace(node, **changes) if changes else node
    out = fn(rebuilt)
    return out
