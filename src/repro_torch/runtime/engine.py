"""Continuous-batching serving engine, paged and dense KV layouts (PyTorch port).

The counterpart of the JAX package's ``runtime/engine.py`` for its main path:
requests enter a bounded queue, prefill into a **fixed-width decode batch** of
slots, and decode advances every active slot one token per step; a finished
slot is refilled from the queue on the next step.

Two KV-cache layouts (``EngineConfig.kv_layout``):

* ``"paged"`` (the default here, the port's main path): a ``[num_pages,
  page_size]`` physical pool per layer plus a per-slot page table and a
  free-list allocator (``PagedKVAllocator``); pageable families only.
* ``"dense"``: every slot owns its horizon of the family's cache
  (``api.init_cache(slots, max_seq)``): a per-layer K/V cache for the dense
  family, the conv and SSM states plus a rolling window cache for the hybrid
  family, which is not pageable. A prefill's cache-of-one is inserted into
  the slot's row (``api.build_cache_insert``).

On the paged layout:
Sequences hold only the pages they have reached, so admission **overcommits**:
a request is admitted when its *prompt* pages are free. If the pool runs dry
mid-decode, the policy's victim (the newest-admitted request under FIFO) is
evicted — pages freed, request requeued at the front — and recomputed on
re-admission; decode is a deterministic function of the request's key and
positions, so the replayed stream is the same. Decode attention runs the
paged-attention kernel (``kernels/paged_attention``).

``prefill_chunk > 0`` turns on **chunked prefill**: prompts longer than one
chunk prefill page-aligned chunk by chunk, one chunk per engine step,
interleaved with decode; each chunk gathers only the pages already holding
context, bucketed to powers of two (``_gather_bucket``).

The decode plan is a UPIR program built by ``runtime.server.serving_plan`` and
cached by fingerprint in the ``PlanCache``: the page geometry and the
scheduling policy are part of the program text, as in the reference.

Host buffers that change in place (positions, page tables, per-slot policy)
reach the device only as fresh copies (``_upload``): an asynchronous upload
never reads a buffer that the host is still writing.

Not ported yet (the fields exist and raise ``NotImplementedError`` when
set): the prefix cache with copy-on-write, fault tolerance, telemetry, tiered
and disaggregated KV, and speculative decoding (ROADMAP Q1 #9).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeCfg
from ..core.lower import PlanCache, default_plan_cache
from ..device import DeviceLike, resolve_device
from ..models import api
from ..models.api import KernelSpec
from ..models.layers import cache_write_pages
from ..models.transformer import DECODE_ROW_MULTIPLE, compute_params
from .sampling import (GREEDY, SamplingParams, decode_select, gumbel_noise,
                       request_key, sample_tokens)
from .scheduling import (FIFO, SchedulerState, SchedulingPolicy,
                         select_index, victim as policy_victim,
                         wants_preemption)

# ----------------------------------------------------------------- requests


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """What the caller wants generated: the validated, immutable half of a
    request. ``Engine.submit(spec)`` and :func:`serve_sequential` materialize
    a :class:`Request` from it.

    Scheduling fields: ``tenant`` (fair-policy accounting bucket),
    ``priority_class`` (higher admits first under the priority policy) and
    ``deadline_ms`` (TTFT objective, observational).
    """

    prompt: Tuple[int, ...]
    max_new_tokens: int
    sampling: Optional[SamplingParams] = None
    eos_id: Optional[int] = None
    encoder_input: Any = None
    tenant: str = "default"
    priority_class: int = 0
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "prompt",
                           tuple(int(t) for t in self.prompt))
        if not self.prompt:
            raise ValueError("empty prompt: a request must carry at least "
                             "one prompt token")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")
        if not isinstance(self.tenant, str) or not self.tenant:
            raise ValueError(f"tenant must be a non-empty string, "
                             f"got {self.tenant!r}")
        if not isinstance(self.priority_class, int):
            raise ValueError(f"priority_class must be an int, "
                             f"got {self.priority_class!r}")
        if self.deadline_ms is not None and not self.deadline_ms > 0:
            raise ValueError(f"deadline_ms must be > 0, "
                             f"got {self.deadline_ms}")


@dataclasses.dataclass
class Request:
    """One generation request, materialized by :meth:`Engine.submit`.

    ``rid`` is engine-assigned and folds into the request's PRNG key;
    ``prompt`` is padded with zeros up to its ``EngineConfig.prompt_buckets``
    entry before prefill (streams are a function of the padded prompt).
    Engine-filled: ``state`` (``new | queued | prefilling | active | done |
    rejected``), ``reason``, ``bucket``, ``slot``, ``tokens_out`` (via
    :meth:`Engine.finalize_request`) and the ``t_submit`` / ``t_first`` /
    ``t_done`` timestamps (TTFT = ``t_first - t_submit``; wall-clock exact
    only under ``run(sync_per_step=True)``).
    """

    rid: int
    prompt: Sequence[int]
    max_new_tokens: int
    sampling: Optional[SamplingParams] = None   # None = greedy
    eos_id: Optional[int] = None
    encoder_input: Any = None
    tenant: str = "default"
    priority_class: int = 0
    deadline_ms: Optional[float] = None
    state: str = "new"
    reason: str = ""
    bucket: int = 0
    slot: int = -1
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    _remaining: int = 0
    _first_tok: Any = None
    _admit_seq: int = 0            # monotonic admission order (eviction policy)
    _chunk_cursor: int = 0         # chunked prefill progress
    # PRNG key snapshot (the reference's threefry key, uint32[2]): taken at
    # materialization and never reset, so eviction-by-recompute replays a
    # sampled stream identically
    _key: Any = None


# ROADMAP item each unported EngineConfig feature waits for
_UNPORTED = (
    ("prefix_cache", False, "prefix cache + copy-on-write (ROADMAP Q1 #9)"),
    ("tiered_kv", False, "tiered KV (ROADMAP Q1 #9)"),
    ("host_pages", 0, "tiered KV (ROADMAP Q1 #9)"),
    ("disaggregated", False, "disaggregated prefill/decode (ROADMAP Q1 #9)"),
    ("spec_decode", None, "speculative decoding (ROADMAP Q1 #9)"),
    ("fault_plan", None, "fault tolerance (ROADMAP Q1 #9)"),
    ("nan_guard", False, "fault tolerance (ROADMAP Q1 #9)"),
    ("watchdog_ms", None, "fault tolerance (ROADMAP Q1 #9)"),
    ("debug_checks", False, "fault tolerance (ROADMAP Q1 #9)"),
    ("enforce_deadlines", False, "fault tolerance (ROADMAP Q1 #9)"),
    ("verify_ir", False, "the UPIR verifier (ROADMAP Q1 #13)"),
    ("telemetry", False, "telemetry (ROADMAP Q1 #9)"),
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine construction knobs, validated once in :class:`Engine`. The
    field names and defaults are the JAX package's, with two exceptions:
    ``kv_layout`` defaults to ``"paged"`` (the port's main path; the
    reference defaults to ``"dense"``) and ``decode_kernel`` is ``"cuda"``
    (the paged-attention kernel wrapper; its plain version on CPU tensors)
    or ``"torch"`` (the plain gather path, CPU only). Fields of features
    the port has not ported yet raise ``NotImplementedError`` when set.

    * ``slots`` *[plan key]* — fixed decode batch width.
    * ``max_queue`` — admission bound; beyond it a submit is rejected with
      ``REJECTED_QUEUE_FULL`` (``None`` = unbounded).
    * ``prompt_buckets`` — allowed padded prompt lengths.
    * ``max_seq`` *[plan key]* — per-sequence horizon (``bucket +
      max_new_tokens`` must fit).
    * ``backend`` — plan-cache key of the compiled artifacts.
    * ``keep_results`` / ``max_trace_events`` — memory bounds for long-lived
      processes.
    * ``eos_poll_every`` — decode steps between host polls of the
      device-side finished mask (0 = only truncate at finalize).
    * ``kv_layout`` *[plan key]* — ``"paged"`` or ``"dense"`` (per-slot
      horizon, any family).
    * ``page_size`` / ``num_pages`` *[plan key]* — pool geometry (0 pages =
      ``slots * ceil(max_seq / page_size)``, i.e. no overcommit); paged only.
    * ``prefill_chunk`` — 0 = one-shot prefill; else the chunk length (paged
      only; the dense layout prefills one-shot, as in the reference).
    * ``scheduling`` *[plan key]* — admission policy
      (``runtime.scheduling``); ``prefix_affinity`` needs the prefix cache.
    """

    slots: int = 4
    max_queue: Optional[int] = None
    prompt_buckets: Tuple[int, ...] = (16, 32, 64)
    max_seq: int = 128
    backend: str = "jit"
    keep_results: int = 4096
    max_trace_events: int = 10000
    eos_poll_every: int = 16
    kv_layout: str = "paged"
    page_size: int = 16
    num_pages: int = 0
    prefill_chunk: int = 0
    decode_kernel: str = "cuda"
    interpret: bool = True         # the reference's Pallas interpreter switch
    prefix_cache: bool = False
    tiered_kv: bool = False
    host_pages: int = 0
    disaggregated: bool = False
    spec_decode: Any = None
    scheduling: SchedulingPolicy = FIFO
    fault_plan: Any = None
    nan_guard: bool = False
    watchdog_ms: Optional[float] = None
    max_retries: int = 3
    debug_checks: bool = False
    verify_ir: bool = False
    enforce_deadlines: bool = False
    telemetry: bool = False
    telemetry_events: int = 65536


# --------------------------------------------------------- free-list allocator


class PagedKVAllocator:
    """Host-side ref-counted free list over physical KV pages
    ``1..num_pages``. Page 0 is the reserved null page, never handed out.
    A double free raises. (Taking extra references on a live page — prefix
    sharing — arrives with the prefix cache.)"""

    def __init__(self, num_pages: int):
        self.total = num_pages
        self._free: List[int] = list(range(num_pages, 0, -1))  # pop() -> low ids
        self._ref: Dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Unique pages currently allocated (aliases count once)."""
        return len(self._ref)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def alloc(self, n: int = 1) -> Optional[List[int]]:
        """``n`` pages, or None (all-or-nothing) when the pool can't cover it."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def free(self, pages: Sequence[int]) -> None:
        """Drop one reference per page; recycle pages that reach zero."""
        for p in pages:
            c = self._ref.get(p)
            if c is None:
                raise ValueError(f"free of page {p} not in use (double free?)")
            if c == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = c - 1

    def check_invariants(self) -> None:
        """Raise ``RuntimeError`` on the first inconsistency: duplicate or
        out-of-range free pages, pages both free and live, bad refcounts, or
        free + live not accounting for the whole pool."""
        if len(set(self._free)) != len(self._free):
            raise RuntimeError("allocator free list holds duplicates")
        bad = sorted(p for p in self._free if not 1 <= p <= self.total)
        if bad:
            raise RuntimeError(f"free pages {bad} outside [1, {self.total}]")
        overlap = set(self._free) & set(self._ref)
        if overlap:
            raise RuntimeError(f"pages {sorted(overlap)} are both free and "
                               f"live")
        bad_ref = {p: c for p, c in self._ref.items()
                   if c < 1 or not 1 <= p <= self.total}
        if bad_ref:
            raise RuntimeError(f"invalid live refcounts {bad_ref}")
        if len(self._free) + len(self._ref) != self.total:
            raise RuntimeError(
                f"page accounting leak: {len(self._free)} free + "
                f"{len(self._ref)} live != {self.total} total")


@dataclasses.dataclass
class EngineStats:
    """Typed snapshot of the engine's counters (``Engine.stats()``), with a
    read-only mapping view (``stats()["decode_steps"]``) that skips ``None``
    fields. ``tokens_per_s`` is decode-only throughput: each request's first
    token comes from prefill and is tallied in ``prefill_tokens``."""

    queue_depth: int = 0
    active_slots: int = 0
    slots: int = 0
    kv_layout: str = "paged"
    capabilities: List[str] = dataclasses.field(default_factory=list)
    policy: str = "fifo"
    decode_steps: int = 0
    prefills: int = 0
    recycles: int = 0
    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    eos_finished: int = 0
    rejected: int = 0
    preemptions: int = 0
    batch_occupancy: float = 0.0
    peak_concurrent: int = 0
    tokens_generated: int = 0
    prefill_tokens: int = 0
    elapsed_s: float = 0.0
    tokens_per_s: float = 0.0
    rejected_queue_full: int = 0
    plan_cache: Dict[str, Any] = dataclasses.field(default_factory=dict)
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    pages_in_use: Optional[int] = None
    peak_pages: Optional[int] = None
    evictions: Optional[int] = None
    prefill_chunks: Optional[int] = None

    def keys(self) -> List[str]:
        return [f.name for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]

    def __getitem__(self, key: str) -> Any:
        v = getattr(self, key, None)
        if v is None:
            raise KeyError(key)
        return v

    def __contains__(self, key: str) -> bool:
        return key in self.keys()

    def get(self, key: str, default: Any = None) -> Any:
        v = getattr(self, key, None)
        return default if v is None else v

    def items(self):
        return [(k, getattr(self, k)) for k in self.keys()]

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.items())


def _upload(arr: np.ndarray, device: torch.device, dtype=None):
    """A device copy of a host array that the host may change afterwards.

    ``torch.tensor`` copies the array first, so the buffer an asynchronous
    upload reads is private to it and never written again (the JAX package's
    engine hands ``jnp.asarray`` the live buffer instead, and races its own
    later in-place writes)."""
    t = torch.tensor(arr, dtype=dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------- engine


class Engine:
    """Slot-based continuous-batching engine over the paged or the dense KV
    layout.

    ``device`` defaults to the card; pass ``device="cpu"`` to run on the CPU
    (the decode kernel's plain version then serves attention).
    """

    def __init__(self, cfg: ArchConfig, ecfg: EngineConfig = EngineConfig(), *,
                 params=None, key: int = 0,
                 plan_cache: Optional[PlanCache] = None,
                 trace: Optional[list] = None, device: DeviceLike = None):
        self.cfg = cfg
        self.ecfg = ecfg
        self.spec = api.family_spec(cfg)
        if ecfg.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {ecfg.kv_layout!r}")
        self.paged = ecfg.kv_layout == "paged"
        for name, default, item in _UNPORTED:
            if getattr(ecfg, name) != default:
                raise NotImplementedError(
                    f"EngineConfig.{name}: {item} is not ported yet")
        if not ecfg.interpret:
            raise ValueError("interpret=False selects the reference's "
                             "compiled Pallas kernel; the port has no "
                             "interpreter to switch off")
        if ecfg.eos_poll_every < 0:
            raise ValueError("eos_poll_every must be >= 0")
        if ecfg.max_queue is not None and ecfg.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (or None = unbounded), "
                             f"got {ecfg.max_queue}")
        if ecfg.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {ecfg.max_retries}")
        if ecfg.telemetry_events < 1:
            raise ValueError(f"telemetry_events must be >= 1, "
                             f"got {ecfg.telemetry_events}")
        self.policy = ecfg.scheduling
        if not isinstance(self.policy, SchedulingPolicy):
            raise ValueError(f"scheduling must be a SchedulingPolicy, "
                             f"got {self.policy!r}")
        if self.policy.prefix_affinity:
            raise NotImplementedError(
                "prefix_affinity scheduling needs the prefix cache, which "
                "is not ported yet (ROADMAP Q1 #9)")
        self._sched_state = SchedulerState(self.policy)
        self._kernel = KernelSpec(attn_impl=ecfg.decode_kernel)
        if self.paged:
            if not self.spec.pageable:
                raise api.CapabilityError(
                    f"paged KV cache: family '{self.spec.key}' does not "
                    f"declare the 'pageable' capability")
            if ecfg.page_size < 1:
                raise ValueError("page_size must be >= 1")
            if ecfg.prefill_chunk:
                if ecfg.prefill_chunk % ecfg.page_size:
                    raise ValueError("prefill_chunk must be a multiple of "
                                     "page_size (chunks write whole pages)")
                bad = [b for b in ecfg.prompt_buckets
                       if b > ecfg.prefill_chunk and b % ecfg.prefill_chunk]
                if bad:
                    raise ValueError(f"prompt buckets {bad} not divisible by "
                                     f"prefill_chunk {ecfg.prefill_chunk}")
        self.device = resolve_device(device)
        if self._kernel.attn_impl == "torch" and self.device.type != "cpu":
            raise ValueError("decode_kernel='torch' is the CPU reference "
                             "path; the card runs the paged-attention kernel")
        self.plan_cache = plan_cache if plan_cache is not None \
            else default_plan_cache()
        self.trace = trace if trace is not None else []

        self.pages_per_slot = -(-ecfg.max_seq // ecfg.page_size)
        self.num_pages = (ecfg.num_pages or ecfg.slots * self.pages_per_slot) \
            if self.paged else 0
        page_geom = (self.num_pages, ecfg.page_size, self.pages_per_slot) \
            if self.paged else None

        # the decode plan: UPIR program -> pass pipeline -> LoweredPlan,
        # cached by canonical fingerprint; page geometry and policy included
        from . import server
        self.shape = ShapeCfg(f"engine_b{ecfg.slots}", "decode",
                              ecfg.max_seq, ecfg.slots)
        self.plan = server.serving_plan(cfg, self.shape, backend=ecfg.backend,
                                        plan_cache=self.plan_cache,
                                        trace=self.trace,
                                        page_geometry=page_geom,
                                        scheduling=self.policy.ext())

        if params is None:
            params = api.init_params(cfg, key, device=self.device)
        self.params = compute_params(cfg, params, self.device)

        # mutable serving state
        if self.paged:
            self.pool = api.init_paged_cache(cfg, self.num_pages,
                                             ecfg.page_size,
                                             device=self.device)
            self.allocator = PagedKVAllocator(self.num_pages)
            self.page_table_np = np.zeros((ecfg.slots, self.pages_per_slot),
                                          np.int32)
            self._slot_pages: List[List[int]] = [[] for _ in
                                                 range(ecfg.slots)]
        else:
            self.cache = api.init_cache(cfg, ecfg.slots, ecfg.max_seq,
                                        device=self.device)
            self._insert = api.build_cache_insert(cfg, ecfg.max_seq)
        dev = self.device
        self.tokens = torch.zeros((ecfg.slots, 1), dtype=torch.int64,
                                  device=dev)
        self.pos = np.zeros((ecfg.slots,), np.int64)
        # the finished mask and the emission counts are device-resident; EOS
        # completion never syncs, and penalties read the counts in place
        self.finished = torch.zeros((ecfg.slots,), dtype=torch.bool,
                                    device=dev)
        self.counts = torch.zeros((ecfg.slots, cfg.vocab), dtype=torch.int32,
                                  device=dev)
        self.keys_np = np.zeros((ecfg.slots, 2), np.int64)   # uint32 words
        self.temps_np = np.zeros((ecfg.slots,), np.float32)
        self.topks_np = np.zeros((ecfg.slots,), np.int64)
        self.topps_np = np.ones((ecfg.slots,), np.float32)
        self.eos_np = np.full((ecfg.slots,), -1, np.int64)
        self.presence_np = np.zeros((ecfg.slots,), np.float32)
        self.frequency_np = np.zeros((ecfg.slots,), np.float32)
        self._policy_dev = None        # device copy, rebuilt only when dirty
        self.queue: Deque[Request] = deque()
        self.slots_req: List[Optional[Request]] = [None] * ecfg.slots
        self._prefilling: Dict[int, Request] = {}
        self._slot_used = [False] * ecfg.slots
        self._toklog: List[Tuple[Any, Tuple[int, ...]]] = []
        self._pending_tokens: Dict[int, List[int]] = {}
        self._rid = 0
        self._admit_counter = 0
        self._activated: List[Request] = []
        self._sync_each_step = False
        self.reset_stats()

    # ------------------------------------------------------------ step fns

    def _policy_tensors(self):
        """Per-slot policy on the device; changes only at admit / finish /
        evict, so steady decode uploads nothing but positions and tables."""
        if self._policy_dev is None:
            dev = self.device
            self._policy_dev = (
                _upload(self.temps_np, dev), _upload(self.topks_np, dev),
                _upload(self.topps_np, dev), _upload(self.eos_np, dev),
                _upload(self.presence_np, dev),
                _upload(self.frequency_np, dev))
        return self._policy_dev

    def _select(self, logits, pos, rows: Sequence[int], counts=None):
        """Decode selection for the batch: host-known policy decides which
        work runs (noise only when a row samples, top-p only when a row
        filters, penalties only when a row is penalized) — the result equals
        the full computation's bitwise."""
        temps, topks, topps, eos, presence, frequency = self._policy_tensors()
        sampled = [i for i in rows if self.temps_np[i] > 0]
        noise = gumbel_noise(self.keys_np, pos, self.cfg.vocab, self.device,
                             rows=sampled) if sampled else None
        use_p = any(self.topps_np[i] < 1.0 for i in sampled)
        pen = any(self.presence_np[i] != 0 or self.frequency_np[i] != 0
                  for i in rows)
        return decode_select(
            logits, noise, temps, topks, eos, self.finished,
            top_ps=topps if use_p else None,
            counts=counts if pen else None,
            presence=presence if pen else None,
            frequency=frequency if pen else None)

    def _sample_first(self, req: Request, logits, last: int):
        """First token from the last prompt position's logits, sampled at
        that position with the request's own key."""
        s = req.sampling or GREEDY
        dev = self.device
        noise = None
        if not s.greedy:
            noise = gumbel_noise([req._key], [last], self.cfg.vocab, dev)
        temps = torch.full((1,), s.temperature, dtype=torch.float32,
                           device=dev)
        topks = torch.full((1,), s.top_k, dtype=torch.int64, device=dev)
        topps = torch.full((1,), s.top_p, dtype=torch.float32, device=dev) \
            if s.top_p < 1.0 else None
        return sample_tokens(logits, noise, temps, topks, topps)

    def _run_prefill(self, req: Request):
        """One-shot prefill of the padded prompt. Returns (first token [1],
        cache-of-one): padded to the prompt's whole pages on the paged
        layout, to the horizon ``max_seq`` on the dense one."""
        toks = _upload(self._padded_prompt(req), self.device)[None, :]
        s_max = self._page_count(req.bucket) * self.ecfg.page_size \
            if self.paged else self.ecfg.max_seq
        logits, cache = api.prefill(self.cfg, self.params, {"tokens": toks},
                                    s_max=s_max)
        return self._sample_first(req, logits[:, -1], req.bucket - 1), cache

    def _page_count(self, tokens: int) -> int:
        return -(-tokens // self.ecfg.page_size)

    # ------------------------------------------------------------ admission

    def _materialize(self, spec: RequestSpec) -> Request:
        """RequestSpec -> validated Request: rid assignment and the PRNG key
        snapshot. Degenerate inputs raise ``ValueError`` here."""
        if spec.eos_id is not None and not 0 <= spec.eos_id < self.cfg.vocab:
            raise ValueError(f"eos_id {spec.eos_id} outside vocab "
                             f"[0, {self.cfg.vocab})")
        if spec.encoder_input is not None:
            raise ValueError(f"family '{self.spec.key}' does not take "
                             f"encoder_input")
        self._rid += 1
        return Request(rid=self._rid, prompt=list(spec.prompt),
                       max_new_tokens=spec.max_new_tokens,
                       sampling=spec.sampling, eos_id=spec.eos_id,
                       tenant=spec.tenant,
                       priority_class=spec.priority_class,
                       deadline_ms=spec.deadline_ms,
                       _key=request_key(spec.sampling or GREEDY, self._rid))

    def submit(self, req: Union[Request, RequestSpec]):
        """Admission control: bounded queue + horizon check. A
        :class:`RequestSpec` is materialized, enqueued and returned (inspect
        ``req.state``/``req.reason``); an already-materialized ``Request``
        returns ``bool`` (False = rejected). Admission is on the *prompt*
        footprint (overcommit); transient exhaustion is handled by eviction.
        """
        if isinstance(req, RequestSpec):
            mat = self._materialize(req)
            self._submit(mat)
            return mat
        return self._submit(req)

    def _submit(self, req: Request) -> bool:
        req.t_submit = time.perf_counter()
        self.submitted += 1
        bucket = next((b for b in sorted(self.ecfg.prompt_buckets)
                       if b >= len(req.prompt)), None)
        if bucket is None:
            return self._reject(req, f"prompt len {len(req.prompt)} exceeds "
                                     f"largest bucket")
        if bucket + req.max_new_tokens > self.ecfg.max_seq:
            return self._reject(req, f"bucket {bucket} + {req.max_new_tokens} "
                                     f"new tokens exceeds max_seq "
                                     f"{self.ecfg.max_seq}")
        if req.max_new_tokens < 1:
            return self._reject(req, "max_new_tokens must be >= 1")
        need = self._page_count(bucket + req.max_new_tokens)
        if self.paged and need > self.num_pages:
            return self._reject(req, f"request needs {need} pages; pool has "
                                     f"{self.num_pages}")
        if self.ecfg.max_queue is not None \
                and len(self.queue) >= self.ecfg.max_queue:
            self.rejected_queue_full += 1
            return self._reject(req, "REJECTED_QUEUE_FULL")
        req.bucket = bucket
        req.state = "queued"
        self.queue.append(req)
        self.trace.append({"event": "submit", "rid": req.rid,
                           "bucket": bucket, "queue_depth": len(self.queue)})
        return True

    def _reject(self, req: Request, reason: str) -> bool:
        req.state, req.reason = "rejected", reason
        self.rejected += 1
        self.trace.append({"event": "reject", "rid": req.rid, "reason": reason})
        return False

    # ------------------------------------------------------------ serving

    def _padded_prompt(self, req: Request) -> np.ndarray:
        toks = np.zeros((req.bucket,), np.int64)
        toks[:len(req.prompt)] = np.asarray(req.prompt, np.int64)
        return toks

    def _mark_admitted(self, req: Request, i: int) -> None:
        recycled = self._slot_used[i]
        if recycled:
            self.recycles += 1
        self._slot_used[i] = True
        self._admit_counter += 1
        req._admit_seq = self._admit_counter
        req.slot = i
        self.admitted += 1
        self._sched_state.charge(req)
        s = req.sampling or GREEDY
        self.keys_np[i] = req._key
        self.temps_np[i] = s.temperature
        self.topks_np[i] = s.top_k
        self.topps_np[i] = s.top_p
        self.eos_np[i] = -1 if req.eos_id is None else req.eos_id
        self.presence_np[i] = s.presence_penalty
        self.frequency_np[i] = s.frequency_penalty
        self.counts[i] = 0
        self._policy_dev = None
        self.trace.append({"event": "admit", "rid": req.rid, "slot": i,
                           "recycled": recycled})

    def _activate(self, req: Request, i: int, nxt0) -> None:
        """Prefill finished: the first token is in hand and the slot joins
        the decode batch (or the request completes outright)."""
        self.tokens[i, 0] = nxt0[0]
        self.pos[i] = req.bucket
        if req.eos_id is not None:
            self.finished[i] = nxt0[0] == req.eos_id
        else:
            self.finished[i] = False
        # the decode step counts tokens[i, 0] for every row, so while this
        # slot sat empty or mid-prefill it gathered phantom counts: zero here
        self.counts[i] = 0
        self.prefills += 1
        req.state = "active"
        req._first_tok = nxt0
        req._remaining = req.max_new_tokens - 1
        if self._sync_each_step:
            # latency mode: stamp TTFT when the first token actually exists
            _sync(self.device)
            req.t_first = time.perf_counter()
        self._activated.append(req)
        if req._remaining <= 0:
            req.slot = i
            self._finish(req)
        else:
            self.slots_req[i] = req

    def _next_index(self) -> Optional[int]:
        """The admission policy's pick from the queue (None = empty)."""
        return select_index(self.policy, self.queue, state=self._sched_state)

    def _growth_reserve(self) -> int:
        """Admission headroom: one free page per running sequence."""
        return sum(1 for r in self.slots_req if r is not None) \
            + len(self._prefilling)

    def _maybe_preempt(self, cand: Request) -> bool:
        """Priority preemption: evict the policy's victim to make room for
        a strictly higher-class queued candidate. Only the paged layout
        preempts: a dense slot's horizon has nothing to hand back."""
        if not self.paged:
            return False
        running = [r for r in self.slots_req if r is not None]
        if not wants_preemption(self.policy, cand, running):
            return False
        if self._evict_victim():
            self.preemptions += 1
            return True
        return False

    def _admit_into_free_slots(self) -> None:
        """Fill free slots from the queue. Dense layout: one-shot prefill
        into each free slot's row of the cache
        (``src/repro/runtime/engine.py:1566``)."""
        if self.paged:
            return self._admit_paged()
        for i in range(self.ecfg.slots):
            while self.slots_req[i] is None and self.queue:
                idx = self._next_index()
                if idx is None:
                    return
                req = self.queue[idx]
                del self.queue[idx]
                self._mark_admitted(req, i)
                nxt0, one = self._run_prefill(req)
                self.cache = self._insert(self.cache, one, i)
                self._activate(req, i, nxt0)

    def _admit_paged(self) -> None:
        while self.queue:
            idx = self._next_index()
            if idx is None:
                return
            req = self.queue[idx]
            i = next((s for s in range(self.ecfg.slots)
                      if self.slots_req[s] is None
                      and s not in self._prefilling), None)
            if i is None:
                if self._maybe_preempt(req):
                    continue
                return
            need = self._page_count(req.bucket)
            if self.allocator.available < need + self._growth_reserve():
                if self._maybe_preempt(req):
                    continue
                return
            pages = self.allocator.alloc(need)
            del self.queue[idx]
            self._slot_pages[i] = pages
            self.page_table_np[i, :] = 0
            self.page_table_np[i, :len(pages)] = pages
            self._mark_admitted(req, i)
            # prompts longer than one chunk prefill incrementally; at or
            # below a chunk, one-shot is strictly cheaper
            if self.ecfg.prefill_chunk and req.bucket > self.ecfg.prefill_chunk:
                req.state = "prefilling"
                req._chunk_cursor = 0
                self._prefilling[i] = req
            else:
                nxt0, one = self._run_prefill(req)
                ids = _upload(np.asarray(pages, np.int64), self.device)
                cache_write_pages(self.pool["k_pages"], one["k"], ids)
                cache_write_pages(self.pool["v_pages"], one["v"], ids)
                self._activate(req, i, nxt0)

    def _prefill_tick(self) -> None:
        """Advance chunked prefill: every prefilling slot moves one chunk per
        step, shortest remaining prompt first."""
        if not self._prefilling:
            return
        chunk = self.ecfg.prefill_chunk
        ps = self.ecfg.page_size
        order = sorted(self._prefilling.items(),
                       key=lambda kv: (kv[1].bucket - kv[1]._chunk_cursor * chunk,
                                       kv[1]._admit_seq))
        for i, req in order:
            off = req._chunk_cursor * chunk
            toks = self._padded_prompt(req)[off:off + chunk]
            ids = self._slot_pages[i][off // ps:(off + chunk) // ps]
            # chunk-sized context gather: only the pages holding previous
            # chunks' K/V, bucketed to powers of two
            width = self._gather_bucket(off // ps)
            dev = self.device
            logits, (k_c, v_c) = api.prefill_chunk(
                self.cfg, self.params, self.pool,
                _upload(self.page_table_np[i][:width], dev),
                {"tokens": _upload(toks, dev)[None, :]}, off)
            ids_dev = _upload(np.asarray(ids, np.int64), dev)
            cache_write_pages(self.pool["k_pages"], k_c, ids_dev)
            cache_write_pages(self.pool["v_pages"], v_c, ids_dev)
            req._chunk_cursor += 1
            self.prefill_chunks += 1
            if off + chunk >= req.bucket:
                del self._prefilling[i]
                nxt = self._sample_first(req, logits[:, -1], off + chunk - 1)
                self._activate(req, i, nxt)

    def _gather_bucket(self, ctx_pages: int) -> int:
        """Context-gather width (in pages) for a chunked-prefill step: the
        next power of two covering the pages already written."""
        if ctx_pages <= 0:
            return 0
        width = 1
        while width < ctx_pages:
            width <<= 1
        return min(width, self.pages_per_slot)

    # ------------------------------------------------------ paged page flow

    def _alloc_one_pressured(self, i: int, req: Request) -> Optional[int]:
        """One page for slot ``i``, evicting the policy's victim under
        pressure. Returns None when ``req`` itself became the victim."""
        while True:
            got = self.allocator.alloc(1)
            if got is not None:
                return got[0]
            if not self._evict_victim():
                raise RuntimeError("paged KV pool exhausted with no evictable "
                                   "sequence")  # unreachable: admission caps size
            if self.slots_req[i] is not req:
                return None

    def _ensure_pages(self) -> None:
        """Before decode, every active slot about to write position ``pos``
        must own the page covering it; oldest requests allocate first, so
        they always make progress under overcommit."""
        order = sorted((i for i in range(self.ecfg.slots)
                        if self.slots_req[i] is not None),
                       key=lambda i: self.slots_req[i]._admit_seq)
        for i in order:
            req = self.slots_req[i]
            if req is None:
                continue               # evicted while growing an older slot
            while self.pos[i] // self.ecfg.page_size \
                    >= len(self._slot_pages[i]):
                page = self._alloc_one_pressured(i, req)
                if page is None:
                    break
                self._slot_pages[i].append(page)
                self.page_table_np[i, len(self._slot_pages[i]) - 1] = page

    def _evict_victim(self) -> bool:
        """Evict one running request (recompute on re-admission)."""
        victims = [r for r in self.slots_req if r is not None]
        if not victims:
            return False
        req = policy_victim(self.policy, victims)
        i = req.slot
        # flush the device token log so the victim's partial stream can be
        # dropped (it is recomputed identically on re-admission)
        self._collect_tokens()
        self._pending_tokens.pop(req.rid, None)
        self.allocator.free(self._slot_pages[i])
        self._slot_pages[i] = []
        self.page_table_np[i, :] = 0
        self.slots_req[i] = None
        self.pos[i] = 0
        req.state, req.slot = "queued", -1
        req._first_tok = None
        req._remaining = 0
        req._chunk_cursor = 0
        req.tokens_out = []
        self._clear_slot_policy(i)
        self.queue.appendleft(req)
        self.evictions += 1
        self.trace.append({"event": "evict", "rid": req.rid, "slot": i})
        return True

    def _clear_slot_policy(self, i: int) -> None:
        self.eos_np[i] = -1
        self.temps_np[i] = 0.0
        self.topps_np[i] = 1.0
        self.presence_np[i] = 0.0
        self.frequency_np[i] = 0.0
        self._policy_dev = None

    def _release_pages(self, req: Request) -> None:
        i = req.slot
        if not self.paged or i < 0 or not self._slot_pages[i]:
            return
        self.allocator.free(self._slot_pages[i])
        self._slot_pages[i] = []
        self.page_table_np[i, :] = 0
        self.pos[i] = 0

    def _device_page_table(self):
        """Decode sees real rows only for active slots; prefilling and free
        slots are masked to the null page."""
        mask = np.fromiter((self.slots_req[i] is not None
                            for i in range(self.ecfg.slots)), bool,
                           self.ecfg.slots)
        return _upload(np.where(mask[:, None], self.page_table_np, 0),
                       self.device, torch.int32)

    # -------------------------------------------------------------- stepping

    def _finish(self, req: Request, reason: str = "") -> None:
        req.state = "done"
        req.t_done = time.perf_counter()
        self.completed += 1
        if reason == "eos":
            req.reason = "eos"
            self.eos_finished += 1
        self.prefill_tokens += 1
        self.tokens_generated += max(
            req.max_new_tokens - 1 - max(req._remaining, 0), 0)
        self._release_pages(req)
        if req.slot >= 0 and self.slots_req[req.slot] is req:
            self.slots_req[req.slot] = None
            self._clear_slot_policy(req.slot)
        self.trace.append({"event": "finish", "rid": req.rid,
                           "slot": req.slot, "reason": reason})

    def _eos_poll(self) -> None:
        """Read the device-side finished mask every ``eos_poll_every``
        decode steps, only while a request with an ``eos_id`` is active."""
        every = self.ecfg.eos_poll_every
        if not every or self.decode_steps % every:
            return
        polled = [i for i in range(self.ecfg.slots)
                  if self.slots_req[i] is not None
                  and self.slots_req[i].state == "active"
                  and self.slots_req[i].eos_id is not None]
        if not polled:
            return
        fin = self.finished.cpu().numpy()
        for i in polled:
            if fin[i]:
                self._finish(self.slots_req[i], reason="eos")

    def check_invariants(self) -> None:
        """Allocator invariants plus the engine's page-table view: slot rows
        mirror ``_slot_pages``, mapped entries are live, and empty slots hold
        no pages. Dense engines have no page state: a no-op there."""
        if not self.paged:
            return
        self.allocator.check_invariants()
        for i in range(self.ecfg.slots):
            row = self._slot_pages[i]
            table = self.page_table_np[i]
            if list(table[:len(row)]) != row:
                raise RuntimeError(f"slot {i} page table "
                                   f"{table[:len(row)].tolist()} != slot "
                                   f"pages {row}")
            if np.any(table[len(row):]):
                raise RuntimeError(f"slot {i} page table maps entries past "
                                   f"its {len(row)} pages")
            dead = [p for p in row if self.allocator.refcount(p) < 1]
            if dead:
                raise RuntimeError(f"slot {i} maps dead pages {dead}")
            if row and self.slots_req[i] is None \
                    and i not in self._prefilling:
                raise RuntimeError(f"empty slot {i} still holds pages {row}")

    def step(self) -> int:
        """One engine iteration: refill free slots and advance chunked
        prefill, then one decode step for the whole batch. Returns the number
        of active slots decoded."""
        self._activated = []
        self._admit_into_free_slots()
        if self.paged:
            self._prefill_tick()
            # cold start / post-drain: nothing to decode yet, so spend the
            # step activating the shortest prompt instead of idling
            while self._prefilling and \
                    not any(r is not None for r in self.slots_req):
                self._prefill_tick()
            self._ensure_pages()
        active = [i for i in range(self.ecfg.slots)
                  if self.slots_req[i] is not None]
        if active:
            dev = self.device
            pos_dev = _upload(self.pos, dev)
            batch = {"tokens": self.tokens, "pos": pos_dev}
            if self.paged:
                logits, self.pool = api.decode_step_paged(
                    self.cfg, self.params, self.pool,
                    self._device_page_table(), batch, kernel=self._kernel)
            else:
                logits, self.cache = api.decode_step(self.cfg, self.params,
                                                     self.cache, batch)
            # count the step's input token (the previous emission) before
            # selecting, so the penalty at position p sees every earlier token
            rows = torch.arange(self.ecfg.slots, device=dev)
            self.counts[rows, self.tokens[:, 0]] += 1
            nxt, self.finished = self._select(logits[:, -1], self.pos, active,
                                              counts=self.counts)
            # a copy: admissions write the next step's input in place, and
            # nxt itself stays in the token log
            self.tokens = nxt[:, None].clone()
            rids = tuple(self.slots_req[i].rid if self.slots_req[i] is not None
                         else -1 for i in range(self.ecfg.slots))
            self._toklog.append((nxt, rids))
            self.decode_steps += 1
            self._occupancy_sum += len(active)
            for i in active:
                self.pos[i] += 1
                self.slots_req[i]._remaining -= 1
            for i in active:
                req = self.slots_req[i]
                if req is not None and req.state == "active" \
                        and req._remaining <= 0:
                    self._finish(req)
            self._eos_poll()
        if self._sync_each_step:
            _sync(self.device)
        elif self._activated:
            now = time.perf_counter()
            for r in self._activated:
                r.t_first = now
        self.peak_concurrent = max(self.peak_concurrent, len(active))
        if self.paged:
            self.peak_pages = max(self.peak_pages, self.allocator.in_use)
        self._tick += 1
        return len(active)

    def run(self, requests: Sequence[Union[Request, RequestSpec]] = (), *,
            max_steps: int = 1_000_000,
            sync_per_step: bool = False) -> List[Request]:
        """Submit ``requests`` and drive the engine until drained; returns the
        materialized ``Request`` objects in submission order.
        ``sync_per_step`` waits for the device each step, so TTFT stamps are
        wall-clock exact (latency mode)."""
        mats: List[Request] = []
        for r in requests:
            if isinstance(r, RequestSpec):
                mats.append(self.submit(r))
            else:
                self.submit(r)
                mats.append(r)
        self._sync_each_step = sync_per_step
        t0 = time.perf_counter()
        steps = 0
        while (self.queue or self._prefilling
                or any(r is not None for r in self.slots_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        _sync(self.device)
        self.elapsed_s += time.perf_counter() - t0
        self._sync_each_step = False
        self._collect_tokens()
        self.trace.append({"event": "stats", **self.stats()})
        self._bound_state()
        return mats

    def _bound_state(self) -> None:
        while len(self._pending_tokens) > self.ecfg.keep_results:
            self._pending_tokens.pop(next(iter(self._pending_tokens)))
        excess = len(self.trace) - self.ecfg.max_trace_events
        if excess > 0:
            del self.trace[:excess]

    def _collect_tokens(self) -> None:
        """Move the device-side token log into per-request outputs: one copy
        to the host after the decode loop, never one per step."""
        if not self._toklog:
            return
        toks = torch.stack([t for t, _ in self._toklog]).cpu().numpy()
        for srow, rids in zip(toks, (r for _, r in self._toklog)):
            for slot, rid in enumerate(rids):
                if rid >= 0:
                    self._pending_tokens.setdefault(rid, []).append(
                        int(srow[slot]))
        self._toklog = []

    def finalize_request(self, req: Request) -> List[int]:
        """First token (from prefill) + decode-step tokens, truncated at the
        first EOS (inclusive) for requests with an ``eos_id``."""
        if not req.tokens_out:
            self._collect_tokens()
            out: List[int] = []
            if req._first_tok is not None:
                out.append(int(req._first_tok[0]))
                req._first_tok = None
            out.extend(self._pending_tokens.pop(req.rid, []))
            if req.eos_id is not None and req.eos_id in out:
                out = out[:out.index(req.eos_id) + 1]
            req.tokens_out = out
        return req.tokens_out

    # -------------------------------------------------------------- stats

    def reset_stats(self) -> None:
        """Zero the counters — call after warmup."""
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_chunks = 0
        self.recycles = 0
        self.rejected = 0
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.eos_finished = 0
        self.evictions = 0
        self.preemptions = 0
        self.tokens_generated = 0
        self.prefill_tokens = 0
        self.peak_concurrent = 0
        self.peak_pages = 0
        self.rejected_queue_full = 0
        self._tick = 0
        self._occupancy_sum = 0
        self.elapsed_s = 0.0

    def stats(self) -> EngineStats:
        occ = (self._occupancy_sum / self.decode_steps / self.ecfg.slots
               if self.decode_steps else 0.0)
        out = EngineStats(
            queue_depth=len(self.queue),
            active_slots=sum(1 for r in self.slots_req if r is not None),
            slots=self.ecfg.slots,
            kv_layout=self.ecfg.kv_layout,
            capabilities=list(self.spec.capabilities),
            policy=self.policy.describe(),
            decode_steps=self.decode_steps,
            prefills=self.prefills,
            recycles=self.recycles,
            submitted=self.submitted,
            admitted=self.admitted,
            completed=self.completed,
            eos_finished=self.eos_finished,
            rejected=self.rejected,
            preemptions=self.preemptions,
            batch_occupancy=occ,
            peak_concurrent=self.peak_concurrent,
            tokens_generated=self.tokens_generated,
            prefill_tokens=self.prefill_tokens,
            elapsed_s=self.elapsed_s,
            tokens_per_s=(self.tokens_generated / self.elapsed_s
                          if self.elapsed_s else 0.0),
            rejected_queue_full=self.rejected_queue_full,
            plan_cache=self.plan_cache.stats())
        if self.paged:
            out.page_size = self.ecfg.page_size
            out.num_pages = self.num_pages
            out.pages_in_use = self.allocator.in_use
            out.peak_pages = self.peak_pages
            out.evictions = self.evictions
            out.prefill_chunks = self.prefill_chunks
        return out


# ------------------------------------------------------- sequential baseline


def serve_sequential(cfg: ArchConfig, params,
                     requests: Sequence[Union[Request, RequestSpec]], *,
                     max_seq: int, prompt_buckets: Tuple[int, ...] = (16, 32, 64),
                     page_size: int = 16, warmup: bool = True,
                     kv_layout: Optional[str] = None,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """One request at a time: a B=1 one-shot prefill, then a decode loop of
    the one request over a private cache: a paged pool (``kv_layout=
    "paged"``, the default for a pageable family) or a dense cache of
    ``DECODE_ROW_MULTIPLE`` rows whose first row is the request's
    (``"dense"``, the default otherwise, as in the reference's
    ``serve_sequential``). Pads prompts to the same buckets as the engine,
    so token streams are comparable; it is the engine's oracle.

    :class:`RequestSpec` entries are materialized with ``rid = position + 1``
    — the rids a fresh :class:`Engine` assigns the same sequence — so PRNG
    key schedules line up. Returns per-request tokens + throughput (decode
    tokens only; first tokens are tallied in ``prefill_tokens``).
    """
    dev = resolve_device(device)
    params = compute_params(cfg, params, dev)
    mats: List[Request] = []
    for i, r in enumerate(requests):
        if isinstance(r, RequestSpec):
            mats.append(Request(
                rid=i + 1, prompt=list(r.prompt),
                max_new_tokens=r.max_new_tokens, sampling=r.sampling,
                eos_id=r.eos_id, tenant=r.tenant,
                priority_class=r.priority_class, deadline_ms=r.deadline_ms,
                _key=request_key(r.sampling or GREEDY, i + 1)))
        else:
            mats.append(r)
    if kv_layout is None:
        kv_layout = "paged" if api.supports_paged_kv(cfg) else "dense"
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                         f"got {kv_layout!r}")
    paged = kv_layout == "paged"
    if paged:
        pps = -(-max_seq // page_size)
        pool = api.init_paged_cache(cfg, pps, page_size, device=dev)
        page_ids = torch.arange(1, pps + 1, device=dev)
        table = page_ids.to(torch.int32)[None, :]
    else:
        rows = DECODE_ROW_MULTIPLE
        cache = api.init_cache(cfg, rows, max_seq, device=dev)
        insert = api.build_cache_insert(cfg, max_seq)
        step_toks = torch.zeros((rows, 1), dtype=torch.int64, device=dev)
        step_pos = torch.zeros((rows,), dtype=torch.int64, device=dev)

    def prefill_one(toks, bucket):
        if not paged:
            logits, one_c = api.prefill(cfg, params, {"tokens": toks[None, :]},
                                        s_max=max_seq)
            insert(cache, one_c, 0)
            return logits
        n_pages = -(-bucket // page_size)
        logits, one_c = api.prefill(cfg, params, {"tokens": toks[None, :]},
                                    s_max=n_pages * page_size)
        cache_write_pages(pool["k_pages"], one_c["k"], page_ids[:n_pages])
        cache_write_pages(pool["v_pages"], one_c["v"], page_ids[:n_pages])
        return logits

    def decode_one(tok, p):
        if not paged:
            step_toks[0] = tok
            step_pos[0] = p
            logits, _ = api.decode_step(cfg, params, cache,
                                        {"tokens": step_toks, "pos": step_pos})
            return logits[:1]
        pos = torch.full((1,), p, dtype=torch.int64, device=dev)
        logits, _ = api.decode_step_paged(cfg, params, pool, table,
                                          {"tokens": tok[:, None], "pos": pos})
        return logits

    def one(req, bucket, toks):
        s = req.sampling or GREEDY
        key = req._key if req._key is not None else request_key(s, req.rid)
        temps = torch.full((1,), s.temperature, dtype=torch.float32,
                           device=dev)
        topks = torch.full((1,), s.top_k, dtype=torch.int64, device=dev)
        topps = torch.full((1,), s.top_p, dtype=torch.float32, device=dev) \
            if s.top_p < 1.0 else None
        pen = s.penalized
        presence = torch.full((1,), s.presence_penalty, dtype=torch.float32,
                              device=dev)
        frequency = torch.full((1,), s.frequency_penalty,
                               dtype=torch.float32, device=dev)

        def select(lg, p, counts=None):
            noise = None if s.greedy else gumbel_noise([key], [p], cfg.vocab,
                                                       dev)
            return sample_tokens(lg, noise, temps, topks, topps,
                                 counts=counts if pen else None,
                                 presence=presence, frequency=frequency)

        logits = prefill_one(toks, bucket)
        gen = [select(logits[:, -1], bucket - 1)]
        counts = torch.zeros((1, cfg.vocab), dtype=torch.int32, device=dev)
        hit_eos = req.eos_id is not None and int(gen[0][0]) == req.eos_id
        if not hit_eos:
            for i in range(req.max_new_tokens - 1):
                p = bucket + i
                logits = decode_one(gen[-1], p)
                counts[0, gen[-1][0]] += 1
                gen.append(select(logits[:, -1], p, counts))
                if req.eos_id is not None and int(gen[-1][0]) == req.eos_id:
                    break
        return gen

    def bucket_of(req):
        return next((b for b in sorted(prompt_buckets)
                     if b >= len(req.prompt)), None)

    if warmup and mats:
        by_bucket = {}
        for r in mats:
            b = bucket_of(r)
            if b is not None and b + r.max_new_tokens <= max_seq:
                by_bucket.setdefault(b, r)
        for b, r in by_bucket.items():
            one(dataclasses.replace(r, max_new_tokens=2, eos_id=None), b,
                torch.zeros((b,), dtype=torch.int64, device=dev))
        _sync(dev)

    outputs: Dict[int, List[int]] = {}
    total = prefill_tokens = rejected = 0
    t0 = time.perf_counter()
    for req in mats:
        bucket = bucket_of(req)
        if bucket is None:
            req.state, req.reason = "rejected", \
                f"prompt len {len(req.prompt)} exceeds largest bucket"
            rejected += 1
            continue
        if bucket + req.max_new_tokens > max_seq:
            req.state, req.reason = "rejected", \
                f"bucket {bucket} + {req.max_new_tokens} new tokens exceeds " \
                f"max_seq {max_seq}"
            rejected += 1
            continue
        toks = np.zeros((bucket,), np.int64)
        toks[:len(req.prompt)] = np.asarray(req.prompt, np.int64)
        gen = one(req, bucket, _upload(toks, dev))
        outputs[req.rid] = [int(t) for t in torch.cat(gen).cpu()]
        req.state = "done"
        prefill_tokens += 1
        total += len(gen) - 1
    _sync(dev)
    elapsed = time.perf_counter() - t0
    return {"tokens": outputs, "tokens_generated": total,
            "prefill_tokens": prefill_tokens,
            "served": len(outputs), "rejected": rejected,
            "elapsed_s": elapsed,
            "tokens_per_s": total / elapsed if elapsed else 0.0}
