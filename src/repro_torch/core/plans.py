"""Model-step planners: (arch config x shape) -> UPIR program (PyTorch port).

The port's copy of the JAX package's planner, kept op for op so both packages
build the *same* program — the same text and ``program_fingerprint`` — for the
same (config, shape, engine mode). Family differences enter only through the
data-distribution rule table. Training programs need the optimizer's state
shapes and wait for the training slice; ``act_shardings`` and ``make_plan``
wait for the distributed slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..configs.base import ArchConfig, ShapeCfg, input_specs
from ..models import api
from . import ir
from .builder import PlanBuilder
from .lower import tree_symbols

HBM_BYTES = 16 * 2**30          # the reference planner's per-chip memory figure


# ------------------------------------------------------------- mesh definitions


def mesh_axes(multi_pod: bool) -> Tuple[Tuple[str, int], ...]:
    return ((("pod", 2),) if multi_pod else ()) + (("data", 16), ("model", 16))


def dp_axis(multi_pod: bool) -> str:
    return "pod+data" if multi_pod else "data"


# ------------------------------------------------------- distribution rule table


def dist_rules(cfg: ArchConfig, shape: ShapeCfg, multi_pod: bool,
               fsdp: bool = True) -> Tuple:
    """Ordered (pattern, candidates) table; first matching pattern wins, each
    candidate is (dim, axis) accepted only if divisible (propagate pass)."""
    dp = dp_axis(multi_pod)
    fa = "data" if fsdp else None   # FSDP shard axis for params/moments

    def p(*cands):
        return tuple((d, a) for d, a in cands if a is not None)

    rules = [
        # adafactor factored stats are tiny: replicate
        ("*/vr", ()), ("*/vc", ()),
        # ---- inputs
        ("in/tokens", p((0, dp))),
        ("in/draft_tokens", p((0, dp))),
        ("in/targets", p((0, dp))),
        ("in/pos", p((0, dp))),
        ("in/*_embeds", p((0, dp))),
        ("in/encoder_memory", p((0, dp))),
        # ---- paged decode caches (before the dense cache rules): the pool
        #      [L, NP, PS, KV, hd] has no batch dim — pages shard over model
        #      (the paged analogue of flash-decode seq worksharing); the page
        #      table is tiny control state and stays replicated
        ("cache/*_pages", p((1, "model"))),
        ("cache/page_table", ()),
        # ---- decode caches: batch over data, seq (or width) over model
        ("cache/xk", p((1, dp))),
        ("cache/xv", p((1, dp))),
        ("cache/k", p((1, dp), (2, "model"))),
        ("cache/v", p((1, dp), (2, "model"))),
        ("cache/conv", p((1, dp), (3, "model"))),
        ("cache/ssm", p((1, dp), (2, "model"), (3, "model"))),
        ("cache/blocks/*/C", p((0, dp), (2, "model"))),
        ("cache/blocks/*", p((0, dp), (1, "model"))),
        # ---- MoE (before generic mlp rules): experts over model if divisible
        #      (phi3.5: 16e <-> 16-way EP), else d_ff over model (grok: expert-TP)
        ("*moe/router", ()),
        ("*moe/w1", p((1, "model"), (-1, "model"), (-2, fa))),
        ("*moe/w3", p((1, "model"), (-1, "model"), (-2, fa))),
        ("*moe/w2", p((1, "model"), (-2, "model"), (-1, fa))),
        # ---- Mamba2
        ("*mamba/w_x", p((-1, "model"), (-2, fa))),
        ("*mamba/w_z", p((-1, "model"), (-2, fa))),
        ("*mamba/w_bc", ()),
        ("*mamba/w_dt", p((-1, "model"),)),
        ("*mamba/conv_w", p((-1, "model"),)),
        ("*mamba/out_norm", p((-1, "model"),)),
        ("*mamba/w_out", p((-2, "model"), (-1, fa))),
        # ---- xLSTM
        ("*w_up", p((-1, "model"), (-2, fa))),
        ("*w_down", p((-2, "model"), (-1, fa))),
        ("*w_if", ()), ("*b_if", ()), ("*/r", ()),
        ("*w_in", p((-1, "model"), (-2, fa))),
        # ---- attention (wq/wk/wv/xq/xk/xv + wo/xo)
        ("*[wx][qkv]", p((-1, "model"), (-2, fa))),
        ("*[wx]o", p((-2, "model"), (-1, fa))),
        # ---- embeddings/head: vocab over model (the lookup is a one-hot dot
        #      in distributed mode — see layers.embed_lookup — so vocab-dim
        #      sharding partitions cleanly for lookup AND logits)
        ("*lm_head", p((-1, "model"), (-2, fa))),
        ("*embed", p((0, "model"), (1, fa))),
        # ---- dense MLP
        ("*mlp/w1", p((-1, "model"), (-2, fa))),
        ("*mlp/w3", p((-1, "model"), (-2, fa))),
        ("*mlp/w2", p((-2, "model"), (-1, fa))),
        ("*/w1", p((-1, "model"), (-2, fa))),
        ("*/w2", p((-2, "model"), (-1, fa))),
        ("*/w3", p((-1, "model"), (-2, fa))),
        # ---- outputs
        ("out/logits", p((0, dp), (2, "model"))),
        ("out/*", ()),
        # ---- everything else (norms, scalars, counters): replicated
        ("*", ()),
    ]
    return tuple(rules)


# ------------------------------------------------------------ size estimation


def _microbatches(cfg: ArchConfig, shape: ShapeCfg, multi_pod: bool) -> int:
    if shape.kind != "train":
        return 1
    dp = 32 if multi_pod else 16
    per_replica = max(shape.global_batch // dp, 1)
    n = cfg.param_count()
    # Per-(layer x microbatch) FSDP weight gathers scale linearly with the
    # microbatch count; with sequence-parallel boundaries + full remat even
    # the 405B step fits at mb=1 (EXPERIMENTS.md §Perf T1: 8.2x on llama3).
    # MoE is the exception: dispatch working sets grow with per-microbatch
    # tokens, so MoE archs keep accumulation (§Perf M1).
    if cfg.moe is not None and n > 20e9:
        return min(8, per_replica)
    if n > 20e9:
        return 1
    return min(2, per_replica)


def _bytes_estimates(cfg: ArchConfig, shape: ShapeCfg, multi_pod: bool,
                     microbatches: int) -> Tuple[int, int]:
    """(act_bytes, resident_bytes) per device, rough napkin numbers for the
    UPIR memory pass (which picks the remat policy)."""
    chips = 512 if multi_pod else 256
    dp = 32 if multi_pod else 16
    tp = 16
    n = cfg.param_count()
    pbytes = 2 if cfg.param_dtype == "bfloat16" else 4
    resident = int(n * pbytes / chips)
    if shape.kind == "train":
        if cfg.optimizer == "adamw":
            resident += int(n * 8 / chips)
        else:
            resident += int(n * 4 / max(cfg.d_model, 1) / chips) * 2
        tokens_mb = shape.global_batch * shape.seq_len // dp // microbatches
        # ~10 live activations of width d_model per layer without remat
        act = int(cfg.n_layers * tokens_mb * cfg.d_model * 10 * 2 / tp)
    else:
        act = int(cfg.n_layers * shape.global_batch // max(dp, 1)
                  * cfg.d_model * 4 * 2 / tp)
    return act, resident


# ----------------------------------------------------------------- the planner


def build_program(cfg: ArchConfig, shape: ShapeCfg, *, multi_pod: bool = False,
                  fsdp: bool = True, compression: Optional[str] = None,
                  overlap: bool = True, extra_ext: Optional[Dict] = None,
                  microbatches: Optional[int] = None,
                  page_geometry: Optional[Tuple[int, int, int]] = None,
                  prefix_sharing: bool = False,
                  spec_decode: Optional[Tuple[str, int]] = None,
                  scheduling: Optional[Dict[str, Any]] = None,
                  fault_tolerant: bool = False,
                  traced: bool = False,
                  tiering: Optional[int] = None,
                  disaggregated: bool = False,
                  verify: bool = False
                  ) -> ir.Program:
    """Express the train/serve step of (cfg, shape) as a UPIR program.

    ``page_geometry=(num_pages, page_size, pages_per_slot)`` switches a decode
    program to the paged-KV layout: the cache symbols become the physical page
    pool + page table, the cache data attribute carries the geometry as an
    explicit memory-management annotation (``paged_kv_alloc``), and
    ``alloc_pages``/``free_pages`` MemOps make the allocator lifecycle part of
    the IR — all of which the printer fingerprints, so page geometry
    participates in the PlanCache key exactly like shapes do.

    ``prefix_sharing=True`` (paged decode only) additionally marks the pool
    as prefix-shared: the cache data attribute gains the
    ``mm(shared_prefix)`` annotation and the program carries ``share`` /
    ``cow`` MemOps — ref-counted page aliasing with copy-on-write
    duplication is part of the memory-management contract, so a
    sharing-enabled engine fingerprints (and plan-caches) apart from a
    sharing-disabled one of the same geometry.

    ``spec_decode=(draft_name, lookahead_k)`` turns a decode program into the
    **speculative verify** step: the token input widens to the k+1-position
    chunk, the kernel becomes ``spec_verify``, and the draft/target pairing
    is carried as capability extensions on the cache data attribute
    (``caps(spec_verify(k) draft(name))`` in the printed dialect) — so the
    verify plan fingerprints apart from the plain decode plan and the
    PlanCache never conflates them.

    ``scheduling`` (decode only) attaches an admission-scheduling annotation
    — ``runtime.scheduling.SchedulingPolicy.ext()`` — to the decode cache's
    data attribute, rendered as ``sched(...)`` next to ``mm(...)`` /
    ``caps(...)``: the order requests are admitted and preempted is a
    declarative execution decision, so engines running different policies
    fingerprint (and plan-cache) apart. ``None`` (the default) emits no
    annotation and leaves every pre-scheduling fingerprint unchanged.

    ``fault_tolerant=True`` (decode only) marks the cache's memory contract
    as fault-tolerant: the data attribute gains ``mm(fault_tolerant)`` and
    the program carries ``snapshot``/``restore`` MemOps — the device↔host
    state movement a recovering engine performs (``Engine.snapshot()`` for
    crash-restart resume, quarantine + replay for poisoned slots) is part
    of the memory-management contract, so an FT-enabled engine fingerprints
    (and plan-caches) apart from a plain one of the same geometry.

    ``traced=True`` (decode only) marks the program as instrumented: the
    cache's data attribute gains ``mm(traced)`` and the program carries a
    ``upir.trace_emit`` op — the host-side request-lifecycle telemetry a
    traced engine records (``runtime.telemetry``) is a declared program
    capability, so a telemetry-enabled engine fingerprints (and
    plan-caches) apart from an identical engine with telemetry off.

    ``tiering=N`` (paged decode only) marks the pool as memory-tiered: the
    cache's data attribute gains ``mm(tiered(N))`` — N is the host-pool
    page capacity — and the program carries the device↔host
    ``upir.kv_transfer`` ops (spill of cold refcount-1 prefix pages to the
    host tier, page-in on a later hit). Spill/page-in is pure data
    movement, never recompute, so a tiered engine's streams stay bitwise
    identical — but its plan fingerprints apart.

    ``disaggregated=True`` (paged decode only) marks the pool topology as
    disaggregated prefill/decode: the cache's data attribute gains
    ``mm(disaggregated)`` and the program carries the prefill→decode
    ``upir.kv_transfer`` hand-off ops — finished prefill KV moves across
    pools instead of being produced in place, which fingerprints the plan
    apart from a unified-pool engine of the same geometry.

    ``verify=True`` asks for the static verifier, which this package has not
    ported yet: it raises ``NotImplementedError``.
    """
    if verify:
        raise NotImplementedError(
            "verify=True runs the static UPIR verifier, which is not ported "
            "yet (ROADMAP Q1 #13)")
    axes = mesh_axes(multi_pod)
    dp = dp_axis(multi_pod)
    mb = microbatches if microbatches else _microbatches(cfg, shape, multi_pod)
    act, resident = _bytes_estimates(cfg, shape, multi_pod, mb)
    paged = page_geometry is not None and shape.kind == "decode"
    ft = bool(fault_tolerant) and shape.kind == "decode"
    tr = bool(traced) and shape.kind == "decode"
    tier = int(tiering) if (tiering and paged) else 0
    disagg = bool(disaggregated) and paged
    spec = spec_decode if (spec_decode is not None
                           and shape.kind == "decode") else None
    sched: Dict[str, Any] = {}
    if scheduling is not None and shape.kind == "decode":
        from .printer import SCHED_EXT_KEYS
        bad = [k for k in scheduling if k not in SCHED_EXT_KEYS]
        if bad:
            raise ValueError(f"unknown scheduling annotation keys {bad}; "
                             f"printable keys are {SCHED_EXT_KEYS}")
        sched = dict(scheduling)

    b = PlanBuilder(f"{cfg.name}@{shape.name}")
    b.mesh(axes, teams=("pod",) if multi_pod else (),
           units=("data", "model"))
    b.target("tpu")

    # symbols: the full state/input tree
    symbols = _symbols(cfg, shape,
                       page_geometry=page_geometry if paged else None,
                       spec_decode=spec)
    for name, (shp, dt) in symbols.items():
        b.symbol(name, shp, dt)

    # loops
    b.worksharing_loop("batch", shape.global_batch, dp)
    if shape.kind == "train":
        if mb > 1:
            b.taskloop("microbatch", mb, num_tasks=mb)
        b.loop("layer", cfg.n_layers, scan=True)
        b.simd_loop("model_dim", cfg.d_model, simdlen=128,
                    block=(512, 1024))
        # gradient reduction: the paper's async-collective split applies here
        grad_ext: Dict[str, Any] = {"overlap_candidate": bool(overlap and mb > 1)}
        if compression:
            grad_ext["compression"] = compression
        b.sync("allreduce", axes=tuple(a for a in (("pod", "data") if multi_pod
                                                   else ("data",))),
               operation="add", data=("grads",), **grad_ext)
        b.kernel("train_step", ("state", "in"))
    else:
        if shape.kind == "decode":
            # flash-decode: KV sequence workshared over the model axis
            b.worksharing_loop("seq", shape.seq_len, "model")
        b.loop("layer", cfg.n_layers, scan=True)
        b.simd_loop("model_dim", cfg.d_model, simdlen=128, block=(512, 1024))
        if shape.kind == "prefill":
            kernel = "prefill"
        elif spec is not None:
            # the verify step is the task-parallel half of the draft/verify
            # pair: one batched kernel scoring all k+1 chunk positions
            kernel = "spec_verify"
        else:
            kernel = "decode_step"
        b.kernel(kernel, ("params", "cache", "in"))

    # data attributes: mark state as tofrom (donated), params read-only at serve
    if shape.kind == "train":
        b.data("state", mapping="tofrom", access="read-write", fsdp=fsdp)
        # grads are produced privately per unit, then reduced; fsdp tags them
        # for the ZeRO (reduce_scatter + all_gather) rewrite in fuse_sync
        b.data("grads", sharing="private", access="read-write", fsdp=fsdp)
    else:
        b.data("params", mapping="to", access="read-only")
        # ModelFamily capability flags (api.FamilySpec) become data-attribute
        # extensions on the decode cache: the printer renders them as
        # caps(...), so capability-driven dispatch participates in the
        # canonical fingerprint — and therefore the PlanCache key — exactly
        # like shapes and page geometry do.
        caps = {f: True for f in api.family_spec(cfg).capabilities}
        if spec is not None:
            # the draft/target pairing is part of the serving contract: a
            # verify plan for one draft (or one lookahead) must never be
            # served for another, so both fingerprint via caps(...)
            draft_name, lookahead_k = spec
            caps.update(spec_verify=int(lookahead_k), draft=str(draft_name))
        if shape.kind == "decode" and paged:
            npages, ps, pps = page_geometry
            mm: Dict[str, Any] = dict(page_size=ps, num_pages=npages,
                                      pages_per_slot=pps)
            if prefix_sharing:
                mm["shared_prefix"] = True
            if ft:
                mm["fault_tolerant"] = True
            if tr:
                mm["traced"] = True
            if tier:
                mm["tiered"] = tier
            if disagg:
                mm["disaggregated"] = True
            b.data("cache", mapping="tofrom", access="read-write",
                   allocator="paged_kv_alloc", **mm, **caps)
            if sched:
                b.sched("cache", **sched)
            # the page table IS the explicit data-movement plan: logical
            # position -> physical page, shipped to the device every step
            b.data("cache/page_table", mapping="to", access="read-only",
                   page_map=True)
            # MemOps appear in lifecycle order — alloc, alias/duplicate,
            # snapshot/restore, dealloc — because the static lifetime pass
            # (the reference package's analysis.lifetime) interprets the
            # sequence abstractly:
            # aliasing or snapshotting a pool after its dealloc is a
            # use-after-dealloc diagnostic, exactly as it would be at runtime
            b.alloc("cache/k_pages", allocator="paged_kv_alloc",
                    num_pages=npages, page_size=ps)
            b.alloc("cache/v_pages", allocator="paged_kv_alloc",
                    num_pages=npages, page_size=ps)
            if prefix_sharing:
                # prefix caching: admission may alias (ref-count) another
                # sequence's prompt-prefix pages instead of allocating +
                # re-prefilling, and a write into a shared page duplicates
                # it first — both are explicit memory ops in the IR
                b.share("cache/k_pages", allocator="paged_kv_alloc",
                        shared_prefix=True)
                b.share("cache/v_pages", allocator="paged_kv_alloc",
                        shared_prefix=True)
                b.cow("cache/k_pages", allocator="paged_kv_alloc")
                b.cow("cache/v_pages", allocator="paged_kv_alloc")
            if tier:
                # tiered KV: at refcount-1 reclaim a cold prefix page spills
                # device→host instead of being dropped; a later hit pages it
                # back host→device before the chunk cursor reaches it. Both
                # directions are explicit cross-pool movement ops — pure
                # movement, never recompute
                b.kv_transfer("cache/k_pages", allocator="paged_kv_alloc",
                              src_pool="device", dst_pool="host")
                b.kv_transfer("cache/v_pages", allocator="paged_kv_alloc",
                              src_pool="device", dst_pool="host")
                b.kv_transfer("cache/k_pages", allocator="paged_kv_alloc",
                              src_pool="host", dst_pool="device")
                b.kv_transfer("cache/v_pages", allocator="paged_kv_alloc",
                              src_pool="host", dst_pool="device")
            if disagg:
                # disaggregated prefill/decode: finished prefill KV hands
                # off prefill-pool → decode-pool, one explicit movement op
                # per pool half
                b.kv_transfer("cache/k_pages", allocator="paged_kv_alloc",
                              src_pool="prefill", dst_pool="decode")
                b.kv_transfer("cache/v_pages", allocator="paged_kv_alloc",
                              src_pool="prefill", dst_pool="decode")
            if ft:
                # fault tolerance: the pool (and page tables, carried by the
                # engine alongside) can round-trip through host buffers for
                # crash-restart resume — explicit d2h/h2d memory ops
                b.snapshot("cache/k_pages", allocator="paged_kv_alloc")
                b.snapshot("cache/v_pages", allocator="paged_kv_alloc")
                b.restore("cache/k_pages", allocator="paged_kv_alloc")
                b.restore("cache/v_pages", allocator="paged_kv_alloc")
            if tr:
                # telemetry: the engine records host-side lifecycle events
                # against the cache — an explicit instrumentation point, so
                # traced engines fingerprint apart (contract SC007/SC008)
                b.trace_emit("cache")
            # sequences release their pages on completion/eviction
            b.dealloc("cache/k_pages", allocator="paged_kv_alloc")
            b.dealloc("cache/v_pages", allocator="paged_kv_alloc")
        elif shape.kind == "decode":
            dense_mm: Dict[str, Any] = {}
            if ft:
                dense_mm["fault_tolerant"] = True
            if tr:
                dense_mm["traced"] = True
            b.data("cache", mapping="tofrom", access="read-write",
                   **dense_mm, **caps)
            if sched:
                b.sched("cache", **sched)
            if ft:
                b.snapshot("cache")
                b.restore("cache")
            if tr:
                b.trace_emit("cache")
            if caps.get("needs_encoder_memory"):
                # the per-slot encoder-memory buffer is an explicit decode
                # input: filled once at admission, read-only every step
                b.data("in/encoder_memory", mapping="to",
                       access="read-only", encoder_memory=True)

    b.extension(
        dist_rules=dist_rules(cfg, shape, multi_pod, fsdp=fsdp),
        act_bytes=act, resident_bytes=resident, hbm_bytes=HBM_BYTES,
        arch=cfg.name, shape=shape.name, kind=shape.kind,
        multi_pod=multi_pod, fsdp=fsdp,
        **(extra_ext or {}))
    return b.build()


def _symbols(cfg: ArchConfig, shape: ShapeCfg,
             page_geometry: Optional[Tuple[int, int, int]] = None,
             spec_decode: Optional[Tuple[str, int]] = None
             ) -> Dict[str, Tuple]:
    """Flattened symbol table for state + inputs + outputs of this cell."""
    symbols: Dict[str, Tuple] = {}
    pspecs = api.param_specs(cfg)
    if shape.kind == "train":
        raise NotImplementedError(
            "train programs need the optimizer state's shapes; they arrive "
            "with the training slice (ROADMAP Q1 #12)")
    else:
        symbols.update(tree_symbols({"params": pspecs}))
        if shape.kind == "decode" and page_geometry is not None:
            npages, ps, pps = page_geometry
            cspecs = api.paged_cache_specs(cfg, npages, ps)
            symbols.update(tree_symbols({"cache": cspecs}))
            symbols["cache/page_table"] = ((shape.global_batch, pps), "int32")
        elif shape.kind in ("decode", "prefill"):
            # prefill *emits* the cache (same symbols, same sharding rules as
            # decode — the hand-off never reshards), so the cache belongs in
            # its symbol table too: the verifier requires every kernel arg to
            # resolve to a declared datum
            cspecs = api.cache_specs(cfg, shape.global_batch, shape.seq_len)
            symbols.update(tree_symbols({"cache": cspecs}))
    for k, v in input_specs(cfg, shape).items():
        symbols[f"in/{k}"] = v
    if shape.kind != "train":
        V = cfg.vocab
        B = shape.global_batch
        width = 1
        if spec_decode is not None and shape.kind == "decode":
            # the verify chunk: last emitted token + k draft proposals per
            # slot, scored (and cache-written) in one call
            width = int(spec_decode[1]) + 1
            symbols["in/tokens"] = ((B, width), "int32")
            symbols["in/draft_tokens"] = ((B, width - 1), "int32")
        symbols["out/logits"] = ((B, width, V), cfg.compute_dtype)
    return symbols
