"""Fingerprinted extension-key tables — the single source of truth.

The printer renders three annotation namespaces into the canonical program
text (and therefore into ``program_fingerprint`` / the PlanCache key):
``mm(...)`` memory-management keys, ``caps(...)`` ModelFamily capability
keys, and ``sched(...)`` admission-scheduling keys. Every key is declared
**once** here, as introspectable data (a copy of the JAX package's table, so
both packages print the same program text):

  * ``printer.py`` derives its rendering order from these tables;
  * the JAX package's well-formedness pass (``analysis.wellformed``)
    accepts exactly these keys — a typo'd annotation key is a hard
    diagnostic (``WF002``) instead of a silently-unfingerprinted no-op.

``ENGINE_DATA_KEYS`` / ``MEMOP_KEYS`` / ``SYNC_KEYS`` / ``LOOP_KEYS`` list
the *non-fingerprinted* extension keys the planner and the pass pipeline
are allowed to attach to IR nodes; anything outside these vocabularies is
malformed by construction.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ExtKey:
    """One documented, fingerprinted extension key.

    ``valued`` keys render as ``key(value)``; flag keys render bare.
    ``doc`` is the one-line meaning shown in docs and diagnostics.
    """

    key: str
    doc: str
    valued: bool = False


# --------------------------------------------------------------- mm() keys
# Memory-management annotations on a data attribute. Paged-KV geometry must
# distinguish plans the same way shapes do, so a PlanCache warmed at one
# page size never serves another; ``shared_prefix`` marks prefix-shared
# (ref-counted, copy-on-write) KV pages; ``fault_tolerant`` marks the
# snapshot/restore crash-recovery contract.

MM_KEY_TABLE: Tuple[ExtKey, ...] = (
    ExtKey("page_size", "tokens per physical KV page", valued=True),
    ExtKey("num_pages", "allocatable pages in the physical pool", valued=True),
    ExtKey("pages_per_slot", "page-table width per decode slot", valued=True),
    ExtKey("page_map", "this datum is the logical->physical page table"),
    ExtKey("shared_prefix",
           "pool pages may be ref-count aliased across sequences (CoW)"),
    ExtKey("fault_tolerant",
           "pool state round-trips through host snapshot/restore buffers"),
    ExtKey("traced",
           "request-lifecycle instrumentation points (upir.trace_emit) are "
           "part of the program — a telemetry-enabled engine"),
    ExtKey("tiered",
           "cold prefix pages spill to a ref-counted host pool of this many "
           "pages and page back in (upir.kv_transfer) on a later hit",
           valued=True),
    ExtKey("disaggregated",
           "prefill and decode run as separate workers over separate pools; "
           "finished prefill KV hands off via upir.kv_transfer"),
)

# ------------------------------------------------------------- caps() keys
# ModelFamily capability flags (models.api.FamilySpec) carried by the
# decode cache's data attribute: capability-driven dispatch is part of the
# serving contract, so two plans that differ only in family capabilities
# must never share a fingerprint. ``spec_verify`` carries the speculative
# lookahead k and ``draft`` the paired draft architecture.

CAP_KEY_TABLE: Tuple[ExtKey, ...] = (
    ExtKey("pageable", "family has a dense per-layer KV cache pageable "
                       "into a physical pool"),
    ExtKey("needs_encoder_memory",
           "decode reads a per-slot encoder-memory buffer (enc-dec)"),
    ExtKey("stateful_cache", "recurrent/rolling cache state (ssm/xlstm)"),
    ExtKey("encoder_memory", "this datum is the per-slot encoder memory"),
    ExtKey("spec_verify", "speculative verify lookahead k", valued=True),
    ExtKey("draft", "paired draft architecture name", valued=True),
)

# ------------------------------------------------------------ sched() keys
# Admission-scheduling annotation (runtime.scheduling.SchedulingPolicy):
# the order requests are admitted to decode slots — and which running
# sequence is preempted under pool pressure — is a parallel execution
# decision like any other, declared in the program rather than hard-coded.

SCHED_KEY_TABLE: Tuple[ExtKey, ...] = (
    ExtKey("policy", "base admission discipline (fifo|priority|fair|sjf)",
           valued=True),
    ExtKey("prefix_affinity", "admit PrefixIndex hits first"),
    ExtKey("preempt", "priority preemption via eviction-by-recompute"),
    ExtKey("tenants", "canonical name:weight list for fair scheduling",
           valued=True),
)

# Printer rendering order (and the exact key vocabularies) derive from the
# tables; printer.py re-exports these names for its existing importers.
MM_EXT_KEYS: Tuple[str, ...] = tuple(k.key for k in MM_KEY_TABLE)
CAP_EXT_KEYS: Tuple[str, ...] = tuple(k.key for k in CAP_KEY_TABLE)
SCHED_EXT_KEYS: Tuple[str, ...] = tuple(k.key for k in SCHED_KEY_TABLE)

ALL_KEY_TABLES = {
    "mm": MM_KEY_TABLE,
    "caps": CAP_KEY_TABLE,
    "sched": SCHED_KEY_TABLE,
}


def key_doc(key: str) -> str:
    """One-line documentation for a fingerprinted key ('' if unknown)."""
    for table in ALL_KEY_TABLES.values():
        for entry in table:
            if entry.key == key:
                return entry.doc
    return ""


# --------------------------------------------- non-fingerprinted vocabularies
# Extension keys the planner/passes may attach to IR nodes *without*
# rendering them into the canonical text. The well-formedness pass accepts
# exactly (fingerprinted ∪ these); anything else is a WF002 diagnostic.

# DataAttr extensions: planner hints + pass-pipeline annotations.
ENGINE_DATA_KEYS = frozenset({
    "fsdp",                      # planner: FSDP-shard this state subtree
    "donate",                    # memory pass: buffer donated to the step
    "host_offload",              # memory pass: large_cap alloc -> host
    "vmem_resident",             # memory pass: vmem alloc -> keep resident
    "dist_fallback",             # propagate: a dist candidate fell through
    "dist_undivisible",          # propagate: no dist candidate divided
    "cyclic_lowered_as_block",   # normalize: recorded degeneration
})

# MemOp extensions: allocator geometry riding on alloc/share ops, plus the
# src/dst pool names a kv_transfer moves pages between (device|host for
# tiered spill/page-in, prefill|decode for the disaggregated hand-off).
# src_pool/dst_pool ARE rendered (the printer prints them on the
# kv_transfer op itself), so transfer direction participates in the
# fingerprint even though the keys live outside the mm() table.
MEMOP_KEYS = frozenset({"page_size", "num_pages", "pages_per_slot",
                        "shared_prefix", "src_pool", "dst_pool"})

# SyncOp extensions: overlap/fusion/compression schedule annotations.
SYNC_KEYS = frozenset({"overlap_candidate", "compression", "schedule",
                       "zero_decomposed", "fused_barrier", "bucketed"})

# LoopNode extensions: scan/bucketing hints from the planner.
LOOP_KEYS = frozenset({"scan", "bucketed"})


def known_data_attr_keys() -> frozenset:
    return frozenset(MM_EXT_KEYS) | frozenset(CAP_EXT_KEYS) | \
        frozenset(SCHED_EXT_KEYS) | ENGINE_DATA_KEYS
