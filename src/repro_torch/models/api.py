"""Uniform model API via the **ModelFamily protocol** (PyTorch port).

Every family registers one declarative :class:`FamilySpec`: capability flags
(``pageable`` / ``needs_encoder_memory`` / ``stateful_cache``) plus uniform
entry points. The module-level functions dispatch through the spec; a family
that lacks a capability raises :class:`CapabilityError` naming it. The same
flags render into the UPIR program text (``core.plans``), so capabilities
take part in the program fingerprint exactly as in the JAX package.

The port registers the ``dense`` family (pageable) and the ``hybrid``
family (``stateful_cache``: conv and SSM states plus a rolling window cache,
served on the dense layout). The others (moe, vlm, ssm, encdec) are ROADMAP
Q1 #10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from ..configs.base import ArchConfig
from . import transformer
from .transformer import KernelSpec  # noqa: F401  (re-export)

CAPABILITY_FLAGS = ("pageable", "needs_encoder_memory", "stateful_cache")


class CapabilityError(NotImplementedError):
    """A family was asked for an entry point its FamilySpec does not declare."""


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    """Declarative per-family serving contract. ``None`` entry points mean
    the family lacks that capability — :meth:`require` raises
    :class:`CapabilityError` for them."""

    key: str                            # registry key (== dispatch family)
    # ---- capability flags
    pageable: bool = False              # dense per-layer KV -> paged pool ok
    needs_encoder_memory: bool = False  # per-slot encoder memory at admission
    stateful_cache: bool = False        # recurrent/rolling state, not seq KV
    # ---- uniform entry points
    param_shapes: Callable = None
    init_params: Callable = None
    cache_specs: Callable = None
    init_cache: Callable = None
    prefill: Callable = None
    decode_step: Callable = None
    # ---- capability-gated entry points
    paged_cache_shapes: Optional[Callable] = None   # pageable
    init_paged_cache: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    prefill_chunk: Optional[Callable] = None

    @property
    def capabilities(self) -> Tuple[str, ...]:
        return tuple(f for f in CAPABILITY_FLAGS if getattr(self, f))

    def require(self, entry: str, capability: str) -> Callable:
        fn = getattr(self, entry)
        if fn is None:
            raise CapabilityError(
                f"family '{self.key}' does not declare capability "
                f"'{capability}' (FamilySpec.{entry} is unset)")
        return fn


# ------------------------------------------------------- transformer adapters


def _tf_prefill(cfg, params, batch, *, s_max=None):
    return transformer.prefill(cfg, params, batch["tokens"], s_max=s_max)


def _tf_decode(cfg, params, cache, batch):
    return transformer.decode_step(cfg, params, cache, batch["tokens"],
                                   batch["pos"])


def _tf_decode_paged(cfg, params, pool, page_table, batch, *, kernel=None):
    return transformer.decode_step_paged(cfg, params, pool, page_table,
                                         batch["tokens"], batch["pos"],
                                         kernel=kernel)


def _tf_prefill_chunk(cfg, params, pool, page_row, batch, offset):
    return transformer.prefill_chunk(cfg, params, pool, page_row,
                                     batch["tokens"], offset)


def _transformer_spec(key: str, **caps) -> FamilySpec:
    paged = caps.get("pageable", False)
    return FamilySpec(
        key=key,
        param_shapes=transformer.param_shapes,
        init_params=transformer.init_params,
        cache_specs=transformer.cache_specs,
        init_cache=transformer.init_cache,
        prefill=_tf_prefill,
        decode_step=_tf_decode,
        paged_cache_shapes=transformer.paged_cache_shapes if paged else None,
        init_paged_cache=transformer.init_paged_cache if paged else None,
        decode_step_paged=_tf_decode_paged if paged else None,
        prefill_chunk=_tf_prefill_chunk if paged else None,
        **caps)


FAMILY_SPECS: Dict[str, FamilySpec] = {
    # a dense per-layer K/V cache: pageable
    "dense": _transformer_spec("dense", pageable=True),
    # recurrent/rolling caches, not pageable (src/repro/models/api.py:185)
    "hybrid": _transformer_spec("hybrid", stateful_cache=True),
}


def family_key(cfg: ArchConfig) -> str:
    """Registry key for a config: encoder-decoder wins over the nominal
    family tag."""
    return "encdec" if cfg.encdec is not None else cfg.family


def family_spec(cfg: ArchConfig) -> FamilySpec:
    key = family_key(cfg)
    if key not in FAMILY_SPECS:
        raise KeyError(f"no FamilySpec registered for family '{key}' "
                       f"(known: {tuple(sorted(FAMILY_SPECS))}; the other "
                       f"families are ROADMAP Q1 #10)")
    return FAMILY_SPECS[key]


# ------------------------------------------------------- uniform entry points


def _specs(shapes, dtype: str):
    """Shape tree -> tree of ``(shape, dtype name)`` specs."""
    if isinstance(shapes, dict):
        return {k: _specs(v, dtype) for k, v in shapes.items()}
    return (tuple(shapes), dtype)


def param_shapes(cfg: ArchConfig):
    return family_spec(cfg).param_shapes(cfg)


def param_specs(cfg: ArchConfig):
    return _specs(param_shapes(cfg), cfg.param_dtype)


def init_params(cfg: ArchConfig, generator=0, *, device=None):
    return family_spec(cfg).init_params(cfg, generator, device=device)


def cache_specs(cfg: ArchConfig, B: int, S_max: int):
    """``(shape, dtype name)`` per leaf of the dense-layout decode cache."""
    return family_spec(cfg).cache_specs(cfg, B, S_max)


def cache_batch_dims(cfg: ArchConfig, s_max: int) -> Dict[str, int]:
    """Per-leaf batch dim of a family's cache, found structurally: the dim
    whose extent tracks B (``src/repro/models/api.py:241``); -1 for a
    batch-independent leaf."""
    a, b = cache_specs(cfg, 2, s_max), cache_specs(cfg, 3, s_max)
    return {k: next((i for i, (p, q) in enumerate(zip(a[k][0], b[k][0]))
                     if p != q), -1) for k in a}


def build_cache_insert(cfg: ArchConfig, s_max: int):
    """Slot insert: a cache-of-one into slot ``i`` of a batched cache, in
    place (``src/repro/models/api.py:257``)."""
    bdims = cache_batch_dims(cfg, s_max)

    def insert(cache, one, slot: int):
        for k, d in bdims.items():
            if d >= 0:
                cache[k].narrow(d, slot, 1).copy_(one[k])
        return cache

    return insert


def init_cache(cfg: ArchConfig, B: int, S_max: int, *, device=None):
    return family_spec(cfg).init_cache(cfg, B, S_max, device=device)


def prefill(cfg: ArchConfig, params, batch: Dict[str, Any], *, s_max=None):
    return family_spec(cfg).prefill(cfg, params, batch, s_max=s_max)


def decode_step(cfg: ArchConfig, params, cache, batch: Dict[str, Any]):
    """One decode step on the dense layout: (logits [B,1,V], the cache
    updated in place)."""
    return family_spec(cfg).decode_step(cfg, params, cache, batch)


def supports_paged_kv(cfg: ArchConfig) -> bool:
    return family_spec(cfg).pageable


# ------------------------------------------------------------------ paged KV


def paged_cache_specs(cfg: ArchConfig, num_pages: int, page_size: int):
    spec = family_spec(cfg)
    return _specs(spec.require("paged_cache_shapes", "pageable")(
        cfg, num_pages, page_size), cfg.compute_dtype)


def init_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int, *,
                     device=None):
    spec = family_spec(cfg)
    return spec.require("init_paged_cache", "pageable")(
        cfg, num_pages, page_size, device=device)


def decode_step_paged(cfg: ArchConfig, params, pool, page_table,
                      batch: Dict[str, Any], *,
                      kernel: Optional[KernelSpec] = None):
    spec = family_spec(cfg)
    return spec.require("decode_step_paged", "pageable")(
        cfg, params, pool, page_table, batch, kernel=kernel)


def prefill_chunk(cfg: ArchConfig, params, pool, page_row,
                  batch: Dict[str, Any], offset):
    spec = family_spec(cfg)
    return spec.require("prefill_chunk", "pageable")(
        cfg, params, pool, page_row, batch, offset)
