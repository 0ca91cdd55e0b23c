"""Architectures the port serves, plus their reduced smoke variants.

This slice of the port covers the dense family, so the registry holds
``tinyllama-1.1b`` exactly as the JAX package specifies it. ``config(arch_id)``
returns the full config; ``smoke_config(arch_id)`` the tiny same-family
reduction the CPU tests use.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ArchConfig

_CONFIGS: Dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- dense: llama2-arch small [arXiv:2401.02385; hf] -----------------------------
TINYLLAMA = _register(ArchConfig(
    "tinyllama-1.1b", family="dense", n_layers=22, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=5632, vocab=32000, act="silu", glu=True,
    optimizer="adamw", source="[arXiv:2401.02385; hf]"))


ARCH_IDS = tuple(sorted(_CONFIGS))


def config(arch_id: str) -> ArchConfig:
    if arch_id not in _CONFIGS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    return _CONFIGS[arch_id]


def smoke_config(arch_id: str) -> ArchConfig:
    """Tiny same-family config: a few layers, small widths, tiny vocab."""
    full = config(arch_id)
    return dataclasses.replace(
        full, name=full.name + "-smoke", n_layers=4, d_model=64, vocab=256,
        param_dtype="float32", compute_dtype="float32",
        n_heads=4, n_kv_heads=2, d_ff=128)
