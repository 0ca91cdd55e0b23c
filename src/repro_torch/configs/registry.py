"""Architectures the port serves, plus their reduced smoke variants.

The port serves the dense and the hybrid families, so the registry holds
``tinyllama-1.1b`` and ``zamba2-2.7b`` exactly as the JAX package specifies
them (``src/repro/configs/registry.py:28-33`` and ``:60-63``).
``config(arch_id)`` returns the full config; ``smoke_config(arch_id)`` the tiny
same-family reduction the CPU tests use (the reference's overrides,
``:116-128``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ArchConfig, SSMCfg

_CONFIGS: Dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    _CONFIGS[cfg.name] = cfg
    return cfg


# --- hybrid: Mamba2 + shared attention blocks [arXiv:2411.15242; hf] -------------
ZAMBA2 = _register(ArchConfig(
    "zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
    n_kv_heads=32, d_ff=10240, vocab=32000, act="gelu", glu=True,
    tied_embeddings=True, hybrid_attn_period=6, attn_window=4096,
    ssm=SSMCfg(d_inner=5120, head_dim=64, state_dim=64, n_groups=1),
    optimizer="adamw", source="[arXiv:2411.15242; hf]"))

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
    kw = dict(name=full.name + "-smoke", n_layers=4, d_model=64, vocab=256,
              param_dtype="float32", compute_dtype="float32")
    if full.family == "hybrid":
        kw.update(n_heads=4, n_kv_heads=4, d_ff=128, hybrid_attn_period=2,
                  attn_window=64,
                  ssm=SSMCfg(d_inner=128, head_dim=16, state_dim=8, chunk=16))
    else:
        kw.update(n_heads=4, n_kv_heads=2, d_ff=128)
    return dataclasses.replace(full, **kw)
