"""Decoder-only LM for the dense family (PyTorch port).

The counterpart of the JAX package's ``models/transformer.py`` for the slice
the port serves: the dense family with the paged KV layout. Conventions:

  * params are nested dicts of tensors keyed like the reference's pytree;
    per-layer tensors are stacked on a leading L dim, and the reference's
    ``lax.scan`` over them is a Python loop over layers;
  * the paged decode pool is read-only inside the layer loop and the new
    token's K/V is scattered once, after it, in place (``index_put_``) — what
    the reference's buffer donation achieves under ``jax.jit``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, dtype_of, resolve_device
from .layers import (apply_rope, attention_decode_paged, attention_full,
                     attention_prefill_chunk, cache_insert_paged,
                     embed_lookup, gather_kv_pages, mlp_apply, norm)

# Decode rows are padded to a multiple of this before the layer loop. GEMM
# libraries pick their algorithm (tiling, split-K) by the row count, so
# without padding a sequence decoded alone and the same sequence decoded in a
# batch of slots would round differently; with it, a row's arithmetic does not
# depend on how many other rows share the step.
DECODE_ROW_MULTIPLE = 8


def _check_dense(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what}: the port serves the dense family; family "
            f"'{cfg.family}' is not ported yet (ROADMAP Q1 #10)")


# ---------------------------------------------------------------- param shapes


def _attn_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"ln1": (D,), "wq": (D, H * hd), "wk": (D, KV * hd),
            "wv": (D, KV * hd), "wo": (H * hd, D)}


def _mlp_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    D, F = cfg.d_model, cfg.d_ff
    s = {"w1": (D, F), "w2": (F, D)}
    if cfg.glu:
        s["w3"] = (D, F)
    return s


def param_shapes(cfg: ArchConfig) -> Dict[str, Any]:
    """Nested dict of shape tuples for the full parameter tree."""
    _check_dense(cfg, "param_shapes")
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    out: Dict[str, Any] = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tied_embeddings:
        out["lm_head"] = (D, V)
    per: Dict[str, Any] = dict(_attn_shapes(cfg))
    per["ln2"] = (D,)
    per["mlp"] = _mlp_shapes(cfg)
    out["blocks"] = {k: ({kk: (L,) + vv for kk, vv in v.items()}
                         if isinstance(v, dict) else (L,) + v)
                     for k, v in per.items()}
    return out


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_params(cfg: ArchConfig, generator: Union[int, torch.Generator] = 0,
                *, device: DeviceLike = None) -> Dict[str, Any]:
    """Random-init parameters with the reference's scheme (norms at one,
    embeddings N(0, 0.02), matrices N(0, 1/fan_in)), drawn from one explicit
    generator in sorted parameter order. The values differ from the
    reference's (other generator); tests convert the reference's params."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    dt = dtype_of(cfg.param_dtype)
    out: Dict[str, Any] = {}
    for path, shape in _leaves(param_shapes(cfg)):
        base = path[-1]
        if base in ("ln1", "ln2", "final_norm"):
            val = torch.ones(shape, dtype=dt, device=dev)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 0.02 if base == "embed" else 1.0 / np.sqrt(fan_in)
            val = (torch.randn(shape, generator=generator, device=dev,
                               dtype=torch.float32) * scale).to(dt)
        _set(out, path, val)
    return out


def compute_params(cfg: ArchConfig, params, device: torch.device):
    """Params on ``device`` in the compute dtype: the cast every matmul of the
    reference does per call, done once. Bitwise the same values."""
    dt = dtype_of(cfg.compute_dtype)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return t.to(device=device, dtype=dt)

    return conv(params)


# -------------------------------------------------------------------- blocks


def _qkv(cfg: ArchConfig, p_l, x, positions, dtype):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    xr = norm(x, p_l["ln1"], cfg.norm).to(dtype)
    q = (xr @ p_l["wq"].to(dtype)).reshape(B, S, H, hd)
    k = (xr @ p_l["wk"].to(dtype)).reshape(B, S, KV, hd)
    v = (xr @ p_l["wv"].to(dtype)).reshape(B, S, KV, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _finish_block(cfg: ArchConfig, p_l, x, o, dtype):
    """Attention output projection + residual, then the MLP + residual."""
    B, S = x.shape[:2]
    a = o.reshape(B, S, cfg.n_heads * cfg.hd).to(dtype) @ p_l["wo"].to(dtype)
    x = x + a.to(x.dtype)
    xr = norm(x, p_l["ln2"], cfg.norm).to(dtype)
    m = mlp_apply(p_l["mlp"], xr, cfg.act, cfg.glu, dtype)
    return x + m.to(x.dtype)


def _layer(params, i: int):
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i])
            for k, v in params["blocks"].items()}


def logits_fn(cfg: ArchConfig, params, hidden):
    dtype = dtype_of(cfg.compute_dtype)
    head = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    return hidden.to(dtype) @ head.to(dtype)


def prefill(cfg: ArchConfig, params, tokens, *, s_max=None):
    """Prefill: forward pass + the KV cache.

    Returns (last-position logits [B,1,V], {"k","v": [L,B,s_max,KV,hd]}).
    ``s_max`` pads the cache for the paged write (defaults to S).
    """
    _check_dense(cfg, "prefill")
    dtype = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    s_max = s_max or S
    positions = torch.arange(S, device=tokens.device)[None, :]
    x = embed_lookup(params["embed"], tokens, dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p_l = _layer(params, i)
        q, k, v = _qkv(cfg, p_l, x, positions, dtype)
        o = attention_full(q, k, v, causal=True)
        x = _finish_block(cfg, p_l, x, o, dtype)
        ks.append(k)
        vs.append(v)
    k_all = torch.stack(ks)
    v_all = torch.stack(vs)
    if s_max > S:
        pad = (0, 0, 0, 0, 0, s_max - S)
        k_all = torch.nn.functional.pad(k_all, pad)
        v_all = torch.nn.functional.pad(v_all, pad)
    hidden = norm(x, params["final_norm"], cfg.norm)
    return logits_fn(cfg, params, hidden[:, -1:]), {"k": k_all, "v": v_all}


# ------------------------------------------------------------------ paged KV


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Decode-kernel choice, validated once at engine construction.

    ``cuda`` runs the paged-attention kernel wrapper (its plain version on
    CPU tensors); ``torch`` runs the plain gather path
    (``layers.attention_decode_paged``), which is accepted on the CPU only.
    """

    attn_impl: str = "cuda"

    def __post_init__(self):
        if self.attn_impl not in ("cuda", "torch"):
            raise ValueError(f"attn_impl must be 'cuda' or 'torch', "
                             f"got {self.attn_impl!r}")


def cache_shapes(cfg: ArchConfig, B: int, S_max: int) -> Dict[str, tuple]:
    """Shapes of the dense decode cache (the prefill hand-off and the plan's
    symbol table)."""
    _check_dense(cfg, "cache_shapes")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    return {"k": (L, B, S_max, KV, hd), "v": (L, B, S_max, KV, hd)}


def paged_cache_shapes(cfg: ArchConfig, num_pages: int,
                       page_size: int) -> Dict[str, Tuple[int, ...]]:
    """Physical KV pool: ``num_pages`` allocatable pages + 1 reserved null
    page (physical page 0) that unmapped page-table entries point at."""
    _check_dense(cfg, "paged KV cache")
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    shape = (L, num_pages + 1, page_size, KV, hd)
    return {"k_pages": shape, "v_pages": shape}


def init_paged_cache(cfg: ArchConfig, num_pages: int, page_size: int, *,
                     device: DeviceLike = None):
    dev = resolve_device(device)
    dt = dtype_of(cfg.compute_dtype)
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, s in paged_cache_shapes(cfg, num_pages, page_size).items()}


def _pad_rows(t, rows: int):
    if t.shape[0] == rows:
        return t
    pad = torch.zeros((rows - t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def decode_step_paged(cfg: ArchConfig, params, pool, page_table, tokens, pos,
                      *, kernel: Optional[KernelSpec] = None):
    """One decode step against the paged pool. tokens [B,1], pos [B],
    page_table [B,P] (logical page -> physical page; null rows for inactive
    slots). Returns (logits [B,1,V], pool) — the pool updated in place with
    the new token's K/V.

    Attention runs the paged-attention kernel (``kernel.attn_impl='cuda'``)
    or the plain gather path (``'torch'``, CPU only). Rows are padded to
    ``DECODE_ROW_MULTIPLE``; padded rows read and write only the null page.
    """
    _check_dense(cfg, "decode_step_paged")
    kernel = kernel or KernelSpec()
    if kernel.attn_impl == "torch" and tokens.device.type != "cpu":
        raise ValueError("attn_impl='torch' is the CPU reference path; "
                         "CUDA tensors run the paged-attention kernel")
    dtype = dtype_of(cfg.compute_dtype)
    B = tokens.shape[0]
    rows = -(-B // DECODE_ROW_MULTIPLE) * DECODE_ROW_MULTIPLE
    tokens, pos = _pad_rows(tokens, rows), _pad_rows(pos, rows)
    page_table = _pad_rows(page_table, rows)
    x = embed_lookup(params["embed"], tokens, dtype)
    positions = pos[:, None]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p_l = _layer(params, i)
        q, k, v = _qkv(cfg, p_l, x, positions, dtype)
        k_pg, v_pg = pool["k_pages"][i], pool["v_pages"][i]
        if kernel.attn_impl == "cuda":
            from ..kernels.paged_attention import paged_attention_decode
            o = paged_attention_decode(q, k_pg, v_pg, page_table, pos,
                                       new_kv=(k, v))
        else:
            o = attention_decode_paged(q, k_pg, v_pg, page_table, pos,
                                       new_kv=(k, v))
        x = _finish_block(cfg, p_l, x, o, dtype)
        ks.append(k)
        vs.append(v)
    cache_insert_paged(pool["k_pages"], torch.stack(ks), page_table, pos)
    cache_insert_paged(pool["v_pages"], torch.stack(vs), page_table, pos)
    hidden = norm(x, params["final_norm"], cfg.norm)
    return logits_fn(cfg, params, hidden)[:B], pool


def prefill_chunk(cfg: ArchConfig, params, pool, page_row, tokens, offset):
    """One chunk of a chunked prefill for a single sequence.

    tokens [1,C] (positions ``offset .. offset+C-1``); page_row [P] — the
    sequence's page-table row, whose already-written pages hold the previous
    chunks' K/V. Returns (last-position logits [1,1,V],
    (k_chunk, v_chunk) [L,1,C,KV,hd]); the caller writes the chunk K/V into
    its pages (``cache_write_pages``) before the next chunk runs.
    """
    _check_dense(cfg, "prefill_chunk")
    dtype = dtype_of(cfg.compute_dtype)
    B, C = tokens.shape
    dev = tokens.device
    offset = torch.as_tensor(offset, dtype=torch.int64, device=dev)
    positions = offset + torch.arange(C, device=dev)[None, :]
    off_b = offset.reshape(1).expand(B)
    x = embed_lookup(params["embed"], tokens, dtype)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p_l = _layer(params, i)
        q, k, v = _qkv(cfg, p_l, x, positions, dtype)
        k_ctx = gather_kv_pages(pool["k_pages"][i], page_row[None, :])
        v_ctx = gather_kv_pages(pool["v_pages"][i], page_row[None, :])
        o = attention_prefill_chunk(q, k_ctx, v_ctx, k, v, off_b)
        x = _finish_block(cfg, p_l, x, o, dtype)
        ks.append(k)
        vs.append(v)
    hidden = norm(x, params["final_norm"], cfg.norm)
    return logits_fn(cfg, params, hidden[:, -1:]), (torch.stack(ks),
                                                    torch.stack(vs))
