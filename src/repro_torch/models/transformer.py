"""Decoder-only LM for the dense and hybrid families (PyTorch port).

The counterpart of the JAX package's ``models/transformer.py`` for the slices
the port serves: the dense family on the paged and the dense KV layouts, and
the hybrid family (zamba2: stacked Mamba2 blocks plus one shared
attention+MLP block every ``hybrid_attn_period`` layers) on the dense layout.
Conventions:

  * params are nested dicts of tensors keyed like the reference's pytree;
    per-layer tensors are stacked on a leading L dim, and the reference's
    ``lax.scan`` / ``lax.cond`` over them is a Python loop over layers;
  * decode caches are updated in place (``index_put_``) and returned — what
    the reference's buffer donation achieves under ``jax.jit``; the dense
    family's cache is read-only inside the layer loop and the new token's K/V
    is written once, after it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..device import DeviceLike, dtype_of, resolve_device
from . import mamba2
from .layers import (apply_rope, attention_chunked, attention_decode,
                     attention_decode_paged, attention_full,
                     attention_prefill_chunk, cache_insert, cache_insert_paged,
                     embed_lookup, gather_kv_pages, mlp_apply, norm)

CHUNKED_ATTN_THRESHOLD = 8192

# Decode rows are padded to a multiple of this before the layer loop. GEMM
# libraries pick their algorithm (tiling, split-K) by the row count, so
# without padding a sequence decoded alone and the same sequence decoded in a
# batch of slots would round differently; with it, a row's arithmetic does not
# depend on how many other rows share the step.
DECODE_ROW_MULTIPLE = 8


PORTED_FAMILIES = ("dense", "hybrid")
# families with a dense per-layer K/V cache (paged layout, deferred insert)
PAGED_FAMILIES = ("dense", "moe", "vlm")


def _check_ported(cfg: ArchConfig, what: str) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{what}: the port serves the families {PORTED_FAMILIES}; family "
            f"'{cfg.family}' is not ported yet (ROADMAP Q1 #10)")


def _check_dense(cfg: ArchConfig, what: str) -> None:
    _check_ported(cfg, what)
    _check_dense_kv(cfg, what)


def _check_dense_kv(cfg: ArchConfig, what: str) -> None:
    """The reference's guard (``src/repro/models/transformer.py:589``)."""
    if cfg.family not in PAGED_FAMILIES:
        raise NotImplementedError(
            f"{what} needs a dense per-layer K/V cache; family "
            f"'{cfg.family}' keeps recurrent/rolling state (ROADMAP)")


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
    _check_ported(cfg, "param_shapes")
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    out: Dict[str, Any] = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tied_embeddings:
        out["lm_head"] = (D, V)
    if cfg.family == "hybrid":       # zamba2: stacked mamba + one shared block
        per = mamba2.mamba_params_shapes(D, cfg.ssm)
        out["mamba"] = {k: (L,) + v for k, v in per.items()}
        shared: Dict[str, Any] = dict(_attn_shapes(cfg))
        shared["ln2"] = (D,)
        shared["mlp"] = _mlp_shapes(cfg)
        out["shared"] = shared
        return out
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
    """Random-init parameters with the reference's scheme (norms and
    ``D_skip`` at one, ``A_log = log U(1, 16)``, ``dt_bias`` the inverse
    softplus of ``U(1e-3, 0.1)``, embeddings N(0, 0.02), matrices
    N(0, 1/fan_in)), drawn from one explicit generator in sorted parameter
    order. The values differ from the reference's (other generator); tests
    convert the reference's params."""
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    dt = dtype_of(cfg.param_dtype)
    out: Dict[str, Any] = {}
    for path, shape in _leaves(param_shapes(cfg)):
        base = path[-1]

        def uniform(lo, hi):
            return torch.rand(shape, generator=generator, device=dev,
                              dtype=torch.float32) * (hi - lo) + lo

        if base == "A_log":
            val = torch.log(uniform(1.0, 16.0)).to(dt)
        elif base == "dt_bias":
            val = torch.log(torch.expm1(uniform(1e-3, 0.1))).to(dt)
        elif base in ("ln", "ln1", "ln2", "out_norm", "final_norm",
                      "D_skip"):
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


def _shared_attention(cfg: ArchConfig, q, k, v):
    """The hybrid prefill's causal, windowed attention over the whole
    sequence. On a CUDA tensor it runs the flash-attention kernel with the
    window (an addition to the TPU kernel, which has none). On the CPU it is
    the reference's plain windowed path: ``attention_full``, or
    ``attention_chunked`` above ``CHUNKED_ATTN_THRESHOLD``."""
    S = q.shape[1]
    window = cfg.attn_window
    if q.device.type == "cuda":
        from ..kernels.flash_attention import flash_attention
        # one TPU tile of the whole sequence: any prompt length divides it
        # (the kernel masks its own ragged tiles)
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True, bq=S, bk=S, window=window)
    if S > CHUNKED_ATTN_THRESHOLD:
        return attention_chunked(q, k, v, window=window)
    return attention_full(q, k, v, causal=True, window=window)


def _prefill_hybrid(cfg: ArchConfig, params, x, positions, s_max: int):
    """The hybrid branch of the reference's prefill
    (``src/repro/models/transformer.py:492``): every layer runs its Mamba2
    block, and layers ``idx % period == 0`` then the shared attention+MLP
    block, whose K/V go to the rolling window cache (slot ``pos % W``)."""
    dtype = dtype_of(cfg.compute_dtype)
    B, S = x.shape[:2]
    shared = params["shared"]
    W = min(cfg.attn_window or s_max, s_max)
    convs, ssms, ks, vs = [], [], [], []
    for i in range(cfg.n_layers):
        p_l = {k: v[i] for k, v in params["mamba"].items()}
        out, (conv_l, ssm_l) = mamba2.mamba_block(p_l, x, cfg.ssm, dtype)
        x = x + out
        convs.append(conv_l)
        ssms.append(ssm_l)
        if i % cfg.hybrid_attn_period:
            continue
        q, k, v = _qkv(cfg, shared, x, positions, dtype)
        o = _shared_attention(cfg, q, k, v)
        x = _finish_block(cfg, shared, x, o, dtype)
        # the last min(W, S) positions in the rolling layout (slot = pos % W):
        # W >= S fills slots 0..S-1; else position S-W+i lives at slot
        # (S+i) % W, a roll by S % W
        if W >= S:
            pad = (0, 0, 0, 0, 0, W - S)
            k, v = F.pad(k, pad), F.pad(v, pad)
        else:
            k = torch.roll(k[:, -W:], S % W, dims=1)
            v = torch.roll(v[:, -W:], S % W, dims=1)
        ks.append(k)
        vs.append(v)
    cache = {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
             "k": torch.stack(ks), "v": torch.stack(vs)}
    return x, cache


def prefill(cfg: ArchConfig, params, tokens, *, s_max=None):
    """Prefill: forward pass + the decode cache
    (``src/repro/models/transformer.py:459``).

    Returns (last-position logits [B,1,V], cache). Dense family: {"k","v":
    [L,B,s_max,KV,hd]}, ``s_max`` padding the cache (defaults to S). Hybrid
    family: {"conv" [L,B,K-1,d_inner], "ssm" [L,B,H,P,N] float32, "k","v"
    [L // period, B, W, KV, hd]} with ``W = min(attn_window, s_max)``.
    """
    _check_ported(cfg, "prefill")
    dtype = dtype_of(cfg.compute_dtype)
    B, S = tokens.shape
    s_max = s_max or S
    positions = torch.arange(S, device=tokens.device)[None, :]
    x = embed_lookup(params["embed"], tokens, dtype)
    if cfg.family == "hybrid":
        x, cache = _prefill_hybrid(cfg, params, x, positions, s_max)
        hidden = norm(x, params["final_norm"], cfg.norm)
        return logits_fn(cfg, params, hidden[:, -1:]), cache
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
        k_all = F.pad(k_all, pad)
        v_all = F.pad(v_all, pad)
    hidden = norm(x, params["final_norm"], cfg.norm)
    return logits_fn(cfg, params, hidden[:, -1:]), {"k": k_all, "v": v_all}


# ------------------------------------------------------------------ dense KV


def cache_shapes(cfg: ArchConfig, B: int, S_max: int) -> Dict[str, tuple]:
    """Shapes of the dense-layout decode cache, per family
    (``src/repro/models/transformer.py:290``): the prefill hand-off, the
    engine's dense cache and the plan's symbol table."""
    _check_ported(cfg, "cache_shapes")
    KV, hd, L = cfg.n_kv_heads, cfg.hd, cfg.n_layers
    if cfg.family == "hybrid":
        s = cfg.ssm
        n_inv = L // cfg.hybrid_attn_period
        W = min(cfg.attn_window or S_max, S_max)
        return {"conv": (L, B, s.conv_kernel - 1, s.d_inner),
                "ssm": (L, B, s.n_heads, s.head_dim, s.state_dim),
                "k": (n_inv, B, W, KV, hd), "v": (n_inv, B, W, KV, hd)}
    return {"k": (L, B, S_max, KV, hd), "v": (L, B, S_max, KV, hd)}


def cache_specs(cfg: ArchConfig, B: int, S_max: int) -> Dict[str, tuple]:
    """``(shape, dtype name)`` per cache leaf: the SSM state is float32, the
    rest in the compute dtype (``src/repro/models/transformer.py:320``)."""
    return {k: (s, "float32" if k == "ssm" else cfg.compute_dtype)
            for k, s in cache_shapes(cfg, B, S_max).items()}


def init_cache(cfg: ArchConfig, B: int, S_max: int, *,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.zeros(s, dtype=dtype_of(d), device=dev)
            for k, (s, d) in cache_specs(cfg, B, S_max).items()}


def _pad_rows(t, rows: int, dim: int = 0):
    if t.shape[dim] == rows:
        return t
    shape = list(t.shape)
    shape[dim] = rows - t.shape[dim]
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype, device=t.device)],
                     dim=dim)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    """One decode step against the dense-layout cache
    (``src/repro/models/transformer.py:348``). tokens [B,1], pos [B].
    Returns (logits [B,1,V], cache) — the cache updated in place.

    Rows are padded to ``DECODE_ROW_MULTIPLE``, the cache's too (a padded
    copy, written back after the step), so a row's arithmetic does not
    depend on how many rows share the step.
    """
    _check_ported(cfg, "decode_step")
    B = tokens.shape[0]
    rows = -(-B // DECODE_ROW_MULTIPLE) * DECODE_ROW_MULTIPLE
    if rows == B:
        return _decode_step(cfg, params, cache, tokens, pos), cache
    padded = {k: _pad_rows(v, rows, dim=1) for k, v in cache.items()}
    logits = _decode_step(cfg, params, padded, _pad_rows(tokens, rows),
                          _pad_rows(pos, rows))
    for k, v in cache.items():
        v.copy_(padded[k][:, :B])
    return logits[:B], cache


def _decode_step(cfg: ArchConfig, params, cache, tokens, pos):
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    positions = pos[:, None]
    if cfg.family == "hybrid":
        shared = params["shared"]
        W = cache["k"].shape[2]
        inv = 0
        for i in range(cfg.n_layers):
            p_l = {k: v[i] for k, v in params["mamba"].items()}
            out, (conv_l, ssm_l) = mamba2.mamba_block(
                p_l, x, cfg.ssm, dtype, conv_state=cache["conv"][i],
                ssm_state=cache["ssm"][i], decode=True)
            cache["conv"][i] = conv_l
            cache["ssm"][i] = ssm_l
            x = x + out
            if i % cfg.hybrid_attn_period:
                continue
            q, k, v = _qkv(cfg, shared, x, positions, dtype)
            k_c = cache_insert(cache["k"][inv], k, pos, window=W)
            v_c = cache_insert(cache["v"][inv], v, pos, window=W)
            o = attention_decode(q, k_c, v_c, pos, window=W)
            x = _finish_block(cfg, shared, x, o, dtype)
            inv += 1
    else:
        # dense: the cache is read-only in the loop; the new K/V merge into
        # the softmax and are written once, after it
        ks, vs = [], []
        for i in range(cfg.n_layers):
            p_l = _layer(params, i)
            q, k, v = _qkv(cfg, p_l, x, positions, dtype)
            o = attention_decode(q, cache["k"][i], cache["v"][i], pos,
                                 new_kv=(k, v))
            x = _finish_block(cfg, p_l, x, o, dtype)
            ks.append(k)
            vs.append(v)
        L, rows = cfg.n_layers, tokens.shape[0]
        idx = torch.clamp(pos.long(), max=cache["k"].shape[2] - 1)
        r = torch.arange(rows, device=tokens.device)
        for name, new in (("k", ks), ("v", vs)):
            cache[name][:, r, idx] = torch.stack(new)[:, :, 0].to(
                cache[name].dtype)
    hidden = norm(x, params["final_norm"], cfg.norm)
    return logits_fn(cfg, params, hidden)


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
