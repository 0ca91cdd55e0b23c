"""Shared layer primitives: norms, RoPE, attention paths, MLP (PyTorch port).

Plain functions on tensors, op for op the JAX package's ``models/layers.py``:
matmuls run in the config's compute dtype, normalization statistics and
softmax in float32. Where the reference returns an updated cache, the paged
writes here update the pool in place (``index_put_``) — what buffer donation
achieves under ``jax.jit`` — and return it.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30

# --------------------------------------------------------------------- embedding


def embed_lookup(embed, tokens, dtype):
    """Token embedding lookup (the reference's single-device gather)."""
    return embed.to(dtype)[tokens]


# ------------------------------------------------------------------------- norms


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layernorm(x, w, b=None, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)
    return y + b.to(x.dtype) if b is not None else y


def norm(x, w, kind: str = "rmsnorm"):
    return rmsnorm(x, w) if kind == "rmsnorm" else layernorm(x, w)


# -------------------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


@functools.lru_cache(maxsize=16)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device):
    """The frequencies on ``device``, uploaded once: a host-to-device copy in
    every call would make the host wait for the card at each layer."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, float(theta), x.device)             # [hd/2]
    angles = positions[..., None].float() * freqs                  # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                          # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------- MLP


def mlp_apply(p, x, act: str, glu: bool, dtype):
    x = x.to(dtype)
    h = _act(x @ p["w1"].to(dtype), act)
    if glu:
        h = h * (x @ p["w3"].to(dtype))
    return h @ p["w2"].to(dtype)


def _act(h, act: str):
    if act == "silu":
        return F.silu(h)
    if act == "gelu":
        return F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    if act == "relu2":
        r = F.relu(h)
        return r * r
    raise ValueError(act)


# --------------------------------------------------------------------- attention


def gqa_expand(k, H: int):
    """[B,S,KV,hd] -> (k, G = H // KV) view helper."""
    return k, H // k.shape[2]


def gqa_expand_kv(k, H: int):
    """Expand GQA K/V [B,S,KV,hd] -> [B,S,H,hd] by repeating each group."""
    KV = k.shape[2]
    if KV == H:
        return k
    return torch.repeat_interleave(k, H // KV, dim=2)


def attention_full(q, k, v, *, causal: bool, q_offset=0, window: int = 0,
                   bias=None):
    """Plain-softmax attention. q: [B,Sq,H,hd], k/v: [B,Sk,KV,hd]."""
    B, Sq, H, hd = q.shape
    k = gqa_expand_kv(k, H)
    v = gqa_expand_kv(v, H)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    scores = scores / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    if causal or window:
        qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        scores = torch.where(mask[None, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    return out.reshape(B, Sq, H, hd)


def attention_chunked(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      kv_chunk: int = 1024, window: int = 0):
    """Online-softmax attention, double-chunked (the reference's XLA flash,
    ``src/repro/models/layers.py:145``). Memory O(chunk^2)."""
    B, Sq, H, hd = q.shape
    k = gqa_expand_kv(k, H)
    v = gqa_expand_kv(v, H)
    Sk = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    scale = 1.0 / np.sqrt(hd)
    dev = q.device
    outs = []
    for iq in range(nq):
        q_i = q[:, iq * q_chunk:(iq + 1) * q_chunk]
        m = torch.full((B, H, q_chunk), float("-inf"), device=dev)
        l = torch.zeros((B, H, q_chunk), device=dev)
        acc = torch.zeros((B, H, q_chunk, hd), device=dev)
        for jk in range(nk):
            k_j = k[:, jk * kv_chunk:(jk + 1) * kv_chunk]
            v_j = v[:, jk * kv_chunk:(jk + 1) * kv_chunk]
            s = torch.einsum("bqhd,bshd->bhqs", q_i, k_j).float() * scale
            if causal or window:
                qpos = iq * q_chunk + torch.arange(q_chunk, device=dev)[:, None]
                kpos = jk * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
                ok = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                                device=dev)
                if causal:
                    ok &= kpos <= qpos
                if window:
                    ok &= kpos > qpos - window
                s = torch.where(ok[None, None], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(q.dtype), v_j).float()
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))                   # [B,H,qc,hd]
    return torch.cat(outs, dim=2).transpose(1, 2).reshape(B, Sq, H, hd)


def attention_decode(q, k_cache, v_cache, pos, *, window: int = 0,
                     new_kv=None):
    """One-token attention against a (possibly rolling) dense KV cache
    (``src/repro/models/layers.py:202``).

    q: [B,1,H,hd]; k_cache/v_cache: [B,S,KV,hd]; pos: [B] absolute position
    of the new token. Entries past ``pos`` are masked; with ``window`` the
    cache slots hold the last ``window`` positions (rolling). ``new_kv``
    runs deferred-insert (cache positions ``< pos``, the new token merged
    online).
    """
    S = k_cache.shape[1]
    slot = torch.arange(S, device=q.device)[None, :]
    limit = pos if new_kv is not None else pos + 1
    if window:
        valid = slot < torch.clamp(limit, max=window)[:, None]
    else:
        valid = slot < limit[:, None]
    return _attend_cached(q, k_cache, v_cache, valid, new_kv)


def cache_insert(cache, new, pos, *, window: int = 0):
    """Write [B,1,KV,hd] into [B,S,KV,hd] at each row's position, in place
    (``src/repro/models/layers.py:259``): slot ``pos % window`` when
    windowed (rolling), else ``pos``, clamped to the last slot as the
    reference's ``dynamic_update_slice`` clamps. Returns the cache."""
    pos = pos.long()
    idx = pos % window if window else torch.clamp(pos, max=cache.shape[1] - 1)
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, idx] = new[:, 0].to(cache.dtype)
    return cache


def _attend_cached(q, k_cache, v_cache, valid, new_kv):
    """Shared decode-attention core: softmax over cache entries where ``valid``
    ([B,S] bool), optionally merging a deferred new-token K/V online."""
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    scale = math.sqrt(hd)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() / scale
    scores = torch.where(valid[:, None, None], scores, NEG)
    if new_kv is not None:
        k_new, v_new = new_kv
        s_new = torch.einsum("bkgh,bskh->bkgs", qg,
                             k_new).float()[..., 0] / scale
        m = torch.maximum(scores.amax(dim=-1), s_new)              # [B,KV,G]
        p = torch.exp(scores - m[..., None])
        l_c = p.sum(dim=-1)
        o_c = torch.einsum("bkgs,bskh->bkgh", p.to(q.dtype), v_cache)
        p_n = torch.exp(s_new - m)                                 # [B,KV,G]
        o = o_c.float() + p_n[..., None] * v_new[:, 0, :, None, :].float()
        out = (o / (l_c + p_n)[..., None]).to(q.dtype)
        return out.reshape(B, 1, H, hd)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    return out.reshape(B, 1, H, hd)


# ----------------------------------------------------------------- paged KV

# Physical page 0 is reserved as the *null page*: page-table entries of
# inactive/unmapped slots point at it, so stray scatters land somewhere
# harmless and stray gathers read data that the position mask discards.
NULL_PAGE = 0


def gather_kv_pages(pool, page_table):
    """Gather a logical-order KV view through the page table.

    pool: [NP, PS, KV, hd]; page_table: [B, P] int. Returns [B, P*PS, KV, hd]
    where row j holds the K/V of logical position j (garbage past the
    sequence length — callers mask by position).
    """
    g = pool[page_table.long()]                        # [B, P, PS, KV, hd]
    B, P, PS, KV, hd = g.shape
    return g.reshape(B, P * PS, KV, hd)


def attention_decode_paged(q, k_pages, v_pages, page_table, pos, *,
                           window: int = 0, new_kv=None):
    """One-token attention against a paged KV pool (the plain gather path).

    q: [B,1,H,hd]; k_pages/v_pages: [NP,PS,KV,hd]; page_table: [B,P]; pos:
    [B]. ``new_kv=(k_new, v_new)`` runs deferred-insert (cache positions
    ``< pos``, the new token merged online); a ``window`` masks positions
    ``[limit - window, limit)``.
    """
    k_c = gather_kv_pages(k_pages, page_table)
    v_c = gather_kv_pages(v_pages, page_table)
    S = k_c.shape[1]
    slot = torch.arange(S, device=q.device)[None, :]
    limit = pos if new_kv is not None else pos + 1
    valid = slot < limit[:, None]
    if window:
        valid &= slot >= (limit - window)[:, None]
    return _attend_cached(q, k_c, v_c, valid, new_kv)


def cache_insert_paged(pool, new, page_table, pos):
    """Scatter one new token's K/V into the paged pool, all layers at once,
    in place.

    pool: [L,NP,PS,KV,hd]; new: [L,B,1,KV,hd]; page_table: [B,P]; pos: [B].
    The target page is ``page_table[b, pos // PS]`` at offset ``pos % PS``;
    null rows scatter into the reserved null page.
    """
    ps = pool.shape[2]
    pos = pos.long()
    phys = torch.gather(page_table.long(), 1, (pos // ps)[:, None])[:, 0]
    off = pos % ps
    pool[:, phys, off] = new[:, :, 0].to(pool.dtype)
    return pool


def cache_write_pages(pool, kv, page_ids):
    """Write whole pages of prefilled K/V into the pool, in place.

    pool: [L,NP,PS,KV,hd]; kv: [L,1,n*PS,KV,hd] (page-aligned chunk of one
    sequence); page_ids: [n] physical destinations, one per page.
    """
    L, NP, PS, KV, hd = pool.shape
    kvr = kv.reshape(L, -1, PS, KV, hd)
    pool[:, page_ids.long()] = kvr.to(pool.dtype)
    return pool


def attention_prefill_chunk(q, k_ctx, v_ctx, k_new, v_new, offset, *,
                            window: int = 0):
    """Chunked-prefill attention: a chunk of queries at absolute positions
    ``offset + [0, C)`` attends to cached context (positions ``< offset``)
    plus itself causally.

    q: [B,C,H,hd]; k_ctx/v_ctx: [B,Sc,KV,hd]; k_new/v_new: [B,C,KV,hd];
    offset: [B] int. Plain softmax, mirroring ``attention_full``.
    """
    B, C, H, hd = q.shape
    Sc = k_ctx.shape[1]
    dev = q.device
    k = gqa_expand_kv(torch.cat([k_ctx, k_new], dim=1), H)
    v = gqa_expand_kv(torch.cat([v_ctx, v_new], dim=1), H)
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float()
    scores = scores / math.sqrt(hd)
    offset = offset.long()
    qpos = offset[:, None] + torch.arange(C, device=dev)[None, :]    # [B,C]
    kpos = torch.cat(
        [torch.arange(Sc, device=dev)[None, :].expand(B, Sc), qpos],
        dim=1)                                                       # [B,Sc+C]
    is_ctx = (torch.arange(Sc + C, device=dev) < Sc)[None, None, :]  # [1,1,Sc+C]
    ctx_ok = (kpos < offset[:, None])[:, None, :]                    # [B,1,Sc+C]
    causal_ok = kpos[:, None, :] <= qpos[:, :, None]                 # [B,C,Sc+C]
    ok = torch.where(is_ctx, ctx_ok, causal_ok)
    if window:
        ok &= kpos[:, None, :] > qpos[:, :, None] - window
    scores = torch.where(ok[:, None], scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshd->bqhd", probs, v)
    return out.reshape(B, C, H, hd)
