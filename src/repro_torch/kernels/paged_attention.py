"""Paged-attention decode: the Hopper kernel, its plain version and the wrapper.

The counterpart of the JAX package's ``kernels/paged_attention.py``. One token
per sequence attends to a KV cache stored as fixed-size physical pages through
a page table; the kernel computes attention over *cached* tokens only
(positions ``< limit``, and ``>= limit - window`` when windowed) and returns the
normalized output with its softmax partials (m, l). The merge of the current
token's K/V (the deferred insert) stays outside the kernel, in
``paged_attention_decode``, as it does in the reference.

* ``paged_attention_partial`` — the wrapper. For a tensor on the CPU it runs
  the plain version; for a CUDA tensor it launches the CUDA kernel
  (``csrc/paged_attention.cu``) or raises. The kernel splits the context into
  partitions of ``PARTITION`` positions (flash-decoding): one launcher call
  enqueues both its passes, the partials of each partition into a scratch
  buffer allocated here and their merge, so one launch means both passes.
  ``paged_attention_partial.launches`` counts those launches, and nothing
  else.
* ``paged_attention_partial_ref`` — the plain PyTorch version: a gather through
  the page table and a masked softmax, in float32.
"""
from __future__ import annotations

import math

import torch

from ..models.layers import NEG, gather_kv_pages
from ._cuda import DTYPE_CODES, FLOAT, INT, PTR, function, launch

MAX_HEAD_DIM = 256
# positions per partition of the kernel's first pass: a multiple of its
# 32-position tile; partitions are aligned to position 0
PARTITION = 64


def partition_count(pages: int, page_size: int,
                    partition: int = PARTITION) -> int:
    """The kernel's split dimension: partitions that cover the page table's
    ``pages * page_size`` positions. It depends on the table's width only,
    never on the batch or the limits, so a row's partitions, and its result,
    are the same in any batch."""
    return -(-pages * page_size // partition)


def paged_attention_partial_ref(q, k_pages, v_pages, page_table, limit, *,
                                window: int = 0):
    """Plain version of the kernel. Same contract as
    :func:`paged_attention_partial`; arithmetic in float32."""
    B, _, H, hd = q.shape
    NP, PS, KV, _ = k_pages.shape
    G = H // KV
    qg = q.reshape(B, KV, G, hd).float()
    k = gather_kv_pages(k_pages, page_table).float()     # [B, S, KV, hd]
    v = gather_kv_pages(v_pages, page_table).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k) * (1.0 / math.sqrt(hd))
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    limit = limit.long()[:, None]
    valid = kpos < limit
    if window:
        valid &= kpos >= limit - window
    valid = valid[:, None, None]
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1)                                   # NEG when all masked
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgs,bskh->bkgh", p, v)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out, m, l


def _launch_cuda(q, k_pages, v_pages, page_table, limit, window):
    B, _, H, hd = q.shape
    NP, PS, KV, _ = k_pages.shape
    P = page_table.shape[1]
    if H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes {q.dtype}/{k_pages.dtype}/"
                         f"{v_pages.dtype}: need one of float32, bfloat16")
    if v_pages.shape != k_pages.shape or tuple(page_table.shape[:1]) != (B,) \
            or tuple(limit.shape) != (B,):
        raise ValueError("paged attention: inconsistent shapes")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_table", page_table), ("limit", limit)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if page_table.dtype != torch.int32 or limit.dtype != torch.int32:
        raise ValueError("page_table and limit must be int32")
    G = H // KV
    splits = partition_count(P, PS, PARTITION)
    out = torch.empty((B, KV, G, hd), dtype=q.dtype, device=q.device)
    m = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    l = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
    # the first pass's float32 partials: acc [B,KV,splits,G,hd], m, l
    scratch = torch.empty(B * KV * splits * G * (hd + 2),
                          dtype=torch.float32, device=q.device)
    fn = function("paged_attention", "paged_attention_partial_launch",
                  [PTR] * 9 + [INT] * 7 + [FLOAT] + [INT] * 3)
    launch("paged_attention_partial", fn, q.device, q.data_ptr(),
           k_pages.data_ptr(), v_pages.data_ptr(), page_table.data_ptr(),
           limit.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
           scratch.data_ptr(), B, KV, G, hd, PS, P, int(window),
           1.0 / math.sqrt(hd), PARTITION, splits, DTYPE_CODES[q.dtype])
    paged_attention_partial.launches += 1
    return out, m, l


def paged_attention_partial(q, k_pages, v_pages, page_table, limit, *,
                            window: int = 0):
    """Cache-only paged attention with softmax partials.

    q: [B,1,H,hd]; k_pages/v_pages: [NP,PS,KV,hd]; page_table: [B,P] int32;
    limit: [B] int32 — positions ``< limit`` (and ``>= limit - window`` when
    windowed) are attended. Returns (out [B,KV,G,hd] normalized in q's dtype,
    m [B,KV,G], l [B,KV,G] float32). An all-masked row gives zeros, m = NEG
    and l = 0. CPU tensors take the plain version; CUDA tensors launch the
    kernel.
    """
    if q.device.type == "cpu":
        return paged_attention_partial_ref(q, k_pages, v_pages, page_table,
                                           limit, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention has no kernel for {q.device}")
    return _launch_cuda(q.contiguous(), k_pages, v_pages,
                        page_table.to(torch.int32).contiguous(),
                        limit.to(torch.int32).contiguous(), window)


paged_attention_partial.launches = 0


def paged_attention_decode(q, k_pages, v_pages, page_table, pos, *,
                           window: int = 0, new_kv=None):
    """Drop-in counterpart of ``attention_decode_paged`` through the kernel.

    ``new_kv=(k_new, v_new)`` runs deferred-insert: cache positions ``< pos``
    from the kernel, the new token's K/V merged online here; without it,
    positions ``<= pos`` must already be in the pool. Returns [B,1,H,hd].
    """
    B, _, H, hd = q.shape
    KV = k_pages.shape[2]
    G = H // KV
    limit = (pos if new_kv is not None else pos + 1).to(torch.int32)
    o_c, m_c, l_c = paged_attention_partial(q, k_pages, v_pages, page_table,
                                            limit, window=window)
    if new_kv is None:
        return o_c.reshape(B, 1, H, hd)
    k_new, v_new = new_kv
    qg = q.reshape(B, KV, G, hd)
    s_new = torch.einsum("bkgh,bkh->bkg", qg.float(),
                         k_new[:, 0].float()) * (1.0 / math.sqrt(hd))
    m_tot = torch.maximum(m_c, s_new)
    alpha = torch.exp(m_c - m_tot)                       # [B,KV,G]
    p_n = torch.exp(s_new - m_tot)
    acc = o_c.float() * (l_c * alpha)[..., None] \
        + p_n[..., None] * v_new[:, 0, :, None, :].float()
    out = acc / (l_c * alpha + p_n)[..., None]
    return out.to(q.dtype).reshape(B, 1, H, hd)
