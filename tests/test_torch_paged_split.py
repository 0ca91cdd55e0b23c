"""The arithmetic of the split paged-attention kernel, emulated on the CPU.

``csrc/paged_attention.cu`` cuts each sequence's context into partitions of
``PARTITION`` positions aligned to position 0 (flash-decoding). Pass 1 writes
float32 partials (m_i, l_i, acc_i) per partition, from an online softmax over
tiles of 32 positions; pass 2 merges them in partition order. The CUDA kernel
runs only on a card (``tests/test_torch_cuda.py``), so this file emulates both
passes in float32 torch, as the kernel does them, and holds the result
against the JAX package's Pallas kernel (``interpret=True``) at the shapes of
its kernel test, within 2e-5.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models.layers import NEG, gather_kv_pages

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
H, KV, hd, PS = 4, 2, 16, 8
TILE = 32


def emulate_split(q, k_pages, v_pages, page_table, limit, *, window=0,
                  partition=tpa.PARTITION, own_only=True):
    """Both passes of the kernel in float32. ``own_only`` merges only the
    partitions that meet the row's range, as the kernel does; otherwise
    every partition, the empty ones as neutral partials (m = NEG, l = 0,
    acc = 0)."""
    B, _, Hq, d = q.shape
    _, ps, kvh, _ = k_pages.shape
    P = page_table.shape[1]
    G = Hq // kvh
    splits = tpa.partition_count(P, ps, partition)
    qg = q.reshape(B, kvh, G, d).float()
    k = gather_kv_pages(k_pages, page_table).float()     # [B, S, KV, hd]
    v = gather_kv_pages(v_pages, page_table).float()
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(B, kvh, G, d)
    m_out = torch.full((B, kvh, G), NEG)
    l_out = torch.zeros(B, kvh, G)
    for b in range(B):
        lim = int(limit[b])
        hi = min(lim, P * ps)
        lo = max(lim - window, 0) if window else 0
        parts = []
        for s in range(splits):                          # pass 1
            p0, p1 = max(s * partition, lo), min((s + 1) * partition, hi)
            m = torch.full((kvh, G), NEG)
            l = torch.zeros(kvh, G)
            acc = torch.zeros(kvh, G, d)
            if p0 >= p1 and own_only:
                continue
            for t0 in range(p0, p1, TILE):
                t1 = min(t0 + TILE, p1)
                sc = torch.einsum("kgh,skh->kgs", qg[b], k[b, t0:t1]) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.exp(sc - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "kgs,skh->kgh", p, v[b, t0:t1])
                m = m_new
            parts.append((m, l, acc))
        M = torch.full((kvh, G), NEG)                    # pass 2
        for m, _, _ in parts:
            M = torch.maximum(M, m)
        live = M > NEG
        l_tot = torch.zeros(kvh, G)
        acc_tot = torch.zeros(kvh, G, d)
        for m, l, acc in parts:
            w = torch.where(live, torch.exp(m - M), 0.0)
            l_tot = l_tot + l * w
            acc_tot = acc_tot + acc * w[..., None]
        out[b] = acc_tot / torch.clamp(l_tot, min=1e-30)[..., None]
        m_out[b], l_out[b] = M, l_tot
    return out.to(q.dtype), m_out, l_out


def inputs(S, limits, seed=41):
    """q, pools and a permuted page table covering S positions (the layout
    of the JAX package's kernel test), numpy float32 / int32."""
    rng = np.random.default_rng(seed)
    B, P = len(limits), S // PS
    NP = B * P + 1
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((NP, PS, KV, hd)).astype(np.float32)
    v = rng.standard_normal((NP, PS, KV, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, NP)).reshape(B, P).astype(np.int32)
    return q, k, v, pt, np.asarray(limits, np.int32)


@functools.lru_cache(maxsize=None)
def pallas(S, limits, window):
    arrays = inputs(S, limits)
    got = jpa.paged_attention_partial(*map(jnp.asarray, arrays),
                                      window=window, interpret=True)
    return [np.asarray(x) for x in got]


def check(S, limits, window, partition):
    arrays = inputs(S, limits)
    got = emulate_split(*map(torch.from_numpy, arrays), window=window,
                        partition=partition)
    for g, w in zip(got, pallas(S, limits, window)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    out, m, l = got
    for b, lim in enumerate(limits):
        if lim == 0:                  # all masked: zeros, m = NEG, l = 0
            assert (out[b] == 0).all() and (m[b] == NEG).all() \
                and (l[b] == 0).all()


@pytest.mark.parametrize("window", [0, 10])
@pytest.mark.parametrize("partition", [8, 16])
def test_split_matches_pallas(partition, window):
    """S = 32 in partitions of 8 or 16: every row past one partition spans
    several; limits 0, 1, partition boundaries, P * PS; window 10 starts
    mid-partition."""
    check(32, (0, 1, 8, 13, 16, 32), window, partition)


@pytest.mark.parametrize("window", [0, 100])
def test_split_at_the_wrappers_partition_matches_pallas(window):
    P_ = tpa.PARTITION
    check(4 * P_, (0, 1, P_, P_ + 1, 3 * P_ + 7, 4 * P_), window, P_)


def test_split_of_a_ragged_table_matches_pallas():
    """40 positions in partitions of 16: the last partition is cut short by
    the table's end."""
    check(40, (0, 1, 16, 33, 39, 40), 0, 16)


def test_neutral_partitions_change_nothing():
    """Merging every partition, the empty ones as neutral partials, gives
    the kernel's merge of the row's own partitions bit for bit."""
    arrays = [torch.from_numpy(a) for a in inputs(64, (0, 1, 20, 37, 64))]
    for window in (0, 10):
        own = emulate_split(*arrays, window=window, partition=16)
        every = emulate_split(*arrays, window=window, partition=16,
                              own_only=False)
        for a, b in zip(own, every):
            assert torch.equal(a, b)


def test_split_count_depends_on_the_table_width_only():
    """The grid's split dimension comes from the page table's width: the
    same for one row and for six, whatever the limits; a row's partials
    therefore do not depend on its batch."""
    q, k, v, pt, lim = (torch.from_numpy(a)
                        for a in inputs(64, (5, 64, 0, 33, 17, 48)))
    P = pt.shape[1]
    assert tpa.partition_count(pt[:1].shape[1], PS) \
        == tpa.partition_count(pt.shape[1], PS) \
        == math.ceil(P * PS / tpa.PARTITION)
    assert tpa.partition_count(P, PS, 16) == 4
    assert tpa.partition_count(5, PS, 16) == 3       # 40 positions
    batch = emulate_split(q, k, v, pt, lim, partition=16)
    for i in range(len(lim)):
        alone = emulate_split(q[i:i + 1], k, v, pt[i:i + 1], lim[i:i + 1],
                              partition=16)
        for a, b in zip(alone, batch):
            assert torch.equal(a[0], b[i])
