"""The port's paged-attention kernel module vs the JAX package's Pallas kernel.

On the CPU the wrapper runs the kernel's plain version; it is held against the
reference's ``paged_attention_partial`` / ``paged_attention_decode`` (Pallas,
``interpret=True``, as the JAX package's own tests run it) and against
``attention_decode_paged``, at the shapes of ``tests/test_kernels.py``
(tolerance 2e-5, float32). The CUDA kernel itself runs only on a card:
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.models.layers import attention_decode_paged as j_decode_paged
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models.layers import NEG, attention_decode_paged

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
B, S, H, hd, PS = 3, 32, 4, 16, 8
POS = np.array([0, 13, 31], np.int32)


def rnd(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def pool(KV, seed=41, permute=True):
    """Random pool + a page table covering S positions (permuted or in
    order), the layout of the JAX package's kernel test."""
    P = S // PS
    NP = B * P + 1
    k, v = rnd((NP, PS, KV, hd), seed), rnd((NP, PS, KV, hd), seed + 1)
    ids = np.arange(1, NP)
    if permute:
        ids = np.random.default_rng(seed).permutation(ids)
    return k, v, ids[:B * P].reshape(B, P).astype(np.int32)


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("KV,window,permute", [(4, 0, True), (2, 0, True),
                                               (2, 10, True), (2, 0, False)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_partial_matches_pallas(KV, window, permute, plus_one):
    q = rnd((B, 1, H, hd), 40)
    k, v, pt = pool(KV, permute=permute)
    limit = (POS + 1 if plus_one else POS).astype(np.int32)
    got = tpa.paged_attention_partial(*t(q, k, v, pt, limit), window=window)
    want = jpa.paged_attention_partial(*j(q, k, v, pt, limit), window=window,
                                       interpret=True)
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_all_masked_row_is_zero():
    q = rnd((B, 1, H, hd), 40)
    k, v, pt = pool(2)
    out, m, l = tpa.paged_attention_partial(*t(q, k, v, pt, POS))
    assert (out[0] == 0).all() and (m[0] == NEG).all() and (l[0] == 0).all()
    want = jpa.paged_attention_partial(*j(q, k, v, pt, POS), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("KV,window", [(4, 0), (2, 0), (2, 10)])
@pytest.mark.parametrize("with_new", [False, True])
def test_decode_matches_reference(KV, window, with_new):
    q = rnd((B, 1, H, hd), 40)
    k, v, pt = pool(KV)
    kn, vn = rnd((B, 1, KV, hd), 42), rnd((B, 1, KV, hd), 43)
    tnew = tuple(t(kn, vn)) if with_new else None
    jnew = tuple(j(kn, vn)) if with_new else None
    got = tpa.paged_attention_decode(*t(q, k, v, pt, POS), window=window,
                                     new_kv=tnew)
    assert not torch.isnan(got).any()
    want = jpa.paged_attention_decode(*j(q, k, v, pt, POS), window=window,
                                      new_kv=jnew, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    gather = j_decode_paged(*j(q, k, v, pt, POS), window=window, new_kv=jnew)
    np.testing.assert_allclose(got.numpy(), np.asarray(gather), **TOL)
    port_gather = attention_decode_paged(*t(q, k, v, pt, POS),
                                         window=window, new_kv=tnew)
    np.testing.assert_allclose(got.numpy(), port_gather.numpy(), **TOL)


def test_cpu_tensors_never_count_launches():
    q = rnd((B, 1, H, hd), 40)
    k, v, pt = pool(2)
    before = tpa.paged_attention_partial.launches
    tpa.paged_attention_partial(*t(q, k, v, pt, POS))
    assert tpa.paged_attention_partial.launches == before
