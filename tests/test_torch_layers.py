"""PyTorch port vs the JAX package: every ported ``models/layers`` function on
the same numpy-seeded inputs, float32 on the CPU, ``rtol=atol=1e-5`` (the two
frameworks sum in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def both(*arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def test_embed_lookup():
    emb = rnd((32, 8), 0)
    toks = np.random.default_rng(1).integers(0, 32, size=(2, 5))
    got = tl.embed_lookup(torch.from_numpy(emb), torch.from_numpy(toks),
                          torch.float32)
    close(got, jl.embed_lookup(jnp.asarray(emb), jnp.asarray(toks),
                               jnp.float32))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind):
    (x, w), (jx, jw) = both(rnd((2, 3, 16), 2), rnd((16,), 3))
    close(tl.norm(x, w, kind), jl.norm(jx, jw, kind))


def test_layernorm_bias():
    (x, w, b), (jx, jw, jb) = both(rnd((2, 16), 4), rnd((16,), 5),
                                   rnd((16,), 6))
    close(tl.layernorm(x, w, b), jl.layernorm(jx, jw, jb))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    x = rnd((2, 5, 4, 16), 7)
    pos = np.array([[3, 4, 5, 6, 7], [0, 1, 2, 9, 30]], np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    close(got, jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False), ("relu2", False)])
def test_mlp_apply(act, glu):
    p = {"w1": rnd((16, 24), 8, 0.25), "w2": rnd((24, 16), 9, 0.25),
         "w3": rnd((16, 24), 10, 0.25)}
    x = rnd((2, 3, 16), 11)
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), act, glu, torch.float32)
    close(got, jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), act, glu, jnp.float32))


def test_gqa_expand():
    k = rnd((2, 5, 2, 8), 12)
    close(tl.gqa_expand_kv(torch.from_numpy(k), 4),
          jl.gqa_expand_kv(jnp.asarray(k), 4))
    assert tl.gqa_expand(torch.from_numpy(k), 4)[1] == \
        jl.gqa_expand(jnp.asarray(k), 4)[1] == 2


@pytest.mark.parametrize("causal,window,q_offset",
                         [(True, 0, 0), (False, 0, 0), (True, 3, 0),
                          (True, 0, 4)])
def test_attention_full(causal, window, q_offset):
    (q, k, v), (jq, jk, jv) = both(rnd((2, 6, 4, 8), 13), rnd((2, 10, 2, 8), 14),
                                   rnd((2, 10, 2, 8), 15))
    got = tl.attention_full(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
    close(got, jl.attention_full(jq, jk, jv, causal=causal, window=window,
                                 q_offset=q_offset))


@pytest.mark.parametrize("with_new", [False, True])
def test_attend_cached(with_new):
    (q, k, v, kn, vn), (jq, jk, jv, jkn, jvn) = both(
        rnd((3, 1, 4, 8), 16), rnd((3, 12, 2, 8), 17), rnd((3, 12, 2, 8), 18),
        rnd((3, 1, 2, 8), 19), rnd((3, 1, 2, 8), 20))
    valid = np.arange(12)[None, :] < np.array([[0], [5], [12]])
    got = tl._attend_cached(q, k, v, torch.from_numpy(valid),
                            (kn, vn) if with_new else None)
    want = jl._attend_cached(jq, jk, jv, jnp.asarray(valid),
                             (jkn, jvn) if with_new else None)
    close(got, want)


def _paged(seed, B=3, P=4, ps=4, KV=2, hd=8):
    NP = B * P + 1
    k, v = rnd((NP, ps, KV, hd), seed), rnd((NP, ps, KV, hd), seed + 1)
    perm = np.random.default_rng(seed).permutation(np.arange(1, NP))
    pt = perm[:B * P].reshape(B, P).astype(np.int32)
    return k, v, pt


def test_gather_kv_pages():
    k, _, pt = _paged(21)
    close(tl.gather_kv_pages(torch.from_numpy(k), torch.from_numpy(pt)),
          jl.gather_kv_pages(jnp.asarray(k), jnp.asarray(pt)))


@pytest.mark.parametrize("window,with_new", [(0, False), (0, True),
                                             (5, False), (5, True)])
def test_attention_decode_paged(window, with_new):
    k, v, pt = _paged(22)
    q = rnd((3, 1, 4, 8), 23)
    kn, vn = rnd((3, 1, 2, 8), 24), rnd((3, 1, 2, 8), 25)
    pos = np.array([1, 9, 15], np.int32)
    got = tl.attention_decode_paged(
        *[torch.from_numpy(a) for a in (q, k, v, pt, pos)], window=window,
        new_kv=(torch.from_numpy(kn), torch.from_numpy(vn))
        if with_new else None)
    want = jl.attention_decode_paged(
        *[jnp.asarray(a) for a in (q, k, v, pt, pos)], window=window,
        new_kv=(jnp.asarray(kn), jnp.asarray(vn)) if with_new else None)
    close(got, want)


def test_cache_insert_paged():
    L, NP, ps, KV, hd = 2, 9, 4, 2, 8
    pool = rnd((L, NP, ps, KV, hd), 26)
    new = rnd((L, 3, 1, KV, hd), 27)
    pt = np.array([[1, 2], [3, 4], [0, 0]], np.int32)   # row 2: null page
    pos = np.array([5, 2, 0], np.int32)
    got = tl.cache_insert_paged(torch.from_numpy(pool.copy()),
                                torch.from_numpy(new), torch.from_numpy(pt),
                                torch.from_numpy(pos))
    want = jl.cache_insert_paged(jnp.asarray(pool), jnp.asarray(new),
                                 jnp.asarray(pt), jnp.asarray(pos))
    close(got, want)


def test_cache_write_pages():
    L, NP, ps, KV, hd = 2, 9, 4, 2, 8
    pool = rnd((L, NP, ps, KV, hd), 28)
    kv = rnd((L, 1, 3 * ps, KV, hd), 29)
    ids = np.array([7, 2, 5], np.int32)
    got = tl.cache_write_pages(torch.from_numpy(pool.copy()),
                               torch.from_numpy(kv), torch.from_numpy(ids))
    want = jl.cache_write_pages(jnp.asarray(pool), jnp.asarray(kv),
                                jnp.asarray(ids))
    close(got, want)


@pytest.mark.parametrize("window,offset", [(0, 0), (0, 8), (6, 8)])
def test_attention_prefill_chunk(window, offset):
    q, kn, vn = rnd((1, 4, 4, 8), 30), rnd((1, 4, 2, 8), 31), rnd((1, 4, 2, 8), 32)
    kc, vc = rnd((1, 16, 2, 8), 33), rnd((1, 16, 2, 8), 34)
    off = np.array([offset], np.int32)
    got = tl.attention_prefill_chunk(
        *[torch.from_numpy(a) for a in (q, kc, vc, kn, vn, off)],
        window=window)
    want = jl.attention_prefill_chunk(
        *[jnp.asarray(a) for a in (q, kc, vc, kn, vn, off)], window=window)
    close(got, want)
