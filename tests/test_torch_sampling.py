"""The port's token selection vs the JAX package's on the same logits.

The policy masks, the penalties, greedy selection and the EOS fold are
checked bitwise, ties included. ``sample_tokens`` is fed the reference's own
Gumbel noise — ``jax.random.gumbel(jax.random.fold_in(key, pos))`` — and must
pick exactly the reference's tokens. ``masked_probs`` is a softmax, summed in
another order by each framework: it is held to 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampling as js
from repro_torch.runtime import sampling as ts

torch.set_num_threads(1)
B, V = 6, 64


def logits(seed, ties=False):
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32)
    if ties:                      # coarse grid: many exactly equal logits
        x = np.round(x * 2) / 2
    return x


TOPK = np.array([0, 1, 5, 64, 100, 3], np.int32)
TOPP = np.array([1.0, 0.5, 0.9, 0.3, 1.0, 0.75], np.float32)
TEMPS = np.array([0.0, 0.7, 1.0, 1.3, 0.0, 2.0], np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("use_p", [False, True])
def test_policy_mask_bitwise(ties, use_p):
    lg = logits(1, ties)
    got = ts.policy_mask(torch.from_numpy(lg), torch.from_numpy(TOPK),
                         torch.from_numpy(TOPP) if use_p else None)
    want = js.policy_mask(jnp.asarray(lg), jnp.asarray(TOPK),
                          jnp.asarray(TOPP) if use_p else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
def test_masked_probs(ties):
    lg = logits(2, ties)
    args = (TEMPS, TOPK, TOPP)
    got = ts.masked_probs(torch.from_numpy(lg),
                          *[torch.from_numpy(a) for a in args])
    want = js.masked_probs(jnp.asarray(lg), *[jnp.asarray(a) for a in args])
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_apply_penalties():
    lg = logits(3)
    counts = np.random.default_rng(4).integers(0, 3, (B, V)).astype(np.int32)
    pres = np.array([0.0, 0.5, -0.5, 1.5, 0.0, 2.0], np.float32)
    freq = np.array([0.0, 0.25, 0.0, -1.0, 0.0, 0.3], np.float32)
    got = ts.apply_penalties(*[torch.from_numpy(a)
                               for a in (lg, counts, pres, freq)])
    want = js.apply_penalties(*[jnp.asarray(a)
                                for a in (lg, counts, pres, freq)])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    zero = np.zeros(B, np.float32)
    same = ts.apply_penalties(torch.from_numpy(lg), torch.from_numpy(counts),
                              torch.from_numpy(zero), torch.from_numpy(zero))
    np.testing.assert_array_equal(same.numpy(), lg)   # penalties off: exact


@pytest.mark.parametrize("ties", [False, True])
def test_greedy_decode_select_bitwise(ties):
    lg = logits(5, ties)
    eos = np.array([-1, 3, -1, 7, 0, -1], np.int32)
    fin = np.array([False, False, True, True, False, False])
    zeros = np.zeros(B, np.float32)
    got_t, got_f = ts.decode_select(
        torch.from_numpy(lg), None, torch.from_numpy(zeros),
        torch.from_numpy(TOPK), torch.from_numpy(eos), torch.from_numpy(fin))
    keys = np.zeros((B, 2), np.uint32)
    want_t, want_f = js.decode_select(
        jnp.asarray(lg), jnp.asarray(keys), jnp.zeros(B, jnp.int32),
        jnp.asarray(zeros), jnp.asarray(TOPK), jnp.asarray(eos),
        jnp.asarray(fin))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))


def jax_noise(keys, pos):
    return np.array(jax.vmap(lambda k, p: jax.random.gumbel(
        jax.random.fold_in(k, p), (V,), jnp.float32))(
            jnp.asarray(keys), jnp.asarray(pos)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("use_p", [False, True])
@pytest.mark.parametrize("penalized", [False, True])
def test_sample_tokens_with_reference_noise(ties, use_p, penalized):
    lg = logits(6, ties)
    keys = np.stack([js.request_key(js.SamplingParams(seed=3), rid)
                     for rid in range(1, B + 1)])
    pos = np.arange(10, 10 + B, dtype=np.int32)
    counts = np.random.default_rng(7).integers(0, 2, (B, V)).astype(np.int32)
    pres = np.full(B, 0.4, np.float32)
    freq = np.full(B, 0.2, np.float32)
    pen_t = dict(counts=torch.from_numpy(counts),
                 presence=torch.from_numpy(pres),
                 frequency=torch.from_numpy(freq)) if penalized else {}
    pen_j = dict(counts=jnp.asarray(counts), presence=jnp.asarray(pres),
                 frequency=jnp.asarray(freq)) if penalized else {}
    got = ts.sample_tokens(
        torch.from_numpy(lg), torch.from_numpy(jax_noise(keys, pos)),
        torch.from_numpy(TEMPS), torch.from_numpy(TOPK),
        torch.from_numpy(TOPP) if use_p else None, **pen_t)
    want = js.sample_tokens(
        jnp.asarray(lg), jnp.asarray(keys), jnp.asarray(pos),
        jnp.asarray(TEMPS), jnp.asarray(TOPK),
        jnp.asarray(TOPP) if use_p else None, **pen_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_noise_is_keyed_by_request_and_position():
    k1 = ts.request_key(ts.SamplingParams(seed=1), 1)
    k2 = ts.request_key(ts.SamplingParams(seed=1), 2)
    assert np.array_equal(k1, ts.request_key(ts.SamplingParams(seed=1), 1))
    assert not np.array_equal(k1, k2)
    np.testing.assert_array_equal(
        k1, js.request_key(js.SamplingParams(seed=1), 1))
    a = ts.gumbel_noise([k1, k2], [5, 5], V, "cpu")
    b = ts.gumbel_noise([k1, k2], [5, 5], V, "cpu")
    c = ts.gumbel_noise([k1, k2], [6, 5], V, "cpu")
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])
    assert torch.equal(a[1], c[1])
    only = ts.gumbel_noise([k1, k2], [5, 5], V, "cpu", rows=[1])
    assert (only[0] == 0).all() and torch.equal(only[1], a[1])
    # threefry noise: the reference's, within 2 ulp of max(|g|, 1) (the two
    # frameworks' log round apart; the uniform bits are equal)
    want = jax_noise(np.stack([k1, k2]), np.array([5, 5], np.int32))
    spacing = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(a.numpy().astype(np.float64) - want) <= 2 * spacing).all()
