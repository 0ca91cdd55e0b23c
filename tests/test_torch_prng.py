"""The port's threefry sampler (``runtime/prng.py``) vs ``jax.random``.

Keys, folds, random bits and uniforms are integer work and must equal JAX's
bit for bit. The Gumbel transform ``-log(-log(u))`` calls each framework's
own ``log``; those round apart by at most one ulp per call, so the Gumbel
values are held to 2 ulp of ``max(|g|, 1)``: an ulp of the inner log moves
the outer one by up to 2^-23 absolute, which is one ulp of 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import sampling as js
from repro_torch.runtime import prng
from repro_torch.runtime import sampling as ts

torch.set_num_threads(1)
SEEDS = [0, 1, 42, -1, 2**31 - 1]
TINY = float(np.finfo(np.float32).tiny)


def ulp_err(got, want):
    """|got - want| in ulps of max(|want|, 1)."""
    spacing = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    return np.abs(got.astype(np.float64) - want) / spacing


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_bitwise(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), np.asarray(
        jax.random.PRNGKey(seed)))
    for data in (0, 1, 7, 1000, 2**31 + 5, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(key, data).numpy(),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


def test_prng_key_refuses_a_seed_wider_than_32_bits():
    with pytest.raises(OverflowError):
        prng.PRNGKey(2**31)


@pytest.mark.parametrize("n", [1, 2, 7, 4097, 32000])
def test_random_bits_and_uniform_bitwise(n):
    for seed, pos in ((0, 0), (3, 17), (42, 511)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        tk = prng.fold_in(prng.PRNGKey(seed), pos)
        np.testing.assert_array_equal(
            prng.random_bits(tk, n).numpy(),
            np.asarray(jax.random.bits(jk, (n,), jnp.uint32)).astype(np.int64))
        for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
            got = prng.uniform(tk, n, lo, hi).numpy()
            want = np.asarray(jax.random.uniform(jk, (n,), jnp.float32, lo, hi))
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))


@pytest.mark.parametrize("n", [7, 32000, 32001])
def test_gumbel_within_two_ulp(n):
    for seed, pos in ((0, 0), (5, 9), (7, 300)):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), pos)
        tk = prng.fold_in(prng.PRNGKey(seed), pos)
        got = prng.gumbel(tk, n).numpy()
        want = np.asarray(jax.random.gumbel(jk, (n,), jnp.float32))
        assert np.isfinite(got).all()
        assert ulp_err(got, want).max() <= 2


def test_batched_keys_match_vmap():
    keys = np.stack([js.request_key(js.SamplingParams(seed=4), rid)
                     for rid in range(1, 6)])
    pos = np.array([0, 3, 3, 100, 2**20], np.int32)
    want = np.asarray(jax.vmap(lambda k, p: jax.random.gumbel(
        jax.random.fold_in(k, p), (64,), jnp.float32))(
            jnp.asarray(keys), jnp.asarray(pos)))
    got = prng.gumbel(prng.fold_in(torch.from_numpy(keys.astype(np.int64)),
                                   torch.from_numpy(pos.astype(np.int64))), 64)
    assert got.shape == (5, 64)
    assert ulp_err(got.numpy(), want).max() <= 2


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_request_key_equals_reference(seed):
    for rid in (1, 2, 17, 1000):
        got = ts.request_key(ts.SamplingParams(seed=seed), rid)
        want = js.request_key(js.SamplingParams(seed=seed), rid)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
