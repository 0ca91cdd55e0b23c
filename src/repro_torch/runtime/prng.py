"""Threefry-2x32 random bits, bit for bit those of the JAX package's sampler.

The port's own copy of the parts of ``jax.random`` (default implementation
``threefry2x32``, ``jax_threefry_partitionable`` on) that the serving
sampler uses: :func:`PRNGKey`, :func:`fold_in`, :func:`random_bits`,
:func:`uniform` and :func:`gumbel`, written as integer tensor ops so they run
on CPU and CUDA tensors alike.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words, the raw key
data of ``jax.random.PRNGKey``. Every op works on a batch of keys at once
(the leading dimensions), as ``jax.vmap`` over keys does. Words are kept in
int64 and masked to 32 bits after each add and shift, since PyTorch's
uint32 lacks most arithmetic.

The bits, and hence the uniforms, equal the reference's exactly. The
Gumbel transform ``-log(-log(u))`` calls the device's ``log``, which may
differ from XLA's by an ulp.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000              # float32 1.0
_F32_MANT = 23
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) of counts ``(x1, x2)``
    under key ``(k1, k2)``; all int64 uint32 words, broadcast together.
    Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def PRNGKey(seed: int, device=None):
    """The raw key of ``jax.random.PRNGKey(seed)``: the seed as a 32-bit
    integer (JAX's default, 64-bit types off), high word 0."""
    s = int(seed)
    if not -(1 << 31) <= s < (1 << 31):
        raise OverflowError(f"seed {s} does not fit a 32-bit integer")
    return torch.tensor([0, s & M32], dtype=torch.int64, device=device)


def fold_in(key, data):
    """``jax.random.fold_in``: hash ``data`` (an int, or an integer tensor
    of the keys' batch shape) into ``key`` [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                        data)
    return torch.stack([a, b], dim=-1)


def random_bits(key, n: int):
    """32 random bits per element of a 1-D shape ``(n,)`` for each key:
    int64 [..., n] holding uint32 values (the partitionable threefry
    layout: the counter is the element's index)."""
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[..., 0, None], key[..., 1, None],
                        torch.zeros_like(count), count)
    return a ^ b


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` [..., n]:
    23 random mantissa bits under exponent 0 give a float in [1, 2), less 1,
    scaled into [minval, maxval). XLA contracts ``floats * (hi - lo) + lo``
    into one fused multiply-add; the product of two float32 values is exact
    in float64, so the sum there rounds once, as the fused op does."""
    bits = (random_bits(key, n) >> (32 - _F32_MANT)) | _ONE_BITS
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    fused = floats.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, fused.float())


def gumbel(key, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` [..., n] (its default
    ``mode="low"``): ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, 1.0)))
