"""The port's Mamba2 block (``models/mamba2.py``) vs the JAX package's, on the
CPU at the zamba2 smoke size (d_inner 128, head_dim 16, state_dim 8, chunk
16), float32.

The same seeded numpy inputs and parameters go through both. Tolerance
2e-5: the same algorithm in float32, summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm
from repro_torch.configs import smoke_config
from repro_torch.models import mamba2 as tm

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
SSM = smoke_config("zamba2-2.7b").ssm
H, P, N = SSM.n_heads, SSM.head_dim, SSM.state_dim


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def ssd_inputs(B, S, G, seed):
    x = rnd((B, S, H, P), seed, 0.5)
    dt = np.log1p(np.exp(rnd((B, S, H), seed + 1))).astype(np.float32)
    A = -np.exp(np.random.default_rng(seed).uniform(0, 1, H)) \
        .astype(np.float32)
    Bm, Cm = rnd((B, S, G, N), seed + 2, 0.5), rnd((B, S, G, N), seed + 3, 0.5)
    return x, dt, A, Bm, Cm


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    x, w = rnd((2, 9, 12), 1), rnd((4, 12), 2)
    st = rnd((2, 3, 12), 3) if with_state else None
    y, s = tm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          None if st is None else torch.from_numpy(st))
    jy, js = jm.causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if st is None else jnp.asarray(st))
    close(y, jy)
    close(s, js)


# S = 40 pads to 48 (three chunks of 16); S = 9 < chunk is one short chunk;
# G = 2 exercises the grouped heads of the CPU path
@pytest.mark.parametrize("S,G,with_h0", [(40, 1, False), (40, 1, True),
                                         (9, 1, True), (32, 2, False)])
def test_ssd_chunked(S, G, with_h0):
    x, dt, A, Bm, Cm = ssd_inputs(2, S, G, seed=S + G)
    h0 = rnd((2, H, P, N), 9, 0.3) if with_h0 else None
    y, h = tm.ssd_chunked(*[torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)],
                          SSM.chunk,
                          None if h0 is None else torch.from_numpy(h0))
    jy, jh = jm.ssd_chunked(*[jnp.asarray(a) for a in (x, dt, A, Bm, Cm)],
                            SSM.chunk, None if h0 is None else jnp.asarray(h0))
    assert y.shape == (2, S, H, P) and h.dtype == torch.float32
    close(y, jy)
    close(h, jh)


def test_ssd_decode():
    x, dt, A, Bm, Cm = ssd_inputs(3, 1, 1, seed=21)
    h = rnd((3, H, P, N), 22, 0.3)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], h)
    y, hn = tm.ssd_decode(*[torch.from_numpy(a) for a in args])
    jy, jhn = jm.ssd_decode(*[jnp.asarray(a) for a in args])
    close(y, jy)
    close(hn, jhn)


def block_params(seed=30):
    out = {}
    for i, (name, shape) in enumerate(sorted(
            tm.mamba_params_shapes(64, SSM).items())):
        if name in ("ln", "out_norm", "D_skip"):
            out[name] = 1.0 + rnd(shape, seed + i, 0.1)
        elif name == "A_log":
            out[name] = np.log(np.random.default_rng(seed + i).uniform(
                1, 16, shape)).astype(np.float32)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            out[name] = rnd(shape, seed + i, fan_in ** -0.5)
    return out


def test_mamba_params_shapes_equal_the_reference():
    assert tm.mamba_params_shapes(2560, smoke_config("zamba2-2.7b").ssm) == \
        jm.mamba_params_shapes(2560, smoke_config("zamba2-2.7b").ssm)


def test_mamba_block_prefill_then_decode():
    """A prefill of 20 tokens (two chunks, the second padded), then two
    decode steps from the states it hands over."""
    p = block_params()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = rnd((2, 20, 64), 40)
    out, (conv, ssm) = tm.mamba_block(tp, torch.from_numpy(x), SSM,
                                      torch.float32)
    jout, (jconv, jssm) = jm.mamba_block(jp, jnp.asarray(x), SSM,
                                         jnp.float32)
    close(out, jout)
    close(conv, jconv)
    close(ssm, jssm)
    for step in range(2):
        xt = rnd((2, 1, 64), 50 + step)
        out, (conv, ssm) = tm.mamba_block(tp, torch.from_numpy(xt), SSM,
                                          torch.float32, conv_state=conv,
                                          ssm_state=ssm, decode=True)
        jout, (jconv, jssm) = jm.mamba_block(jp, jnp.asarray(xt), SSM,
                                             jnp.float32, conv_state=jconv,
                                             ssm_state=jssm, decode=True)
        close(out, jout)
        close(conv, jconv)
        close(ssm, jssm)
