"""The port's flash-attention and SSD chunk-scan kernels vs the JAX package,
on the CPU.

The same seeded numpy inputs go through the JAX function and the port's
counterpart. On the CPU each wrapper runs its kernel's plain version; the JAX
package's ``ops.flash_attention`` and ``ops.ssm_scan`` run their Pallas
kernels in interpret mode, at the shapes and with the tolerances of
``tests/test_kernels.py``: 2e-4 for flash attention (float32, summation order
only), 2e-3 for the SSD scan (a chunked algorithm against a sequential
recurrence, in float32). The plain versions against the JAX oracles
(``repro.kernels.ref``) agree to 2e-5: the same algorithm in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash_raw
from repro.kernels.ssm_scan import ssm_scan as j_ssm_raw
from repro.models.layers import attention_chunked as j_chunked
from repro.models.layers import attention_full as j_full
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import (ssm_chunk_scan, ssm_chunk_scan_ref,
                                          ssm_scan)
from repro_torch.models.layers import attention_chunked

torch.set_num_threads(1)
ORACLE_TOL = dict(rtol=2e-5, atol=2e-5)
FLASH_TOL = dict(rtol=2e-4, atol=2e-4)
SSD_TOL = dict(rtol=2e-3, atol=2e-3)
# tests/test_kernels.py's shape sets: (B, S, H, hd, bq, bk) and
# (B, S, H, P, N, chunk), plus an SSD scan shorter than one chunk
FLASH_SHAPES = [(2, 256, 4, 64, 64, 64), (1, 512, 2, 32, 128, 256)]
SSD_SHAPES = [(2, 256, 4, 16, 8, 64), (1, 128, 2, 32, 16, 32),
              (1, 48, 2, 16, 8, 64)]


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale) \
        .astype(np.float32)


def flash_inputs(B, S, H, hd, seed=8):
    return [rnd((B, S, H, hd), seed + i, 0.3) for i in range(3)]


def ssd_inputs(B, S, H, P, N, seed=14):
    rng = np.random.default_rng(seed)
    x = rnd((B, S, H, P), seed, 0.5)
    dt = np.log1p(np.exp(rnd((B, S, H), seed + 1))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 1.0, H)).astype(np.float32)
    Bm, Cm = rnd((B, S, N), seed + 2, 0.5), rnd((B, S, N), seed + 3, 0.5)
    return x, dt, A, Bm, Cm


def t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_wrapper_matches_pallas_and_oracle(shape, causal):
    B, S, H, hd, bq, bk = shape
    arrs = flash_inputs(B, S, H, hd)
    got = flash_attention(*t(*arrs), causal=causal, bq=bq, bk=bk)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    want = jops.flash_attention(*j(*arrs), causal=causal, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FLASH_TOL)
    plain = ref.flash_attention(*t(*arrs), causal=causal)
    np.testing.assert_allclose(
        plain.numpy(), np.asarray(jref.flash_attention(*j(*arrs),
                                                       causal=causal)),
        **ORACLE_TOL)


def test_flash_matches_model_chunked():
    """As tests/test_kernels.py::test_flash_attention_matches_model_chunked,
    with the port's attention_chunked held against the reference's too
    (also windowed)."""
    arrs = flash_inputs(2, 256, 4, 32, seed=11)
    a = flash_attention(*t(*arrs), causal=True, bq=64, bk=64)
    b = attention_chunked(*t(*arrs), causal=True, q_chunk=64, kv_chunk=64)
    np.testing.assert_allclose(a.numpy(), b.numpy(), **FLASH_TOL)
    for window in (0, 100):
        got = attention_chunked(*t(*arrs), q_chunk=64, kv_chunk=128,
                                window=window)
        want = j_chunked(*j(*arrs), q_chunk=64, kv_chunk=128, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **ORACLE_TOL)


@pytest.mark.parametrize("causal,window", [(True, 64), (True, 100),
                                           (False, 48)])
def test_flash_window_matches_model_attention_full(causal, window):
    """The window the port adds to the kernel: the wrapper and its plain
    version against the reference's windowed attention_full."""
    arrs = flash_inputs(1, 192, 2, 32, seed=12)
    want = np.asarray(j_full(*j(*arrs), causal=causal, window=window))
    got = flash_attention(*t(*arrs), causal=causal, bq=64, bk=64,
                          window=window)
    np.testing.assert_allclose(got.numpy(), want, **ORACLE_TOL)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssm_wrapper_matches_pallas_and_oracle(shape):
    B, S, H, P, N, chunk = shape
    arrs = ssd_inputs(B, S, H, P, N)
    got = ssm_scan(*t(*arrs), chunk=chunk)
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    want = jops.ssm_scan(*j(*arrs), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SSD_TOL)
    # the plain version (the wrapper's, the sequential oracle) against the
    # JAX oracle, y and the final state
    assert ssm_chunk_scan_ref is ref.ssm_chunk_scan
    y_o, h_o = ref.ssm_chunk_scan(*t(*arrs))
    jy, jh = jref.ssm_chunk_scan(*j(*arrs))
    np.testing.assert_allclose(y_o.numpy(), np.asarray(jy), **ORACLE_TOL)
    np.testing.assert_allclose(h_o.numpy(), np.asarray(jh), **ORACLE_TOL)


def test_ssm_initial_state_carries_the_recurrence():
    """Two halves scanned with the first half's final state handed on equal
    one scan of the whole (the hand-off ssd_chunked makes to decode)."""
    x, dt, A, Bm, Cm = t(*ssd_inputs(1, 128, 2, 32, 16, seed=40))
    y, h = ssm_chunk_scan(x, dt, A, Bm, Cm, chunk=32)
    y1, h1 = ssm_chunk_scan(x[:, :64], dt[:, :64], A, Bm[:, :64],
                            Cm[:, :64], chunk=32)
    y2, h2 = ssm_chunk_scan(x[:, 64:], dt[:, 64:], A, Bm[:, 64:],
                            Cm[:, 64:], chunk=32, h0=h1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(),
                               **ORACLE_TOL)
    np.testing.assert_allclose(h2.numpy(), h.numpy(), **ORACLE_TOL)
    y_o, h_o = ref.ssm_chunk_scan(x[:, 64:], dt[:, 64:], A, Bm[:, 64:],
                                  Cm[:, 64:], h0=h1)
    np.testing.assert_allclose(y_o.numpy(), y2.numpy(), **SSD_TOL)
    np.testing.assert_allclose(h_o.numpy(), h2.numpy(), **SSD_TOL)


def test_registry_keys_equal_the_reference():
    assert set(ops.SIMD) == set(jops.PALLAS)
    assert set(ops.REFERENCE) == set(jops.REFERENCE)
    assert ops.resolve("flash_attention", "cuda") is flash_attention
    assert ops.resolve("ssm_scan", "cuda") is ssm_scan
    assert ops.resolve("flash_attention") is ref.flash_attention
    with pytest.raises(KeyError):
        jops.resolve("ssm_scan", "reference")
    with pytest.raises(KeyError, match="not registered"):
        ops.resolve("ssm_scan", "reference")


@pytest.mark.parametrize("kernel", ["flash_attention", "ssm_scan"])
def test_refusals_and_no_fallback(kernel):
    """The reference's divisibility asserts are kept, no kernel ran on the
    CPU, and a tensor off the CPU (a meta tensor stands for one) launches
    the kernel or raises, before any build."""
    if kernel == "flash_attention":
        arrs, kw = flash_inputs(1, 96, 2, 16), dict(bq=64, bk=32)
        jfn, tfn = j_flash_raw, flash_attention
    else:
        arrs, kw = ssd_inputs(1, 96, 2, 16, 8), dict(chunk=64)
        jfn, tfn = j_ssm_raw, ssm_scan
    with pytest.raises(AssertionError):
        jfn(*j(*arrs), **kw)
    before = tfn.launches
    with pytest.raises(ValueError, match="divide"):
        tfn(*t(*arrs), **kw)
    tfn(*t(*arrs))
    assert tfn.launches == before
    with pytest.raises(ValueError):
        tfn(*[a.to("meta") for a in t(*arrs)])
