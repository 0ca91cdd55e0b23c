"""Tests of the port that need a CUDA card (marked ``needs_cuda``).

They skip where there is no card; on one, run them with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

This file imports neither ``jax`` nor the JAX package, so it runs on a
machine that has only PyTorch: the CUDA kernel is held against its plain
PyTorch version, and the engine on the card against ``serve_sequential``.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models import api
from repro_torch.models.layers import NEG, attention_decode_paged
from repro_torch.runtime.engine import (Engine, EngineConfig, RequestSpec,
                                        serve_sequential)

torch.set_num_threads(1)
pytestmark = pytest.mark.needs_cuda


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: every worker collects
    the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def rnd(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def pool(B, P, ps, KV, hd, seed, dev, dt):
    NP = B * P + 1
    k, v = rnd((NP, ps, KV, hd), seed), rnd((NP, ps, KV, hd), seed + 1)
    perm = np.random.default_rng(seed).permutation(np.arange(1, NP))
    pt = torch.from_numpy(perm.reshape(B, P).astype(np.int32))
    return k.to(dev, dt), v.to(dev, dt), pt.to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,hd,ps,window",
                         [(32, 4, 64, 16, 0), (4, 2, 16, 4, 0),
                          (4, 2, 16, 8, 10), (8, 8, 128, 64, 0),
                          (6, 2, 20, 5, 0)])
def test_kernel_matches_plain(cuda, dtype, H, KV, hd, ps, window):
    dt = getattr(torch, dtype)
    B, P = 6, 8
    k, v, pt = pool(B, P, ps, KV, hd, 50, cuda, dt)
    q = rnd((B, 1, H, hd), 52).to(cuda, dt)
    limit = torch.tensor([0, 1, ps, ps + 1, P * ps - 1, P * ps],
                         dtype=torch.int32, device=cuda)
    before = tpa.paged_attention_partial.launches
    got = tpa.paged_attention_partial(q, k, v, pt, limit, window=window)
    torch.cuda.synchronize()
    assert tpa.paged_attention_partial.launches == before + 1
    want = tpa.paged_attention_partial_ref(q, k, v, pt, limit, window=window)
    # float32: summation order only; bf16: the output is rounded to bf16,
    # one ulp is 2^-7 below 2
    tol = 2e-5 if dtype == "float32" else 1.6e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=1e-4)
    assert (got[0][0] == 0).all() and (got[1][0] == NEG).all() \
        and (got[2][0] == 0).all()


@pytest.mark.parametrize("with_new", [False, True])
def test_decode_matches_gather_path(cuda, with_new):
    B, P, ps, KV, hd, H = 3, 4, 8, 2, 16, 4
    k, v, pt = pool(B, P, ps, KV, hd, 60, cuda, torch.float32)
    q = rnd((B, 1, H, hd), 62).to(cuda)
    new = (rnd((B, 1, KV, hd), 63).to(cuda), rnd((B, 1, KV, hd), 64).to(cuda))
    pos = torch.tensor([0, 13, 31], device=cuda)
    nkv = new if with_new else None
    got = tpa.paged_attention_decode(q, k, v, pt, pos, new_kv=nkv)
    want = attention_decode_paged(q, k, v, pt, pos, new_kv=nkv)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_kernel_rejects_bad_inputs(cuda):
    k, v, pt = pool(2, 2, 4, 2, 16, 70, cuda, torch.float32)
    q = rnd((2, 1, 4, 16), 71).to(cuda)
    limit = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtypes"):
        tpa.paged_attention_partial(q.double(), k, v, pt, limit)
    with pytest.raises(ValueError, match="on"):
        tpa.paged_attention_partial(q, k.cpu(), v, pt, limit)


def test_engine_on_the_card_equals_serve_sequential(cuda):
    cfg = smoke_config("tinyllama-1.1b")
    params = api.init_params(cfg, 0, device=cuda)
    rng = np.random.default_rng(0)
    specs = [RequestSpec(tuple(rng.integers(0, cfg.vocab, int(n)).tolist()),
                         6) for n in rng.integers(1, 9, size=6)]
    engine = Engine(cfg, EngineConfig(slots=2, prompt_buckets=(8,),
                                      max_seq=14, page_size=4,
                                      prefill_chunk=4),
                    params=params, device=cuda)
    tpa.paged_attention_partial.launches = 0
    reqs = engine.run(specs)
    assert tpa.paged_attention_partial.launches == \
        engine.stats()["decode_steps"] * cfg.n_layers
    got = [engine.finalize_request(r) for r in reqs]
    seq = serve_sequential(cfg, params, specs, max_seq=14,
                           prompt_buckets=(8,), page_size=4, device=cuda)
    assert got == [seq["tokens"][i + 1] for i in range(len(specs))]
