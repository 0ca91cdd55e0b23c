"""Tests of the port that need a CUDA card (marked ``needs_cuda``).

They skip where there is no card; on one, run them with

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q

This file imports neither ``jax`` nor the JAX package, so it runs on a
machine that has only PyTorch: each CUDA kernel is held against its plain
PyTorch version, the engine on the card against ``serve_sequential``, and
the threefry noise on the card against the same noise on the CPU, and the
hybrid family's prefill through the flash-attention and SSD kernels.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm
from repro_torch.kernels.flash_attention import flash_attention, flash_route
from repro_torch.kernels.matmul import matmul, matmul_route
from repro_torch.kernels.ssm_scan import ssm_chunk_scan, ssm_scan
from repro_torch.kernels.programs import frontend_programs, symbols_of
from repro_torch.models import api
from repro_torch.models.layers import NEG, attention_decode_paged
from repro_torch.runtime import prng
from repro_torch.runtime.engine import (Engine, EngineConfig, RequestSpec,
                                        serve_sequential)
from repro_torch.runtime.sampling import (SamplingParams, gumbel_noise,
                                          request_key)

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


def limits_for(P, ps):
    """Row 0 all masked, then 1, page and partition boundaries and the
    table's end; a long table adds positions deep into it."""
    if P * ps <= 512:
        return [0, 1, ps, ps + 1, P * ps - 1, P * ps]
    part = tpa.PARTITION
    return [0, 1, part, 7 * part + 1, P * ps - 1, P * ps]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,hd,ps,window,P",
                         [(32, 4, 64, 16, 0, 8), (4, 2, 16, 4, 0, 8),
                          (4, 2, 16, 8, 10, 8), (8, 8, 128, 64, 0, 8),
                          (6, 2, 20, 5, 0, 8),
                          # P * ps = 4096: many partitions, and windows that
                          # start mid-partition
                          (32, 4, 64, 16, 0, 256), (32, 4, 64, 16, 1000, 256),
                          (4, 2, 16, 8, 10, 512), (8, 8, 128, 64, 300, 64)])
def test_kernel_matches_plain(cuda, dtype, H, KV, hd, ps, window, P):
    dt = getattr(torch, dtype)
    B = 6
    k, v, pt = pool(B, P, ps, KV, hd, 50, cuda, dt)
    q = rnd((B, 1, H, hd), 52).to(cuda, dt)
    limit = torch.tensor(limits_for(P, ps), dtype=torch.int32, device=cuda)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 300])
def test_kernel_result_of_a_row_does_not_depend_on_its_batch(cuda, dtype,
                                                            window):
    """A row's (out, m, l) launched in a batch of 6 equals, bit for bit, the
    same row launched alone, in the batch reversed, and beside rows whose
    limits changed: its partitions depend on its own limit and window."""
    dt = getattr(torch, dtype)
    B, P, ps, KV, hd, H = 6, 64, 16, 4, 64, 32
    k, v, pt = pool(B, P, ps, KV, hd, 54, cuda, dt)
    q = rnd((B, 1, H, hd), 56).to(cuda, dt)
    lim = [0, 1, 160, 333, 544, P * ps]
    limit = torch.tensor(lim, dtype=torch.int32, device=cuda)
    run = functools.partial(tpa.paged_attention_partial, window=window)
    batch = run(q, k, v, pt, limit)
    rev = run(q.flip(0), k, v, pt.flip(0), limit.flip(0))
    for i in range(B):
        alone = run(q[i:i + 1], k, v, pt[i:i + 1], limit[i:i + 1])
        others = limit.clone()
        others[torch.arange(B, device=cuda) != i] = lim[(i + 3) % B]
        mixed = run(q, k, v, pt, others)
        for x, a, r, mx in zip(batch, alone, rev, mixed):
            assert torch.equal(x[i], a[0])
            assert torch.equal(x[i], r[B - 1 - i])
            assert torch.equal(x[i], mx[i])


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


# the paper kernels: (kernel, dtype, operand shapes, the TPU tiles): the
# shapes of tests/test_kernels.py, odd shapes whose edges the kernels mask,
# and one large shape each
PAPER_CASES = [
    ("axpy", "float32", [(512,), (512,)], dict(block=128)),
    ("axpy", "bfloat16", [(4096,), (4096,)], dict(block=1024)),
    ("axpy", "float32", [(1001,), (1001,)], {}),
    ("axpy", "bfloat16", [(1 << 24,), (1 << 24,)], {}),
    ("matvec", "float32", [(512, 512), (512,)], dict(bm=256, bk=256)),
    ("matvec", "float32", [(1024, 256), (256,)], dict(bm=256, bk=256)),
    ("matvec", "bfloat16", [(33, 37), (37,)], {}),
    ("matvec", "float32", [(4096, 8192), (8192,)], {}),
    ("stencil2d", "float32", [(256, 256)], dict(bm=128, bn=128)),
    ("stencil2d", "float32", [(128, 384)], dict(bm=64, bn=128)),
    ("stencil2d", "float32", [(37, 53)], {}),
    ("stencil2d", "float32", [(4096, 4096)], {}),
    ("stencil2d", "bfloat16", [(256, 256)], dict(bm=128, bn=128)),
    ("stencil2d", "bfloat16", [(37, 53)], {}),
    ("stencil2d", "bfloat16", [(4096, 4096)], {}),
    ("matmul", "float32", [(256, 256), (256, 256)], dict(bm=128, bn=128,
                                                         bk=128)),
    ("matmul", "bfloat16", [(512, 384), (384, 256)], dict(bm=128, bn=128,
                                                          bk=128)),
    ("matmul", "bfloat16", [(128, 512), (512, 128)], dict(bm=128, bn=128,
                                                          bk=256)),
    ("matmul", "float32", [(100, 72), (72, 36)], {}),
    ("matmul", "bfloat16", [(100, 72), (72, 36)], {}),
    ("matmul", "bfloat16", [(2048, 1024), (1024, 4096)], {}),
    ("matmul", "float32", [(2048, 1024), (1024, 512)], {}),
    # bfloat16 on the wgmma route with ragged M, K and N (TMA zero-fills)
    ("matmul", "bfloat16", [(1000, 200), (200, 1032)],
     dict(bm=1000, bn=1032, bk=200)),
    ("matmul", "bfloat16", [(4100, 520), (520, 264)],
     dict(bm=4100, bn=264, bk=520)),
    ("matmul", "bfloat16", [(1, 64), (64, 64)], {}),
]


@pytest.mark.parametrize("kernel,dtype,shapes,tiles", PAPER_CASES,
                         ids=[f"{k}-{d}-{'x'.join(map(str, s[0]))}"
                              for k, d, s, _ in PAPER_CASES])
def test_paper_kernel_matches_plain(cuda, kernel, dtype, shapes, tiles):
    dt = getattr(torch, dtype)
    args = [rnd(s, 80 + i).to(cuda, dt) for i, s in enumerate(shapes)]
    if kernel == "axpy":
        args = [2.5] + args
    fn = ops.resolve(kernel, "cuda")
    before = fn.launches
    if kernel == "matmul":
        (M, K), (_, N) = shapes
        route = matmul_route(M, N, K, dt, args[0].data_ptr(),
                             args[1].data_ptr())
        on_route = fn.launches_by_route[route]
    got = fn(*args, **tiles)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    if kernel == "matmul":
        assert fn.launches_by_route[route] == on_route + 1
    want = ops.resolve(kernel, "reference")(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    assert (err <= ref.error_bound(kernel, args, want)).all(), err.max()


def test_paper_kernels_run_misaligned_operands(cuda):
    """Views that start 4 bytes into their storage take the element loads."""
    buf = rnd((3, 1030), 90).to(cuda)
    x, y = buf[0, 1:1025], buf[1, 3:1027]
    got = ops.resolve("axpy", "cuda")(-1.5, x, y)
    assert torch.equal(got, ref.axpy(-1.5, x, y))
    a = rnd((64 * 128 + 1,), 91).to(cuda)[1:].view(64, 128)
    b = rnd((129,), 92).to(cuda)[1:]
    for kernel, args in (("matvec", (a, b)), ("matmul", (a, a.T[:, :1]
                                                          .contiguous()))):
        got = ops.resolve(kernel, "cuda")(*args)
        want = getattr(ref, kernel)(*args)
        assert ((got - want).abs()
                <= ref.error_bound(kernel, args, want)).all()


@pytest.mark.parametrize("M,K,N,dtype,offset,route", [
    (8192, 8192, 8192, "bfloat16", 0, "wgmma"),
    (1000, 200, 1032, "bfloat16", 0, "wgmma"),
    (100, 72, 36, "bfloat16", 0, "mma"),
    (64, 128, 128, "bfloat16", 1, "mma"),
    (100, 72, 36, "float32", 0, "fma"),
    # float32 over 25 k steps, both stages: ragged M and N, whole quads;
    # A 4 bytes into its storage; K and N no multiple of 4
    (1000, 200, 1032, "float32", 0, "fma"),
    (1000, 200, 1032, "float32", 1, "fma"),
    (1000, 203, 1030, "float32", 0, "fma"),
])
def test_matmul_takes_its_route(cuda, M, K, N, dtype, offset, route):
    """Each route launches its own kernel (``offset`` starts A that many
    elements into its storage) and agrees with the plain version."""
    dt = getattr(torch, dtype)
    a = rnd((M * K + offset,), 94).to(cuda, dt)[offset:].view(M, K)
    b = rnd((K, N), 95).to(cuda, dt)
    assert matmul_route(M, N, K, dt, a.data_ptr(), b.data_ptr()) == route
    counts = dict(matmul.launches_by_route)
    got = matmul(a, b, bm=M, bn=N, bk=K)
    torch.cuda.synchronize()
    counts[route] += 1
    assert matmul.launches_by_route == counts
    want = ref.matmul(a, b)
    assert ((got.float() - want.float()).abs()
            <= ref.error_bound("matmul", [a, b], want)).all()


def test_launchers_refuse_a_route_whose_preconditions_fail(cuda):
    """cudaErrorInvalidValue (1), before any launch: wgmma on a misaligned
    A or on N % 8 != 0, mma.sync or wgmma on float32, fma on bfloat16; the
    flash kernels likewise by dtype."""
    mm = tmm.launcher()
    stream = torch.cuda.current_stream().cuda_stream
    a = torch.zeros(64 * 64 + 8, dtype=torch.bfloat16, device=cuda)
    c = torch.empty(64 * 64, dtype=torch.bfloat16, device=cuda)
    p = a.data_ptr()
    for args in ((p + 2, p, 64, 64, 64, 1, 2), (p, p, 64, 60, 64, 1, 2),
                 (p, p, 64, 64, 64, 0, 2), (p, p, 64, 64, 64, 0, 1),
                 (p, p, 64, 64, 64, 1, 0)):
        assert mm(args[0], args[1], c.data_ptr(), *args[2:], stream) == 1
    fa = tfa.launcher()
    for dtype, route in ((0, 1), (1, 0)):
        assert fa(p, p, p, c.data_ptr(), 1, 64, 1, 64, 0.125, 1, 0, dtype,
                  route, stream) == 1


def test_paper_kernels_refuse_what_they_do_not_take(cuda):
    x = rnd((256,), 93).to(cuda)
    with pytest.raises(ValueError, match="dtypes"):
        ops.resolve("axpy", "cuda")(1.0, x.half(), x.half())
    with pytest.raises(ValueError, match="dtypes"):
        ops.resolve("stencil2d", "cuda")(x.reshape(16, 16).half())
    with pytest.raises(ValueError, match="on"):
        ops.resolve("matvec", "cuda")(x.reshape(16, 16), x[:16].cpu())


@pytest.mark.parametrize("kernel", ["axpy", "matvec", "stencil2d", "matmul"])
def test_simd_program_launches_the_kernel(cuda, kernel):
    args = {"axpy": lambda: (2.5, rnd((512,), 1).to(cuda),
                             rnd((512,), 2).to(cuda)),
            "matvec": lambda: (rnd((256, 128), 3).to(cuda),
                               rnd((128,), 4).to(cuda)),
            "stencil2d": lambda: (rnd((64, 96), 5).to(cuda),),
            "matmul": lambda: (rnd((128, 64), 6).to(cuda, torch.bfloat16),
                               rnd((64, 32), 7).to(cuda, torch.bfloat16))
            }[kernel]()
    extent = args[1].shape[0] if kernel == "axpy" else args[0].shape[0]
    syms = symbols_of(kernel, args)
    simd = frontend_programs(kernel, syms, extent, simd=True)["cuda"]
    work = frontend_programs(kernel, syms, extent, simd=False)["cuda"]
    fn = ops.lower_kernel_program(simd)
    before = fn.launches
    got = fn(*args)
    want = ops.lower_kernel_program(work)(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert ((got.float() - want.float()).abs()
            <= ref.error_bound(kernel, args, want)).all()


def test_threefry_noise_on_the_card_equals_the_cpu(cuda):
    keys = np.stack([request_key(SamplingParams(seed=s), rid)
                     for s, rid in ((0, 1), (7, 2), (123, 999))])
    pos = np.array([0, 130, 4095])
    for dev in ("cpu", cuda):
        k = prng.fold_in(torch.from_numpy(keys.astype(np.int64)).to(dev),
                         torch.from_numpy(pos).to(dev))
        if dev == "cpu":
            bits, uni = prng.random_bits(k, 32000), prng.uniform(k, 32000)
        else:
            assert torch.equal(prng.random_bits(k, 32000).cpu(), bits)
            assert torch.equal(prng.uniform(k, 32000).cpu(), uni)
    want = gumbel_noise(keys, pos, 32000, "cpu").numpy()
    got = gumbel_noise(keys, pos, 32000, cuda).cpu().numpy()
    spacing = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert (np.abs(got.astype(np.float64) - want) <= 2 * spacing).all()


# flash attention: tests/test_kernels.py's shapes (float32, tolerance 2e-4),
# ragged and odd-width shapes the kernel masks, windows shorter than S (the
# kernel skips the kv tiles left of them), and the zamba2 prefill shape in
# bfloat16, where both versions sum in float32 from the same inputs and
# round the output once: one bf16 ulp of the larger, 2^-7 |x|
FLASH_CASES = [
    ((2, 256, 4, 64), True, 0, "float32", dict(bq=64, bk=64)),
    ((2, 256, 4, 64), False, 0, "float32", dict(bq=64, bk=64)),
    ((1, 512, 2, 32), True, 0, "float32", dict(bq=128, bk=256)),
    ((1, 512, 2, 32), False, 0, "float32", dict(bq=128, bk=256)),
    ((1, 100, 3, 80), True, 0, "float32", {}),
    ((2, 72, 2, 128), False, 0, "float32", {}),
    ((1, 512, 32, 80), True, 0, "bfloat16", {}),
    ((1, 512, 4, 80), True, 128, "float32", dict(bq=512, bk=512)),
    ((1, 300, 2, 64), True, 100, "float32", dict(bq=300, bk=300)),
    ((2, 256, 2, 32), False, 64, "float32", dict(bq=64, bk=64)),
    ((1, 1024, 32, 80), True, 256, "bfloat16", dict(bq=1024, bk=1024)),
    # bfloat16 on the tensor-core route: ragged S, hd 64 / 80 / 128, a head
    # dim that is no multiple of 8 (element loads), non-causal, a window
    ((1, 100, 3, 80), True, 0, "bfloat16", {}),
    ((2, 256, 4, 64), True, 0, "bfloat16", dict(bq=64, bk=64)),
    ((2, 72, 2, 128), True, 0, "bfloat16", {}),
    ((1, 130, 2, 37), False, 0, "bfloat16", {}),
    ((1, 512, 8, 80), False, 0, "bfloat16", {}),
    ((1, 300, 2, 64), True, 100, "bfloat16", dict(bq=300, bk=300)),
    ((1, 100, 3, 80), False, 40, "bfloat16", {}),
]


@pytest.mark.parametrize("shape,causal,window,dtype,tiles", FLASH_CASES)
def test_flash_attention_matches_plain(cuda, shape, causal, window, dtype,
                                       tiles):
    dt = getattr(torch, dtype)
    q, k, v = (rnd(shape, 100 + i).mul(0.3).to(cuda, dt) for i in range(3))
    before = flash_attention.launches
    counts = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal, window=window, **tiles)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    counts[flash_route(dt)] += 1
    assert flash_attention.launches_by_route == counts
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    assert got.dtype == dt and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    bound = 2e-4 if dtype == "float32" else \
        2.0 ** -7 * torch.maximum(want.float().abs(), got.float().abs()) \
        + 1e-6
    assert bool(torch.isfinite(got).all()) and (err <= bound).all(), \
        err.max()


# the SSD chunk scan against the sequential oracle: tests/test_kernels.py's
# shapes and one shorter than a chunk (float32, tolerance 2e-3), with and
# without an initial state, and the zamba2 shape with x, B, C in bfloat16
# (y is rounded to bf16 once: 2^-7 |want| beside the float32 tolerance)
SSD_CASES = [
    ((2, 256, 4, 16, 8), 64, "float32"),
    ((1, 128, 2, 32, 16), 32, "float32"),
    ((1, 48, 2, 16, 8), 64, "float32"),
    ((1, 512, 80, 64, 64), 256, "bfloat16"),
]


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape,chunk,dtype", SSD_CASES)
def test_ssm_scan_matches_sequential_oracle(cuda, shape, chunk, dtype,
                                            with_h0):
    B, S, H, P, N = shape
    dt = getattr(torch, dtype)
    x = rnd((B, S, H, P), 110).mul(0.5).to(cuda, dt)
    dts = torch.nn.functional.softplus(rnd((B, S, H), 111)).to(cuda)
    A = -torch.exp(torch.from_numpy(np.random.default_rng(112).uniform(
        0, 1, H).astype(np.float32))).to(cuda)
    Bm = rnd((B, S, N), 113).mul(0.5).to(cuda, dt)
    Cm = rnd((B, S, N), 114).mul(0.5).to(cuda, dt)
    h0 = rnd((B, H, P, N), 115).mul(0.3).to(cuda) if with_h0 else None
    before = ssm_scan.launches
    y, h = ssm_chunk_scan(x, dts, A, Bm, Cm, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    want_y, want_h = ref.ssm_chunk_scan(x, dts, A, Bm, Cm, h0=h0)
    assert bool(torch.isfinite(y).all()) and y.dtype == dt
    bound = 2e-3 + (2.0 ** -7 * want_y.float().abs() if dtype == "bfloat16"
                    else 0.0)
    assert ((y.float() - want_y.float()).abs() <= bound).all()
    torch.testing.assert_close(h, want_h, rtol=2e-3, atol=2e-3)


def test_hybrid_engine_on_the_card_equals_serve_sequential(cuda):
    """zamba2 at the smoke size on the dense layout: every prefill runs the
    SSD kernel once per layer and flash attention once per shared-attention
    layer, and the engine's streams equal serve_sequential's."""
    cfg = smoke_config("zamba2-2.7b")
    params = api.init_params(cfg, 0, device=cuda)
    rng = np.random.default_rng(1)
    specs = [RequestSpec(tuple(rng.integers(0, cfg.vocab, int(n)).tolist()),
                         5) for n in rng.integers(1, 41, size=5)]
    engine = Engine(cfg, EngineConfig(slots=2, prompt_buckets=(16, 40),
                                      max_seq=48, kv_layout="dense"),
                    params=params, device=cuda)
    ssm_scan.launches = flash_attention.launches = 0
    flash_attention.launches_by_route = {"fma": 0, "mma": 0}
    reqs = engine.run(specs)
    prefills = engine.stats()["prefills"]
    assert ssm_scan.launches == prefills * cfg.n_layers
    assert flash_attention.launches == \
        prefills * (cfg.n_layers // cfg.hybrid_attn_period)
    # the smoke config computes in float32: the CUDA-core route
    assert flash_attention.launches_by_route == {
        "fma": flash_attention.launches, "mma": 0}
    got = [engine.finalize_request(r) for r in reqs]
    seq = serve_sequential(cfg, params, specs, max_seq=48,
                           prompt_buckets=(16, 40), device=cuda)
    assert got == [seq["tokens"][i + 1] for i in range(len(specs))]


def test_hybrid_prefill_beyond_the_window_runs_the_kernels(cuda):
    """A prompt longer than the attention window (64 at the smoke size): the
    shared attention still runs the flash kernel, with the window, and the
    prefill's logits and caches agree with the CPU's plain path within 1e-4
    (float32; the two SSD scans chunk and sum in different orders)."""
    cfg = smoke_config("zamba2-2.7b")
    assert cfg.attn_window == 64
    params = api.init_params(cfg, 0, device=cuda)

    def on_cpu(tree):
        return {k: on_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 160))).long()
    ssm_scan.launches = flash_attention.launches = 0
    logits, cache = api.prefill(cfg, params, {"tokens": toks.to(cuda)},
                                s_max=192)
    torch.cuda.synchronize()
    assert ssm_scan.launches == cfg.n_layers
    assert flash_attention.launches == \
        len(range(0, cfg.n_layers, cfg.hybrid_attn_period))
    want_logits, want_cache = api.prefill(cfg, on_cpu(params),
                                          {"tokens": toks}, s_max=192)
    torch.testing.assert_close(logits.cpu(), want_logits, rtol=1e-4,
                               atol=1e-4)
    for k in want_cache:
        torch.testing.assert_close(cache[k].cpu(), want_cache[k], rtol=1e-4,
                                   atol=1e-4)
