"""The routes of the port's flash-attention and matmul kernels, on the CPU.

* The bfloat16 flash-attention kernel (``csrc/flash_attention.cu``, route
  ``"mma"``) computes in tensor-core arithmetic: bf16 inputs, float32 scores,
  an online softmax over 64-key tiles, and P split into two bf16 terms
  (hi = bf16(p), lo = bf16(p - hi)) before P V. A torch emulation of that
  arithmetic is held here against the float32 plain version
  (``kernels.ref.flash_attention``) at the card's bf16 tolerance, one bf16
  ulp of the larger value; P rounded to bf16 once, as the TPU kernel does,
  is shown to leave outputs past it.
* ``matmul_route`` and ``flash_route`` decide, before any launch, which
  kernel a call takes; they are plain functions of shapes, dtypes and
  addresses, checked here over a table.
* Tensors on the CPU run the plain versions and count no launch on any
  route.

Run alone: ``PYTHONPATH=src python -m pytest tests/test_torch_kernel_routes.py
-q``; the emulation's counts at the zamba2 serving shape print with
``PYTHONPATH=src python tests/test_torch_kernel_routes.py``.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import matmul as tmm

torch.set_num_threads(1)
NEG = -1e30
TILE = 64                  # the kernel's q rows per block and keys per tile
BASE = 1 << 20                      # a 16-byte aligned address
# emulation cases: (B, S, H, hd), causal, window
EMULATION_CASES = [((1, 512, 4, 80), True, 0), ((1, 1024, 2, 80), True, 256)]
# (M, K, N, dtype, A's and B's byte offsets from an aligned address, route)
ROUTE_CASES = [
    (512, 384, 256, "bfloat16", 0, 0, "wgmma"),
    (128, 512, 128, "bfloat16", 0, 0, "wgmma"),
    (2048, 1024, 4096, "bfloat16", 0, 0, "wgmma"),
    (8192, 8192, 8192, "bfloat16", 0, 0, "wgmma"),
    (1000, 200, 1032, "bfloat16", 0, 0, "wgmma"),    # ragged: TMA zero-fills
    (1, 64, 64, "bfloat16", 0, 0, "wgmma"),
    (100, 72, 36, "bfloat16", 0, 0, "mma"),          # N % 8 != 0
    (64, 100, 128, "bfloat16", 0, 0, "mma"),         # K % 8 != 0
    (64, 128, 128, "bfloat16", 2, 0, "mma"),         # A a view 2 bytes in
    (64, 128, 128, "bfloat16", 0, 8, "mma"),         # B 8 bytes off 16
    (100, 72, 36, "float32", 0, 0, "fma"),
    (8192, 8192, 8192, "float32", 0, 0, "fma"),
]


def inputs(shape, seed):
    """q, k, v in bf16 from seeded numpy normals, scaled as chip_smoke.py's."""
    return [torch.from_numpy((np.random.default_rng(seed + i)
                              .standard_normal(shape) * 0.3)
                             .astype(np.float32)).to(torch.bfloat16)
            for i in range(3)]


def bf16_bound(want, got):
    """One bf16 ulp of the larger value (chip_smoke.py's ``bf16_bound``)."""
    return 2.0 ** -7 * torch.maximum(want.float().abs(), got.float().abs()) \
        + 1e-6


def emulate_mma_flash(q, k, v, *, causal=True, window=0, split=True):
    """The tensor-core kernel's arithmetic in torch: per 64-row q block, the
    kv tiles from the window's first to the diagonal's, scores in float32
    (log2 units), masks at NEG, an online softmax, l summing the unrounded
    p, and P V with p split into hi + lo (``split``) or rounded once."""
    B, S, H, hd = q.shape
    qf, kf, vf = (x.float().permute(0, 2, 1, 3).reshape(B * H, S, hd)
                  for x in (q, k, v))
    scale = math.log2(math.e) / math.sqrt(hd)
    out = torch.empty_like(qf)
    for q0 in range(0, S, TILE):
        rows = torch.arange(q0, min(q0 + TILE, S))
        n_tiles = int(rows[-1]) // TILE + 1 if causal else -(-S // TILE)
        first = max(0, q0 - window + 1) // TILE if window else 0
        m = torch.full((B * H, len(rows), 1), -math.inf)
        l = torch.zeros((B * H, len(rows), 1))
        acc = torch.zeros((B * H, len(rows), hd))
        for it in range(first, n_tiles):
            keys = torch.arange(it * TILE, min(it * TILE + TILE, S))
            s = qf[:, rows] @ kf[:, keys].transpose(1, 2) * scale
            mask = torch.zeros((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                mask |= keys[None, :] > rows[:, None]
            if window:
                mask |= keys[None, :] <= rows[:, None] - window
            s = torch.where(mask, NEG, s)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = p.bfloat16().float()
            pv = hi @ vf[:, keys]
            if split:
                pv = pv + (p - hi).bfloat16().float() @ vf[:, keys]
            acc = acc * alpha + pv
            m = m_new
        out[:, rows] = acc / l.clamp_min(1e-30)
    return out.reshape(B, H, S, hd).permute(0, 2, 1, 3).to(q.dtype)


def past_bound(shape, causal, window, split, seed=0):
    """(outputs past one bf16 ulp, their count, max abs error) of the
    emulation against the plain version."""
    q, k, v = inputs(shape, seed)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    got = emulate_mma_flash(q, k, v, causal=causal, window=window,
                            split=split)
    err = (got.float() - want.float()).abs()
    return int((err > bf16_bound(want, got)).sum()), err.numel(), \
        err.max().item()


@pytest.mark.parametrize("shape,causal,window", EMULATION_CASES)
def test_split_p_stays_within_one_bf16_ulp(shape, causal, window):
    bad, _, worst = past_bound(shape, causal, window, split=True)
    assert bad == 0, (bad, worst)


@pytest.mark.parametrize("shape,causal,window", EMULATION_CASES)
def test_p_rounded_once_leaves_outputs_past_one_ulp(shape, causal, window):
    """Why the kernel splits P: the TPU kernel's single rounding of p to
    bf16 does not meet the tolerance the card's checks hold."""
    bad, n, _ = past_bound(shape, causal, window, split=False)
    assert bad > n // 100


@pytest.mark.parametrize("M,K,N,dtype,a_off,b_off,route", ROUTE_CASES)
def test_matmul_route(M, K, N, dtype, a_off, b_off, route):
    assert tmm.matmul_route(M, N, K, getattr(torch, dtype), BASE + a_off,
                            BASE + b_off) == route


def test_matmul_route_reads_tensor_addresses():
    """A view that starts one element into its storage takes mma.sync."""
    a = torch.zeros(64 * 128 + 8, dtype=torch.bfloat16)
    b = torch.zeros((128, 64), dtype=torch.bfloat16)
    view = a[1:1 + 64 * 128].view(64, 128)
    for x, want in ((a[8:8 + 64 * 128].view(64, 128), "wgmma"),
                    (view, "mma")):
        assert (x.data_ptr() % 16 == 0) == (want == "wgmma")
        assert tmm.matmul_route(64, 64, 128, x.dtype, x.data_ptr(),
                                b.data_ptr()) == want
    with pytest.raises(ValueError, match="no kernel"):
        tmm.matmul_route(64, 64, 128, torch.float16, BASE, BASE)


@pytest.mark.parametrize("dtype,route", [("bfloat16", "mma"),
                                         ("float32", "fma"),
                                         ("float16", None)])
def test_flash_route_by_dtype(dtype, route):
    if route is None:
        with pytest.raises(ValueError, match="no kernel"):
            tfa.flash_route(getattr(torch, dtype))
    else:
        assert tfa.flash_route(getattr(torch, dtype)) == route


@pytest.mark.parametrize("kernel", ["flash_attention", "matmul"])
def test_cpu_tensors_count_no_launch_on_any_route(kernel):
    if kernel == "flash_attention":
        fn, codes = tfa.flash_attention, tfa.ROUTE_CODES
        args = inputs((1, 64, 2, 16), 3)
    else:
        fn, codes = tmm.matmul, tmm.ROUTE_CODES
        args = [torch.ones((16, 8), dtype=torch.bfloat16),
                torch.ones((8, 24), dtype=torch.bfloat16)]
    assert set(fn.launches_by_route) == set(codes)
    assert len(set(codes.values())) == len(codes)
    before, by_route = fn.launches, dict(fn.launches_by_route)
    fn(*args)
    assert fn.launches == before and fn.launches_by_route == by_route


if __name__ == "__main__":
    for shape, window in (((1, 512, 32, 80), 0), ((1, 1024, 8, 80), 256)):
        for split in (False, True):
            bad, n, worst = past_bound(shape, True, window, split)
            print(f"{list(shape)} causal window {window}: P "
                  f"{'split hi + lo' if split else 'rounded once'}: {bad} of "
                  f"{n} outputs past one bf16 ulp ({bad / n:.1%}), max abs "
                  f"err {worst:.3g}")
