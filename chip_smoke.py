#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py [--seed 0] [--requests 16] [--tokens 64]

Runs on one CUDA card, from the root of a checkout; it exits non-zero (and
prints no result) when there is no card or no ``src/repro_torch`` beside it.
In order:

1. builds every CUDA kernel of ``src/repro_torch/kernels/csrc`` (``nvcc``, one
   process per source, started together) and prints the build time;
2. holds each kernel against its plain PyTorch version on the card: the
   paged-attention kernel (split across the context in partitions of
   ``PARTITION`` positions, two passes per launch) at the shapes of the JAX
   package's kernel test and at a 4096-position table with a window that
   starts mid-partition (float32, tolerance 2e-5), and at full
   ``tinyllama-1.1b`` decode shapes (bfloat16), an all-masked row included;
3. serves full-width ``tinyllama-1.1b`` (22 layers, random weights from
   ``--seed``) through the port's ``Engine`` on the paged layout — 16 greedy
   requests, prompts of 100-500 tokens, 64 new tokens each — once with
   one-shot and once with chunked prefill, and runs the same requests through
   ``serve_sequential``. Checks: the kernel launched 22 times per decode step;
   engine streams equal ``serve_sequential``'s; the two prefill modes agree
   (a stream may leave the other only where the reference logits are a
   near-tie, see ``--tie-tol``); every emitted token is, within ``--tie-tol``,
   the argmax of a teacher-forced reference forward;
4. checks the threefry sampling noise on the card: the random bits and
   uniforms equal the CPU's, the Gumbel values within 2 ulp of
   ``max(|g|, 1)``;
5. drives the paper's UPIR kernel path for axpy, matvec, stencil2d and matmul:
   each call is written with the OpenMP, OpenACC and CUDA frontends, the three
   programs must be equal, the ``simd`` program lowers through
   ``kernels.ops.lower_kernel_program`` to the CUDA kernel (its launch count
   rises by one) and the ``worksharing`` program to the plain oracle, and the
   two outputs must agree: float32 axpy and stencil bit for bit, the rest
   within the tolerances of the JAX package's kernel test at its shapes and
   within ``kernels.ref.error_bound`` at full size (axpy n = 2^28, matvec
   32768^2, stencil 16384^2, matmul 8192^3 in bfloat16 and float32); the
   stencil also in bfloat16, bit for bit (both round after every op). The
   full-size bf16 matmul must take the ``wgmma`` route (TMA + wgmma); then
   bf16 products with ragged M, K and N on the ``wgmma`` route and
   (100, 72) @ (72, 36) on the ``mma`` route (N % 8 != 0), each within
   ``kernels.ref.error_bound`` and counted on its route;
6. holds the flash-attention and SSD chunk-scan kernels against their plain
   versions: flash attention at the JAX package's kernel-test shapes (float32,
   tolerance 2e-4) and at the zamba2 prefill shape [1, 512, 32, 80] in
   bfloat16, and with a sliding window shorter than S (float32, and bfloat16
   at [1, 1024, 32, 80], window 256), and in bfloat16 at a ragged S, hd 64
   and 128, non-causal and S = 4096 (tolerance one bf16 ulp); float32 calls
   must take the ``fma`` route and bfloat16 ones the ``mma`` route (tensor
   cores); the SSD scan at the kernel-test shapes and one shorter than a
   chunk (float32, 2e-3, with and without an initial state) and at the
   zamba2 shape [1, 512, 80, 64] with N = 64 in bfloat16, y and the final
   state against the sequential oracle; then both through the UPIR registry
   (``kernels.ops.resolve(..., "cuda")``), one launch each;
7. serves full-width ``zamba2-2.7b`` (54 Mamba2 layers and the shared
   attention block every 6th, d 2560, random weights from ``--seed``) through
   the port's ``Engine`` on the dense layout — 8 slots, ``HYBRID_REQUESTS``
   (16) greedy requests of 100-500 prompt tokens, ``HYBRID_TOKENS`` (32) new
   tokens each — and runs the same requests
   through ``serve_sequential``. Checks: exactly 54 SSD-scan and 9
   flash-attention launches per prefill, every flash launch on the ``mma``
   route; engine streams equal
   ``serve_sequential``'s; in float32, the decode step's logits (the plain
   recurrences) agree with a teacher-forced prefill's (the kernels) to 1e-3
   of their scale. Prints decode tokens/s, TTFT p50/p99 and ms per decode
   step;
8. times each kernel (paged attention at the serving shape, flash attention
   and the SSD scan at the zamba2 serving shape and at S = 4096, zamba2's
   window, the paper kernels at full size) beside its bound, its plain
   version and one library call where one exists (and the bf16 matmul's
   ``mma`` route beside its ``wgmma`` one, on the same inputs), and prints the
   ``kernels`` JSON line (all seven kernels, each with its ``kernel_route``),
   the card's name and power limit, and last the ``{"ok": true, ...}`` line.
   Paged attention is also timed at partitions of 32, 64 and 128 positions
   on the same inputs. The build's ptxas report must show no spills in the
   paged-attention and matmul kernels.

Any failed phase exits non-zero before the last line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # H100 SXM float32 on the CUDA cores, data sheet
SPIN_CYCLES = 5_000_000          # ~2.5 ms of GPU clock: longer than any enqueue


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi unavailable"


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def reset_counts(fns) -> None:
    """Every launch count of ``fns`` to 0, the per-route counts too."""
    for fn in fns:
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def time_cuda(fn, iters: int, flush=None) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, CUDA events around each
    call. ``flush`` (outside the timed window) evicts the L2 cache first. A
    spin kernel queued ahead of the start event keeps the card busy while
    the host enqueues ``fn``, so the window holds device time only, not the
    host's launch latency."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def ptxas_report(log: str):
    """(kernel, registers, spill bytes stored + loaded) of each entry
    function in an ``nvcc -Xptxas -v`` log; names demangled by the
    toolkit's ``cu++filt`` where it is there."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif "Used" in line and "registers" in line and name:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            rows.append([name, regs, spill])
            name, spill = None, 0
    filt = Path("/usr/local/cuda/bin/cu++filt")
    if rows and filt.exists():
        out = subprocess.run([str(filt)], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                n = re.sub(r"\((?:int|bool)\)|void |<unnamed>::", "", n)
                r[0] = n.split("(")[0]
    return rows


# ------------------------------------------------------------ kernel checks


def paged_inputs(torch, rng, B, ctx_max, H, KV, hd, ps, dtype, device):
    """Random pool + a permuted page table covering ``ctx_max`` positions."""
    P = -(-ctx_max // ps)
    NP = B * P + 1                           # + reserved null page 0
    k = torch.from_numpy(rng.standard_normal((NP, ps, KV, hd), "float32"))
    v = torch.from_numpy(rng.standard_normal((NP, ps, KV, hd), "float32"))
    q = torch.from_numpy(rng.standard_normal((B, 1, H, hd), "float32"))
    perm = rng.permutation(NP - 1)[:B * P] + 1
    pt = torch.from_numpy(perm.reshape(B, P).astype("int32"))
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            pt.to(device))


def kernel_checks(torch, np, seed, device):
    from repro_torch.kernels.paged_attention import (
        paged_attention_decode, paged_attention_partial,
        paged_attention_partial_ref)
    from repro_torch.models.layers import NEG, attention_decode_paged
    rng = np.random.default_rng(seed)
    worst = 0.0
    # (a) the JAX package's kernel-test shapes, float32, tolerance 2e-5
    for KV, window in ((4, 0), (2, 0), (2, 10)):
        q, k, v, pt = paged_inputs(torch, rng, 3, 32, 4, KV, 16, 8,
                                   torch.float32, device)
        pos = torch.tensor([0, 13, 31], device=device)
        new_kv = tuple(torch.from_numpy(
            rng.standard_normal((3, 1, KV, 16), "float32")).to(device)
            for _ in range(2))
        for nkv in (None, new_kv):
            limit = (pos if nkv is not None else pos + 1).to(torch.int32)
            got = paged_attention_partial(q, k, v, pt, limit, window=window)
            want = paged_attention_partial_ref(q, k, v, pt, limit,
                                               window=window)
            for g, w in zip(got, want):
                check(not torch.isnan(g).any().item(), "NaN in kernel output")
                err = (g - w).abs().max().item()
                worst = max(worst, err)
                check(torch.allclose(g, w, rtol=2e-5, atol=2e-5),
                      f"kernel vs plain (KV={KV}, window={window}): {err}")
            d = paged_attention_decode(q, k, v, pt, pos, window=window,
                                       new_kv=nkv)
            r = attention_decode_paged(q, k, v, pt, pos, window=window,
                                       new_kv=nkv)
            check(torch.allclose(d, r, rtol=2e-5, atol=2e-5),
                  f"decode vs gather path (KV={KV}, window={window})")
        # limit 0 in row 0 (pos 0 with new_kv): all masked -> zeros, m=NEG, l=0
        o, m, l = paged_attention_partial(q, k, v, pt, pos.to(torch.int32),
                                          window=window)
        check(bool((o[0] == 0).all()) and bool((m[0] == NEG).all())
              and bool((l[0] == 0).all()), "all-masked row is not zero")
    # a 4096-position table: many partitions, the window starting
    # mid-partition, float32, tolerance 2e-5
    q, k, v, pt = paged_inputs(torch, rng, 4, 4096, 32, 4, 64, 16,
                               torch.float32, device)
    limit = torch.tensor([0, 1000, 2049, 4096], dtype=torch.int32,
                         device=device)
    for window in (0, 1000):
        got = paged_attention_partial(q, k, v, pt, limit, window=window)
        want = paged_attention_partial_ref(q, k, v, pt, limit, window=window)
        # the max error printed counts out only: l sums up to 4096 terms and
        # is held to the relative tolerance
        worst = max(worst, (got[0] - want[0]).abs().max().item())
        for g, w in zip(got, want):
            check(torch.allclose(g, w, rtol=2e-5, atol=2e-5),
                  f"kernel vs plain at 4096 positions (window={window}): "
                  f"{(g - w).abs().max().item()}")
    torch.cuda.synchronize()
    # (b) full tinyllama decode shapes, bfloat16: both versions accumulate in
    # float32 from the same bf16 inputs and round the output to bf16, so a
    # 1e-6 difference in float32 can move it by one bf16 ulp (2^-7 for
    # |x| < 2): tolerance 1.6e-2 absolute on out; m and l stay float32 and
    # differ only by summation order (1e-4 relative)
    B, H, KV, hd, ps = 8, 32, 4, 64, 16
    q, k, v, pt = paged_inputs(torch, rng, B, 1024, H, KV, hd, ps,
                               torch.bfloat16, device)
    ctx = rng.integers(1, 1025, size=B)
    ctx[0] = 0                                   # all-masked row
    ctx[1], ctx[2] = 1, 1024
    limit = torch.tensor(ctx, dtype=torch.int32, device=device)
    got = paged_attention_partial(q, k, v, pt, limit)
    want = paged_attention_partial_ref(q, k, v, pt, limit)
    torch.cuda.synchronize()
    check(not any(torch.isnan(g).any().item() for g in got), "NaN (bf16)")
    err = (got[0].float() - want[0].float()).abs().max().item()
    check(err <= 1.6e-2, f"bf16 kernel vs plain out: {err}")
    for g, w in zip(got[1:], want[1:]):
        check(torch.allclose(g, w, rtol=1e-4, atol=1e-4), "bf16 m/l")
    check(bool((got[0][0] == 0).all()), "bf16 all-masked row is not zero")
    return worst, err


# ------------------------------------------------------------- serving


def teacher_logits(torch, api, cfg, params, prompt_padded, generated, device):
    """Reference logits after ``prompt_padded + generated`` (a B=1 one-shot
    forward through the plain prefill path)."""
    seq = list(prompt_padded) + list(generated)
    toks = torch.tensor([seq], dtype=torch.int64, device=device)
    logits, _ = api.prefill(cfg, params, {"tokens": toks})
    return logits[0, -1].float()


def serve(torch, np, args, device, cfg=None, buckets=(128, 256, 512),
          prompt_lens=(100, 500), chunk=128, max_seq=1024, page_size=16):
    from repro_torch.configs import config
    from repro_torch.kernels.paged_attention import paged_attention_partial
    from repro_torch.models import api
    from repro_torch.models.transformer import compute_params
    from repro_torch.runtime.engine import (Engine, EngineConfig, RequestSpec,
                                            serve_sequential)
    cfg = cfg or config("tinyllama-1.1b")
    rng = np.random.default_rng(args.seed)
    params = api.init_params(cfg, args.seed, device=device)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1, size=args.requests)
    specs = [RequestSpec(tuple(int(t) for t in rng.integers(0, cfg.vocab, n)),
                         args.tokens) for n in lens]

    def engine(prefill_chunk):
        return Engine(cfg, EngineConfig(
            kv_layout="paged", page_size=page_size, slots=8, max_seq=max_seq,
            prompt_buckets=buckets, prefill_chunk=prefill_chunk),
            params=params, device=device)

    out = {}
    for name, c in (("oneshot", 0), ("chunked", chunk)):
        eng = engine(c)
        # warm cuBLAS / allocator outside the measured run
        eng.run([RequestSpec((1,) * b, 2) for b in buckets])
        eng.reset_stats()
        paged_attention_partial.launches = 0
        reqs = eng.run(specs)
        launches = paged_attention_partial.launches
        st = eng.stats()
        streams = [eng.finalize_request(r) for r in reqs]
        check(all(r.state == "done" for r in reqs), f"{name}: not all done")
        check(st["decode_steps"] > 0 and launches > 0,
              f"{name}: the paged-attention kernel never launched")
        check(launches == st["decode_steps"] * cfg.n_layers,
              f"{name}: {launches} launches != {st['decode_steps']} decode "
              f"steps x {cfg.n_layers} layers")
        check(all(len(s) == args.tokens for s in streams),
              f"{name}: stream lengths")
        out[name] = dict(streams=streams, launches=launches,
                         steps=st["decode_steps"],
                         tokens_per_s=st["tokens_per_s"],
                         prefill_chunks=st["prefill_chunks"])
        print(f"serve[{name}]: decode_steps={st['decode_steps']} "
              f"kernel_launches={launches} prefill_chunks="
              f"{st['prefill_chunks']} tokens/s={st['tokens_per_s']:.1f} "
              f"occupancy={st['batch_occupancy']:.2f}", flush=True)
        del eng
    # latency mode: TTFT stamped when the first token exists
    eng = engine(0)
    eng.run([RequestSpec((1,) * b, 2) for b in buckets])
    eng.reset_stats()
    reqs = eng.run(specs, sync_per_step=True)
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    out["ttft_ms"] = (float(np.percentile(ttft, 50)),
                      float(np.percentile(ttft, 99)))
    out["latency_tokens_per_s"] = eng.stats()["tokens_per_s"]
    check([eng.finalize_request(r) for r in reqs] == out["oneshot"]["streams"],
          "latency-mode streams differ from the throughput run")
    del eng
    seq = serve_sequential(cfg, params, specs, max_seq=max_seq,
                           prompt_buckets=buckets, page_size=page_size,
                           device=device)
    seq_streams = [seq["tokens"][i + 1] for i in range(len(specs))]
    out["sequential_tokens_per_s"] = seq["tokens_per_s"]

    # correctness against the plain reference forward (teacher-forced)
    cparams = compute_params(cfg, params, torch.device(device))
    padded = []
    for s in specs:
        b = next(b for b in buckets if b >= len(s.prompt))
        padded.append(list(s.prompt) + [0] * (b - len(s.prompt)))

    def near_tie(i, prefix, a, b):
        lg = teacher_logits(torch, api, cfg, cparams, padded[i], prefix,
                            device)
        top = lg.max().item()
        return top - lg[a].item() <= args.tie_tol and \
            top - lg[b].item() <= args.tie_tol

    def compare(xs, ys, what):
        same = 0
        for i, (x, y) in enumerate(zip(xs, ys)):
            j = next((j for j, (a, b) in enumerate(zip(x, y)) if a != b),
                     None)
            if j is None:
                same += 1
                continue
            check(near_tie(i, x[:j], x[j], y[j]),
                  f"{what}: request {i} leaves at token {j} ({x[j]} vs "
                  f"{y[j]}) where the reference logits are no near-tie")
        print(f"check: {what}: {same}/{len(xs)} streams identical, the "
              f"rest leave only at reference near-ties", flush=True)
        return same

    one, chk = out["oneshot"]["streams"], out["chunked"]["streams"]
    check(one == seq_streams, "engine streams != serve_sequential streams")
    print(f"check: engine == serve_sequential: {len(one)}/{len(one)} streams "
          f"identical", flush=True)
    out["chunked_same"] = compare(one, chk, "chunked vs one-shot prefill")
    # every emitted token is a near-argmax of the teacher-forced reference
    worst = 0.0
    for i in range(0, len(specs), max(len(specs) // 4, 1)):
        for j in range(0, args.tokens, 16):
            lg = teacher_logits(torch, api, cfg, cparams, padded[i],
                                one[i][:j], device)
            gap = lg.max().item() - lg[one[i][j]].item()
            check(math.isfinite(gap), "non-finite reference logits")
            worst = max(worst, gap)
    check(worst <= args.tie_tol, f"emitted token {worst} below the "
          f"reference argmax (> {args.tie_tol})")
    print(f"check: teacher-forced reference: worst top-1 gap of an emitted "
          f"token {worst:.4f} (<= {args.tie_tol})", flush=True)
    out["serve_limits"] = [
        next(b for b in buckets if b >= len(s.prompt)) + args.tokens // 2
        for s in specs[:8]]
    return out


# ------------------------------------------------------ threefry on the card


def threefry_check(torch, np, device):
    """The sampler's threefry noise on the card equals the CPU's: the bits
    and the uniforms exactly, the Gumbel values within 2 ulp of
    ``max(|g|, 1)`` (each side's ``log`` rounds on its own)."""
    from repro_torch.runtime import prng
    from repro_torch.runtime.sampling import (SamplingParams, gumbel_noise,
                                              request_key)
    keys = np.stack([request_key(SamplingParams(seed=s), rid)
                     for s, rid in ((0, 1), (7, 2), (123, 999), (5, 40))])
    pos = np.array([0, 130, 4095, 611])
    V = 32000
    out = {}
    for dev in ("cpu", device):
        k = prng.fold_in(torch.from_numpy(keys.astype(np.int64)).to(dev),
                         torch.from_numpy(pos).to(dev))
        out[dev] = (prng.random_bits(k, V).cpu(), prng.uniform(k, V).cpu(),
                    gumbel_noise(keys, pos, V, dev).cpu().numpy())
    (b0, u0, g0), (b1, u1, g1) = out["cpu"], out[device]
    check(torch.equal(b0, b1), "threefry bits on the card != the CPU's")
    check(torch.equal(u0, u1), "uniforms on the card != the CPU's")
    spacing = np.spacing(np.maximum(np.abs(g0), 1).astype(np.float32))
    ulps = float((np.abs(g1.astype(np.float64) - g0) / spacing).max())
    check(np.isfinite(g1).all() and ulps <= 2,
          f"gumbel on the card {ulps} ulp from the CPU's (> 2)")
    return ulps, float((g0 != g1).mean())


# ------------------------------------------------------- the UPIR kernel path

# tests/test_kernels.py's tolerances, at its shapes
TEST_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
            "bfloat16": dict(rtol=2e-1, atol=2e-1)}
# (kernel, dtype, operand shapes, the TPU tiles, input scale):
# tests/test_kernels.py's shapes and dtypes ...
PAPER_TEST_CASES = [
    *[("axpy", dt, [(n,), (n,)], dict(block=b), 1.0)
      for n, b in ((512, 128), (4096, 1024), (2048, 2048))
      for dt in ("float32", "bfloat16")],
    *[("matmul", dt, [(m, k), (k, n)], dict(bm=bm, bn=bn, bk=bk), 0.3)
      for m, k, n, bm, bn, bk in ((256, 256, 256, 128, 128, 128),
                                  (512, 384, 256, 128, 128, 128),
                                  (128, 512, 128, 128, 128, 256))
      for dt in ("float32", "bfloat16")],
    *[("matvec", "float32", [(m, k), (k,)], dict(bm=256, bk=256), 1.0)
      for m, k in ((512, 512), (1024, 256))],
    *[("stencil2d", "float32", [(m, n)], dict(bm=bm, bn=bn), 1.0)
      for m, n, bm, bn in ((256, 256, 128, 128), (128, 384, 64, 128))],
    ("stencil2d", "bfloat16", [(256, 256)], dict(bm=128, bn=128), 1.0),
]
# ... and full size, at which the card does real work
PAPER_FULL_CASES = [
    ("axpy", "float32", [(1 << 28,), (1 << 28,)], {}, 1.0),
    ("matvec", "float32", [(32768, 32768), (32768,)], {}, 1.0),
    ("stencil2d", "float32", [(16384, 16384)], {}, 1.0),
    ("matmul", "bfloat16", [(8192, 8192), (8192, 8192)], {}, 1.0),
    ("matmul", "float32", [(8192, 8192), (8192, 8192)], {}, 1.0),
]
AXPY_A = 2.5


def paper_operands(torch, kernel, dtype, shapes, scale, seed, device):
    """Operands made on the card from a seeded generator (full-size inputs
    are GBs: nothing is made on the host)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    args = [(torch.randn(s, generator=gen, device=device) * scale).to(
        getattr(torch, dtype)) for s in shapes]
    return [AXPY_A] + args if kernel == "axpy" else args


def upir_case(torch, kernel, dtype, shapes, tiles, scale, seed, device,
              full):
    """One kernel call through the UPIR path; returns the max abs error of
    the simd (kernel) output against the worksharing (oracle) output."""
    from repro_torch.core import printer
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.programs import frontend_programs, symbols_of
    args = paper_operands(torch, kernel, dtype, shapes, scale, seed, device)
    extent = args[1].shape[0] if kernel == "axpy" else args[0].shape[0]
    syms = symbols_of(kernel, args)
    progs = {simd: frontend_programs(kernel, syms, extent, simd=simd)
             for simd in (True, False)}
    for simd, p in progs.items():
        check(p["omp"] == p["acc"] == p["cuda"],
              f"{kernel}: the OpenMP, OpenACC and CUDA programs differ "
              f"({'simd' if simd else 'worksharing'})")
    fps = [printer.program_fingerprint(progs[s]["cuda"]) for s in (True,
                                                                    False)]
    fn = ops.lower_kernel_program(progs[True]["cuda"])
    oracle = ops.lower_kernel_program(progs[False]["omp"])
    check(fn is ops.SIMD[kernel] and oracle is ops.REFERENCE[kernel],
          f"{kernel}: simd must lower to cuda, worksharing to reference")
    before = fn.launches
    route = "cuda_cores"
    if kernel == "matmul":
        from repro_torch.kernels.matmul import matmul_route
        (M, K), (_, N) = shapes
        route = matmul_route(M, N, K, args[0].dtype, args[0].data_ptr(),
                             args[1].data_ptr())
        on_route = fn.launches_by_route[route]
    got = fn(*args, **tiles)
    torch.cuda.synchronize()
    check(fn.launches == before + 1,
          f"{kernel}: the simd program did not launch the CUDA kernel")
    if kernel == "matmul":
        check(fn.launches_by_route[route] == on_route + 1,
              f"{kernel}: no launch counted on the {route} route")
    want = oracle(*args)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{kernel}: shape/dtype {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"{kernel}: non-finite output")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    shape = "x".join(map(str, shapes[0]))
    what = f"{kernel} {dtype} {shape}"
    if kernel == "stencil2d" or (kernel == "axpy" and dtype == "float32"):
        check(torch.equal(got, want), f"{what}: not bitwise equal to the "
              f"worksharing (plain) output, max err {err}")
        rule = "bitwise"
    elif full:
        bound = ref.error_bound(kernel, args, want)
        check(bool((diff <= bound).all()),
              f"{what}: max err {err} beyond kernels.ref.error_bound")
        rule = "within kernels.ref.error_bound"
    else:
        check(torch.allclose(got.float(), want.float(), **TEST_TOL[dtype]),
              f"{what}: max err {err} beyond {TEST_TOL[dtype]}")
        rule = f"within {TEST_TOL[dtype]}"
    print(f"upir[{what}]: omp == acc == cuda (simd {fps[0]}, worksharing "
          f"{fps[1]}); simd -> CUDA kernel ({route}), worksharing -> plain; "
          f"max |simd - worksharing| {err:.3g} ({rule})", flush=True)
    return err, route


def upir_phase(torch, seed, device):
    """The paper's kernel path at the test shapes, then at full size; every
    tensor of one case is freed before the next. Returns the full-size max
    errors by (kernel, dtype)."""
    for i, (kernel, dtype, shapes, tiles, scale) in enumerate(
            PAPER_TEST_CASES):
        upir_case(torch, kernel, dtype, shapes, tiles, scale, seed + i,
                  device, full=False)
    errs = {}
    for i, (kernel, dtype, shapes, tiles, scale) in enumerate(
            PAPER_FULL_CASES):
        errs[kernel, dtype], route = upir_case(
            torch, kernel, dtype, shapes, tiles, scale, seed + 100 + i,
            device, full=True)
        if (kernel, dtype) == ("matmul", "bfloat16"):
            check(route == "wgmma", f"full-size bf16 matmul took the {route} "
                  f"route, not wgmma")
        torch.cuda.empty_cache()
    return errs


# bf16 products whose route is checked: (M, K, N, route); ragged M, K and N
# on the wgmma route (TMA zero-fills the edges), N % 8 != 0 on mma.sync
MATMUL_ROUTE_CASES = [(1000, 200, 1032, "wgmma"), (100, 72, 36, "mma")]


def matmul_route_checks(torch, seed, device):
    """Each bf16 case takes its route, counts one launch there and agrees
    with the plain version within ``kernels.ref.error_bound``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul, matmul_route
    for i, (M, K, N, route) in enumerate(MATMUL_ROUTE_CASES):
        a, b = paper_operands(torch, "matmul", "bfloat16", [(M, K), (K, N)],
                              1.0, seed + 300 + i, device)
        got_route = matmul_route(M, N, K, a.dtype, a.data_ptr(),
                                 b.data_ptr())
        check(got_route == route, f"matmul {M}x{K}x{N}: route {got_route}, "
              f"not {route}")
        counts = dict(matmul.launches_by_route)
        got = matmul(a, b, bm=M, bn=N, bk=K)
        torch.cuda.synchronize()
        counts[route] += 1
        check(matmul.launches_by_route == counts,
              f"matmul {M}x{K}x{N}: counts {matmul.launches_by_route}, "
              f"want {counts}")
        want = ref.matmul(a, b)
        diff = (got.float() - want.float()).abs()
        check(bool(torch.isfinite(got).all()) and bool(
            (diff <= ref.error_bound("matmul", [a, b], want)).all()),
            f"matmul bf16 {M}x{K}x{N} ({route}): max err {diff.max().item()}"
            f" beyond kernels.ref.error_bound")
        print(f"matmul[bfloat16 ({M}, {K}) @ ({K}, {N})]: route {route}; max "
              f"err {diff.max().item():.3g} (within kernels.ref.error_bound)",
              flush=True)


# ----------------------------------------------------------------- timing


def time_kernels(torch, np, seed, limits, launches, device):
    """The paged-attention kernel at the serving decode shape (one layer of
    one step: 8 rows, tinyllama heads, the run's mid-stream contexts)."""
    from repro_torch.kernels import paged_attention as tpa
    from repro_torch.kernels.paged_attention import (
        paged_attention_partial, paged_attention_partial_ref)
    import torch.nn.functional as F
    from repro_torch.models.layers import gather_kv_pages
    rng = np.random.default_rng(seed + 1)
    B, H, KV, hd, ps = 8, 32, 4, 64, 16
    q, k, v, pt = paged_inputs(torch, rng, B, 1024, H, KV, hd, ps,
                               torch.bfloat16, device)
    limit = torch.tensor(limits, dtype=torch.int32, device=device)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def flush():
        scratch.zero_()                     # 256 MB > the 50 MB L2

    saved = paged_attention_partial.launches
    ms = time_cuda(lambda: paged_attention_partial(q, k, v, pt, limit), 50,
                   flush)
    plain_ms = time_cuda(lambda: paged_attention_partial_ref(
        q, k, v, pt, limit), 50, flush)
    # the same inputs at other partition sizes (the wrapper reads the
    # module's PARTITION at each call)
    part = tpa.PARTITION
    by_partition = {}
    for size in (32, 64, 128):
        tpa.PARTITION = size
        by_partition[size] = time_cuda(
            lambda: paged_attention_partial(q, k, v, pt, limit), 50, flush)
    tpa.PARTITION = part
    paged_attention_partial.launches = saved   # timing launches do not count
    # yardstick: one SDPA call on the already-gathered K/V with the same mask
    S = pt.shape[1] * ps
    G = H // KV

    def heads(pages):                                    # [B, H, S, hd]
        g = gather_kv_pages(pages, pt).permute(0, 2, 1, 3)
        return g.repeat_interleave(G, dim=1).contiguous()

    kg, vg = heads(k), heads(v)
    qs = q.permute(0, 2, 1, 3).contiguous()              # [B, H, 1, hd]
    mask = (torch.arange(S, device=device)[None, :] < limit[:, None].long())
    mask = mask[:, None, None, :]
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask), 50, flush)
    out_k = paged_attention_partial(q, k, v, pt, limit)[0].float()
    paged_attention_partial.launches = saved
    out_p = paged_attention_partial_ref(q, k, v, pt, limit)[0].float()
    err = (out_k - out_p).abs().max().item()
    ctx = int(sum(limits))
    n_bytes = (2 * ctx * KV * hd * 2          # K and V rows attended (bf16)
               + 2 * B * H * hd * 2           # q read, out written (bf16)
               + 2 * B * H * 4                # m, l written (f32)
               + pt.numel() * 4 + B * 4)      # page table, limits
    flops = 4 * ctx * H * hd                  # q.k and p.v, 2 flops per MAC
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    splits = tpa.partition_count(pt.shape[1], ps)
    print(f"paged attention at the serving shape: partitions of {part} "
          f"positions, {splits} splits for a {pt.shape[1] * ps}-position "
          f"table; ms by partition size " + ", ".join(
              f"{size}: {t:.4f}" for size, t in by_partition.items()),
          flush=True)
    return [{
        "name": "paged_attention_partial", "route": "cuda",
        "kernel_route": "split", "partition": part, "splits": splits,
        "ms_by_partition": by_partition,
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:82",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms}]


def paper_work(kernel, dtype, shapes):
    """(bytes, operations) the function must move and do: each input read
    once, the output written once; 2 flops per multiply-add."""
    size = 2 if dtype == "bfloat16" else 4
    if kernel == "axpy":
        (n,), _ = shapes
        return 3 * n * size, 2 * n
    if kernel == "matvec":
        (m, k), _ = shapes
        return (m * k + k + m) * size, 2 * m * k
    if kernel == "stencil2d":
        (m, n), = shapes
        return 2 * m * n * size, 6 * m * n
    (m, k), (_, n) = shapes
    return (m * k + k * n + m * n) * size, 2 * m * n * k


def time_paper_kernels(torch, seed, errs, launches, device):
    """Each paper kernel at full size: its time, the plain version's, one
    library call's (TF32 off), and its bound. Timing launches do not
    count."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def flush():
        scratch.zero_()                     # 256 MB > the 50 MB L2

    def library(kernel, args):
        if kernel == "axpy":
            return lambda: torch.add(args[2], args[1], alpha=args[0])
        if kernel == "matvec":
            return lambda: torch.mv(*args)
        if kernel == "matmul":
            return lambda: torch.matmul(*args)
        cross = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0],
                              [0.0, 1.0, 0.0]], device=device)[None, None]
        u = args[0][None, None]
        return lambda: F.conv2d(u, cross, padding=1)

    rows = {}
    for i, (kernel, dtype, shapes, _, scale) in enumerate(PAPER_FULL_CASES):
        args = paper_operands(torch, kernel, dtype, shapes, scale,
                              seed + 200 + i, device)
        fn, plain = ops.SIMD[kernel], ops.REFERENCE[kernel]
        saved = fn.launches, dict(getattr(fn, "launches_by_route", {}))
        ms_big = {"matmul": 5 if dtype == "float32" else 10}.get(kernel, 20)
        ms = time_cuda(lambda: fn(*args), ms_big, flush)
        plain_ms = time_cuda(lambda: plain(*args), ms_big, flush)
        library_ms = time_cuda(library(kernel, args), ms_big, flush)
        fn.launches = saved[0]
        if saved[1]:
            fn.launches_by_route = saved[1]
        route = "cuda_cores"
        if kernel == "matmul":
            from repro_torch.kernels.matmul import matmul_route
            (M, K), (_, N) = shapes
            route = matmul_route(M, N, K, args[0].dtype, args[0].data_ptr(),
                                 args[1].data_ptr())
        n_bytes, ops_n = paper_work(kernel, dtype, shapes)
        peak = BF16_FLOPS if dtype == "bfloat16" else FP32_FLOPS
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_n / peak * 1e3
        rows[kernel, dtype] = {
            "name": kernel, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{kernel}.cu",
            "replaces": PAPER_REPLACES[kernel],
            "launches": launches[kernel], "max_abs_err": errs[kernel, dtype],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "dtype": dtype,
            "shape": [list(s) for s in shapes], "kernel_route": route}
        extra = ""
        if route == "wgmma":
            rows[kernel, dtype]["mma_ms"] = mma_ms = time_mma_route(
                torch, args, flush, ms_big, device)
            extra = f", the mma route on the same inputs {mma_ms:.4f}"
        print(f"kernel {kernel} {dtype} {shapes} ({route}): {ms:.4f} ms "
              f"(plain {plain_ms:.4f}, library {library_ms:.4f}, bound "
              f"{rows[kernel, dtype]['bound_ms']:.4f} by "
              f"{rows[kernel, dtype]['bound_by']}{extra})", flush=True)
        del args
        torch.cuda.empty_cache()
    # one entry per kernel: matmul's is bfloat16, with float32 beside it
    out = [rows["axpy", "float32"], rows["matvec", "float32"],
           rows["stencil2d", "float32"], rows["matmul", "bfloat16"]]
    out[-1]["float32"] = {k: rows["matmul", "float32"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "shape", "kernel_route")}
    return out


def time_mma_route(torch, args, flush, iters, device):
    """The bf16 matmul's mma.sync kernel timed on the inputs the wgmma
    route took (the launcher runs any route whose preconditions hold; the
    wrapper would pick wgmma), after checking its output within
    ``kernels.ref.error_bound``. Not a launch of the main path: nothing is
    counted."""
    from repro_torch.kernels import _cuda, ref
    from repro_torch.kernels.matmul import ROUTE_CODES, launcher
    a, b = args
    (M, K), (_, N) = a.shape, b.shape
    out = torch.empty((M, N), dtype=a.dtype, device=device)
    fn = launcher()

    def call():
        _cuda.launch("matmul", fn, a.device, a.data_ptr(), b.data_ptr(),
                     out.data_ptr(), M, N, K, _cuda.DTYPE_CODES[a.dtype],
                     ROUTE_CODES["mma"])

    call()
    want = ref.matmul(a, b)
    check(bool(((out.float() - want.float()).abs()
                <= ref.error_bound("matmul", args, want)).all()),
          "matmul bf16 on the mma route beyond kernels.ref.error_bound")
    del want
    return time_cuda(call, iters, flush)


# ------------------------------------------- flash attention and the SSD scan

# tests/test_kernels.py's shape sets: flash (B, S, H, hd, bq, bk), SSD
# (B, S, H, P, N, chunk); the SSD set adds a scan shorter than one chunk
FLASH_TEST_SHAPES = [(2, 256, 4, 64, 64, 64), (1, 512, 2, 32, 128, 256)]
SSD_TEST_SHAPES = [(2, 256, 4, 16, 8, 64), (1, 128, 2, 32, 16, 32),
                   (1, 48, 2, 16, 8, 64)]
# zamba2-2.7b's shapes on the serving path: the shared attention's prefill
# (32 heads of 80, no GQA) and the Mamba2 scan (80 heads of 64, N = 64)
FLASH_SERVE = (1, 512, 32, 80)
SSD_SERVE = (1, 512, 80, 64, 64)
LONG_S = 4096                                 # zamba2's attention window
# flash with a window shorter than S: (B, S, H, hd, window, dtype)
FLASH_WINDOW = [(1, 512, 4, 80, 128, "float32"),
                (2, 300, 2, 64, 100, "float32"),
                (1, 1024, 32, 80, 256, "bfloat16")]
# bf16 flash on the tensor-core route: (B, S, H, hd, causal): a ragged S,
# hd 64 and 128, non-causal, and S = 4096 at the serving width
FLASH_BF16 = [(1, 100, 3, 80, True), (2, 256, 4, 64, True),
              (1, 300, 2, 128, True), (1, 512, 32, 80, False),
              (1, LONG_S, 32, 80, True)]
# the zamba2 serving phase: requests and new tokens per request
HYBRID_REQUESTS = 16
HYBRID_TOKENS = 32


def bf16_bound(torch, want, got):
    """Both versions sum in float32 from the same bfloat16 inputs and round
    the output once: one bf16 ulp of the larger, 2^-7 |x|."""
    return 2.0 ** -7 * torch.maximum(want.float().abs(), got.float().abs()) \
        + 1e-6


def flash_operands(torch, shape, dtype, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(shape, generator=gen, device=device) * 0.3).to(dtype)
            for _ in range(3)]


def ssd_operands(torch, shape, dtype, seed, device, h0=False):
    B, S, H, P, N = shape
    gen = torch.Generator(device=device).manual_seed(seed)

    def rn(*s):
        return torch.randn(s, generator=gen, device=device)

    x = (rn(B, S, H, P) * 0.5).to(dtype)
    dt = torch.nn.functional.softplus(rn(B, S, H))
    A = -torch.exp(torch.rand(H, generator=gen, device=device))
    Bm, Cm = (rn(B, S, N) * 0.5).to(dtype), (rn(B, S, N) * 0.5).to(dtype)
    state = rn(B, H, P, N) * 0.3 if h0 else None
    return x, dt, A, Bm, Cm, state


def flash_ssm_checks(torch, seed, device):
    """Both new kernels against their plain versions; returns the max abs
    errors (float32 test shapes, bf16 serving shape) of each."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_chunk_scan
    errs = {}
    worst = 0.0
    counts = dict(flash_attention.launches_by_route)
    for i, (B, S, H, hd, bq, bk) in enumerate(FLASH_TEST_SHAPES):
        for causal in (True, False):
            q, k, v = flash_operands(torch, (B, S, H, hd), torch.float32,
                                     seed + i, device)
            got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
            want = ref.flash_attention(q, k, v, causal=causal)
            err = (got - want).abs().max().item()
            check(torch.allclose(got, want, rtol=2e-4, atol=2e-4),
                  f"flash {B}x{S}x{H}x{hd} causal={causal}: max err {err}")
            worst = max(worst, err)
    q, k, v = flash_operands(torch, FLASH_SERVE, torch.bfloat16, seed + 9,
                             device)
    got = flash_attention(q, k, v, causal=True)
    want = ref.flash_attention(q, k, v, causal=True)
    diff = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all()) and bool(
        (diff <= bf16_bound(torch, want, got)).all()),
        f"flash bf16 {FLASH_SERVE}: max err {diff.max().item()}")
    errs["flash_attention"] = (worst, diff.max().item())
    win = []
    for i, (B, S, H, hd, window, dtype) in enumerate(FLASH_WINDOW):
        q, k, v = flash_operands(torch, (B, S, H, hd), getattr(torch, dtype),
                                 seed + 10 + i, device)
        got = flash_attention(q, k, v, causal=True, bq=S, bk=S,
                              window=window)
        want = ref.flash_attention(q, k, v, causal=True, window=window)
        err = (got.float() - want.float()).abs()
        tol = 2e-4 if dtype == "float32" else bf16_bound(torch, want, got)
        check(bool(torch.isfinite(got).all()) and bool((err <= tol).all()),
              f"flash {dtype} {B}x{S}x{H}x{hd} window {window}: max err "
              f"{err.max().item()}")
        win.append(f"{dtype} S {S} window {window}: {err.max().item():.3g}")
    edges = []
    for i, (B, S, H, hd, causal) in enumerate(FLASH_BF16):
        q, k, v = flash_operands(torch, (B, S, H, hd), torch.bfloat16,
                                 seed + 30 + i, device)
        got = flash_attention(q, k, v, causal=causal, bq=S, bk=S)
        want = ref.flash_attention(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs()
        check(bool(torch.isfinite(got).all()) and bool(
            (err <= bf16_bound(torch, want, got)).all()),
            f"flash bf16 {B}x{S}x{H}x{hd} causal={causal}: max err "
            f"{err.max().item()}")
        edges.append(f"{B}x{S}x{H}x{hd}{'' if causal else ' non-causal'} "
                     f"{err.max().item():.3g}")
        del q, k, v, got, want, err
    torch.cuda.synchronize()
    n_win32 = sum(w[-1] == "float32" for w in FLASH_WINDOW)
    counts["fma"] += 2 * len(FLASH_TEST_SHAPES) + n_win32
    counts["mma"] += 1 + len(FLASH_WINDOW) - n_win32 + len(FLASH_BF16)
    check(flash_attention.launches_by_route == counts,
          f"flash routes {flash_attention.launches_by_route}, want {counts}: "
          f"float32 takes fma, bfloat16 mma")
    print(f"flash_attention vs plain: float32 test shapes max err {worst:.3g}"
          f" (tol 2e-4), bf16 {list(FLASH_SERVE)} causal max err "
          f"{diff.max().item():.3g} (tol 2^-7 |x|); windowed {'; '.join(win)}"
          f"; bf16 (same tol) {'; '.join(edges)}; launches by route "
          f"{flash_attention.launches_by_route}", flush=True)

    worst = worst_h = 0.0
    for i, (B, S, H, P, N, chunk) in enumerate(SSD_TEST_SHAPES):
        for h0 in (False, True):
            x, dt, A, Bm, Cm, st = ssd_operands(torch, (B, S, H, P, N),
                                                torch.float32, seed + 20 + i,
                                                device, h0)
            y, h = ssm_chunk_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=st)
            wy, wh = ref.ssm_chunk_scan(x, dt, A, Bm, Cm, h0=st)
            ey, eh = (y - wy).abs().max().item(), (h - wh).abs().max().item()
            check(torch.allclose(y, wy, rtol=2e-3, atol=2e-3)
                  and torch.allclose(h, wh, rtol=2e-3, atol=2e-3),
                  f"ssm_scan {B}x{S}x{H}x{P} N={N} chunk={chunk} h0={h0}: "
                  f"max err y {ey}, h {eh}")
            worst, worst_h = max(worst, ey), max(worst_h, eh)
    x, dt, A, Bm, Cm, _ = ssd_operands(torch, SSD_SERVE, torch.bfloat16,
                                       seed + 29, device)
    y, h = ssm_chunk_scan(x, dt, A, Bm, Cm, chunk=256)
    wy, wh = ref.ssm_chunk_scan(x, dt, A, Bm, Cm)
    diff = (y.float() - wy.float()).abs()
    eh = (h - wh).abs().max().item()
    check(bool(torch.isfinite(y).all()) and bool(
        (diff <= 2e-3 + bf16_bound(torch, wy, y)).all())
        and torch.allclose(h, wh, rtol=2e-3, atol=2e-3),
        f"ssm_scan bf16 {SSD_SERVE}: max err y {diff.max().item()}, h {eh}")
    errs["ssm_scan"] = (worst, diff.max().item())
    print(f"ssm_scan vs the sequential oracle: float32 test shapes max err y "
          f"{worst:.3g} h {worst_h:.3g} (tol 2e-3), bf16 {list(SSD_SERVE)} "
          f"max err y {diff.max().item():.3g} (tol 2e-3 + 2^-7 |y|), final "
          f"state {eh:.3g}", flush=True)

    # the UPIR registry: the simd backend resolves to the kernels
    from repro_torch.kernels import ops
    fa, ss = ops.resolve("flash_attention", "cuda"), \
        ops.resolve("ssm_scan", "cuda")
    check(fa is flash_attention and ops.resolve("flash_attention",
                                                "reference") is
          ref.flash_attention, "flash_attention registry entries")
    before = (fa.launches, ss.launches)
    q, k, v = flash_operands(torch, (2, 256, 4, 64), torch.float32, seed,
                             device)
    check(torch.allclose(fa(q, k, v, bq=64, bk=64),
                         ops.resolve("flash_attention")(q, k, v),
                         rtol=2e-4, atol=2e-4), "resolved flash_attention")
    x, dt, A, Bm, Cm, _ = ssd_operands(torch, SSD_TEST_SHAPES[0][:5],
                                       torch.float32, seed, device)
    check(torch.allclose(ss(x, dt, A, Bm, Cm, chunk=64),
                         ref.ssm_chunk_scan(x, dt, A, Bm, Cm)[0],
                         rtol=2e-3, atol=2e-3), "resolved ssm_scan")
    torch.cuda.synchronize()
    check((fa.launches, ss.launches) == (before[0] + 1, before[1] + 1),
          "the registry's simd entries did not launch their kernels")
    try:
        ops.resolve("ssm_scan", "reference")
        check(False, "ssm_scan has no reference entry, as in the reference")
    except KeyError:
        pass
    print("registry: resolve('flash_attention'|'ssm_scan', 'cuda') launched "
          "each kernel once; ssm_scan has no 'reference' entry", flush=True)
    return errs


def serve_hybrid(torch, np, args, device, buckets=(128, 256, 512),
                 prompt_lens=(100, 500), max_seq=1024):
    """Full-width zamba2-2.7b on the dense layout: engine (throughput and
    latency mode), serve_sequential and a teacher-forced prefill check."""
    from repro_torch.configs import config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models import api
    from repro_torch.models.transformer import compute_params
    from repro_torch.runtime.engine import (Engine, EngineConfig, RequestSpec,
                                            serve_sequential)
    cfg = config("zamba2-2.7b")
    n_attn = len(range(0, cfg.n_layers, cfg.hybrid_attn_period))
    rng = np.random.default_rng(args.seed + 7)
    params = api.init_params(cfg, args.seed, device=device)
    lens = rng.integers(prompt_lens[0], prompt_lens[1] + 1,
                        size=HYBRID_REQUESTS)
    specs = [RequestSpec(tuple(int(t) for t in rng.integers(0, cfg.vocab, n)),
                         HYBRID_TOKENS) for n in lens]

    def engine():
        return Engine(cfg, EngineConfig(kv_layout="dense", slots=8,
                                        max_seq=max_seq,
                                        prompt_buckets=buckets),
                      params=params, device=device)

    out = {}
    eng = engine()
    eng.run([RequestSpec((1,) * b, 2) for b in buckets])     # warm up
    eng.reset_stats()
    # the main path: every count at 0 just before it, read just after
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_attention import paged_attention_partial
    reset_counts(list(ops.SIMD.values()) + [paged_attention_partial])
    reqs = eng.run(specs)
    launches = {"ssm_scan": ssm_scan.launches,
                "flash_attention": flash_attention.launches}
    flash_routes = dict(flash_attention.launches_by_route)
    st = eng.stats()
    streams = [eng.finalize_request(r) for r in reqs]
    check(all(r.state == "done" for r in reqs), "zamba2: not all done")
    check(all(len(x) == HYBRID_TOKENS for x in streams),
          "zamba2: stream lengths")
    check(st["prefills"] == len(specs), "zamba2: prefills")
    check(launches["ssm_scan"] == st["prefills"] * cfg.n_layers,
          f"zamba2: {launches['ssm_scan']} ssm_scan launches != "
          f"{st['prefills']} prefills x {cfg.n_layers} layers")
    check(launches["flash_attention"] == st["prefills"] * n_attn,
          f"zamba2: {launches['flash_attention']} flash launches != "
          f"{st['prefills']} prefills x {n_attn} attention layers")
    check(flash_routes == {"fma": 0, "mma": launches["flash_attention"]},
          f"zamba2: flash launches by route {flash_routes}: every bf16 "
          f"prefill must take the tensor-core (mma) route")
    # ms per decode step: the whole batch of slots, synchronised
    dec = {"tokens": torch.zeros((8, 1), dtype=torch.int64, device=device),
           "pos": torch.full((8,), 600, dtype=torch.int64, device=device)}
    api.decode_step(cfg, eng.params, eng.cache, dec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        api.decode_step(cfg, eng.params, eng.cache, dec)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    out.update(streams=streams, launches=launches, steps=st["decode_steps"],
               prefills=st["prefills"], tokens_per_s=st["tokens_per_s"])
    print(f"serve[zamba2-2.7b dense]: decode_steps={st['decode_steps']} "
          f"prefills={st['prefills']} ssm_scan launches "
          f"{launches['ssm_scan']} ({cfg.n_layers}/prefill) flash_attention "
          f"launches {launches['flash_attention']} ({n_attn}/prefill, by "
          f"route {flash_routes}) tokens/s={st['tokens_per_s']:.1f} occupancy="
          f"{st['batch_occupancy']:.2f} decode step {out['step_ms']:.1f} ms",
          flush=True)
    del eng
    eng = engine()
    eng.run([RequestSpec((1,) * b, 2) for b in buckets])
    eng.reset_stats()
    reqs = eng.run(specs, sync_per_step=True)
    ttft = sorted((r.t_first - r.t_submit) * 1e3 for r in reqs)
    out["ttft_ms"] = (float(np.percentile(ttft, 50)),
                      float(np.percentile(ttft, 99)))
    out["latency_tokens_per_s"] = eng.stats()["tokens_per_s"]
    check([eng.finalize_request(r) for r in reqs] == streams,
          "zamba2: latency-mode streams differ from the throughput run")
    del eng
    seq = serve_sequential(cfg, params, specs, max_seq=max_seq,
                           prompt_buckets=buckets, device=device)
    check(streams == [seq["tokens"][i + 1] for i in range(len(specs))],
          "zamba2: engine streams != serve_sequential streams")
    out["sequential_tokens_per_s"] = seq["tokens_per_s"]
    print(f"check: zamba2 engine == serve_sequential: {len(specs)}/"
          f"{len(specs)} streams identical", flush=True)
    # the decode path (the plain recurrences, from the state the kernels'
    # prefill handed over) against a teacher-forced prefill through the
    # kernels, in float32, where rounding cannot hide a fault: the logits of
    # each emitted position agree to 1e-3 of their scale
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = compute_params(cfg32, params, torch.device(device))
    cparams = compute_params(cfg, params, torch.device(device))
    worst = worst_bf16 = 0.0
    scale = 1.0
    for i in range(0, len(specs), max(len(specs) // 4, 1)):
        b = next(b for b in buckets if b >= len(specs[i].prompt))
        padded = list(specs[i].prompt) + [0] * (b - len(specs[i].prompt))
        toks = torch.tensor([padded], dtype=torch.int64, device=device)
        _, cache = api.prefill(cfg32, p32, {"tokens": toks}, s_max=max_seq)
        for j in range(8):
            lg_d, cache = api.decode_step(cfg32, p32, cache, {
                "tokens": torch.tensor([[streams[i][j]]], device=device),
                "pos": torch.tensor([b + j], device=device)})
            if j % 4 != 3:
                continue
            lg_p = teacher_logits(torch, api, cfg32, p32, padded,
                                  streams[i][:j + 1], device)
            lg_d = lg_d[0, -1].float()
            check(bool(torch.isfinite(lg_d).all()), "zamba2: non-finite "
                  "decode logits")
            scale = max(scale, lg_p.abs().max().item())
            worst = max(worst, (lg_d - lg_p).abs().max().item())
        # bf16, as served: the gap of each emitted token to the argmax of a
        # teacher-forced bf16 prefill (reported; bf16 rounding sets it)
        for j in range(0, HYBRID_TOKENS, 16):
            lg = teacher_logits(torch, api, cfg, cparams, padded,
                                streams[i][:j], device)
            worst_bf16 = max(worst_bf16,
                             lg.max().item() - lg[streams[i][j]].item())
    check(worst <= 1e-3 * scale, f"zamba2: float32 decode logits {worst} "
          f"from the teacher-forced prefill's (> 1e-3 x {scale})")
    out["teacher_err"], out["teacher_gap_bf16"] = worst, worst_bf16
    print(f"check: zamba2 float32 decode vs teacher-forced prefill (kernels):"
          f" max |logit diff| {worst:.3g} (<= 1e-3 x max |logit| "
          f"{scale:.3g}); bf16 as served: worst top-1 gap of an emitted "
          f"token {worst_bf16:.4f}", flush=True)
    return out


def flash_work(B, S, H, hd, causal=True):
    """(bytes, operations): q, k, v read and the output written once in
    bf16; 4 flops per (query, key, channel) for q.k and p.v, over the key
    positions the causal mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * S * H * hd * 2, 4 * B * H * hd * pairs


def ssd_work(B, S, H, P, N):
    """(bytes, ms of operations) of the least work the SSD scan needs for y
    and the final state from a zero state: x in and y out in bf16, B and C
    in bf16, dt float32, the final state float32 written; the multiply-adds
    (2 flops each) of the chunked algorithm at the chunk length Q that needs
    the fewest: per chunk, C.B^T over the Q(Q+1)/2 kept pairs once for all
    heads (one B/C group), in bf16 on the tensor cores, and per head M.x
    over those pairs, C.h (not in the first chunk, whose h is zero) and the
    state update, in float32. Elementwise work (exp, the decays) is left
    out, so the bound stays below what any kernel needs."""
    n_bytes = 2 * B * S * H * P * 2 + 2 * B * S * N * 2 + B * S * H * 4 \
        + B * H * P * N * 4
    best = math.inf
    for Q in (q for q in range(1, S + 1) if S % q == 0):
        chunks, pairs = S // Q, Q * (Q + 1) // 2
        ops_bf16 = B * chunks * 2 * pairs * N
        ops_f32 = B * H * (chunks * (2 * pairs * P + 2 * Q * P * N)
                           + (chunks - 1) * 2 * Q * P * N)
        best = min(best, (ops_bf16 / BF16_FLOPS + ops_f32 / FP32_FLOPS) * 1e3)
    return n_bytes, best


def time_flash_ssm(torch, seed, errs, launches, device):
    """Flash attention and the SSD scan at the zamba2 serving shape and at
    S = 4096: kernel, plain version, library call (SDPA for attention; no
    single PyTorch call computes the SSD scan) and bound. Timing launches do
    not count."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssm_scan import ssm_chunk_scan, ssm_scan
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=device)

    def flush():
        scratch.zero_()                     # 256 MB > the 50 MB L2

    def bound(n_bytes, t_ops):
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
            else "operations"

    saved = (flash_attention.launches, ssm_scan.launches,
             dict(flash_attention.launches_by_route))
    rows = {}
    for S in (FLASH_SERVE[1], LONG_S):
        shape = (FLASH_SERVE[0], S) + FLASH_SERVE[2:]
        q, k, v = flash_operands(torch, shape, torch.bfloat16, seed + 40,
                                 device)
        iters = 20 if S <= 512 else 5
        ms = time_cuda(lambda: flash_attention(q, k, v, causal=True, bq=S,
                                               bk=S), iters, flush)
        plain_ms = time_cuda(lambda: ref.flash_attention(q, k, v,
                                                         causal=True),
                             iters, flush)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), iters, flush)
        n_bytes, n_ops = flash_work(*shape)
        b, by = bound(n_bytes, n_ops / BF16_FLOPS * 1e3)
        rows["flash", S] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                            "bound_by": by, "library_ms": lib_ms,
                            "shape": list(shape), "dtype": "bfloat16"}
        print(f"kernel flash_attention bf16 {list(shape)} causal (mma): "
              f"{ms:.4f} ms"
              f" (plain {plain_ms:.4f}, sdpa {lib_ms:.4f}, bound {b:.4f} by "
              f"{by})", flush=True)
        del q, k, v, qt, kt, vt
    for S in (SSD_SERVE[1], LONG_S):
        shape = (SSD_SERVE[0], S) + SSD_SERVE[2:]
        x, dt, A, Bm, Cm, _ = ssd_operands(torch, shape, torch.bfloat16,
                                           seed + 50, device)
        iters = 20 if S <= 512 else 5
        ms = time_cuda(lambda: ssm_chunk_scan(x, dt, A, Bm, Cm, chunk=256),
                       iters, flush)
        # the plain version, the sequential oracle: S steps of small ops,
        # so the host's launches set its time
        plain_ms = time_cuda(lambda: ref.ssm_chunk_scan(x, dt, A, Bm, Cm),
                             iters, flush)
        b, by = bound(*ssd_work(*shape))
        rows["ssm", S] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                          "bound_by": by, "library_ms": None,
                          "shape": list(shape), "dtype": "bfloat16"}
        print(f"kernel ssm_scan bf16 {list(shape)} (N {shape[-1]}, chunk "
              f"256): {ms:.4f} ms (plain {plain_ms:.4f}, no library call, "
              f"bound {b:.4f} by {by}, least chunked work: C.B^T in bf16, "
              f"the rest in float32)", flush=True)
        del x, dt, A, Bm, Cm
    flash_attention.launches, ssm_scan.launches = saved[:2]
    flash_attention.launches_by_route = saved[2]
    torch.cuda.empty_cache()
    out = []
    for name, key, S, src, line in (
            ("flash_attention", "flash", FLASH_SERVE[1], "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:67"),
            ("ssm_scan", "ssm", SSD_SERVE[1], "ssm_scan.cu",
             "src/repro/kernels/ssm_scan.py:56")):
        row = {"name": name, "route": "cuda",
               "kernel_route": "mma" if key == "flash" else "cuda_cores",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": line, "launches": launches[name],
               "max_abs_err": errs[name][1]}
        row.update(rows[key, S])
        row["max_abs_err_float32"] = errs[name][0]
        row[f"s{LONG_S}"] = rows[key, LONG_S]
        out.append(row)
    return out


PAPER_REPLACES = {"axpy": "src/repro/kernels/axpy.py:18",
                  "matvec": "src/repro/kernels/matvec.py:31",
                  "stencil2d": "src/repro/kernels/stencil2d.py:34",
                  "matmul": "src/repro/kernels/matmul.py:31"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--tie-tol", type=float, default=0.25,
                    help="near-tie width of bf16 reference logits: 8 bf16 "
                         "ulps at |logit| in [4, 8)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    device = "cuda"
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {len(build.sources())} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in build.BUILD_LOGS.items():
        for kernel, regs, spill in ptxas_report(log):
            print(f"  ptxas[{name}] {kernel}: {regs} registers, {spill} bytes "
                  f"spilled")
            check(spill == 0 or name not in ("paged_attention", "matmul"),
                  f"ptxas: {kernel} of {name}.cu spills {spill} bytes")

    t0 = time.perf_counter()
    err32, err16 = kernel_checks(torch, np, args.seed, device)
    print(f"kernels vs plain: float32 max err {err32:.3g} (tol 2e-5), "
          f"bf16 tinyllama max err {err16:.3g} (tol 1.6e-2) "
          f"[{time.perf_counter() - t0:.1f} s]", flush=True)

    t0 = time.perf_counter()
    ulps, frac = threefry_check(torch, np, device)
    print(f"threefry on the card: bits and uniforms equal the CPU's; gumbel "
          f"within {ulps:.1f} ulp of max(|g|, 1) (tol 2), {frac:.4f} of the "
          f"values differ [{time.perf_counter() - t0:.1f} s]", flush=True)

    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    reset_counts(ops.SIMD.values())
    errs = upir_phase(torch, args.seed, device)
    paper_launches = {name: ops.SIMD[name].launches for name in PAPER_REPLACES}
    mm_routes = dict(ops.SIMD["matmul"].launches_by_route)
    check(all(n > 0 for n in paper_launches.values()),
          f"a paper kernel never launched on the UPIR path: {paper_launches}")
    print(f"upir: {len(PAPER_TEST_CASES) + len(PAPER_FULL_CASES)} kernel "
          f"calls through lower_kernel_program, launches {paper_launches}, "
          f"matmul by route {mm_routes} [{time.perf_counter() - t0:.1f} s]",
          flush=True)
    matmul_route_checks(torch, args.seed, device)

    t0 = time.perf_counter()
    res = serve(torch, np, args, device)
    torch.cuda.synchronize()
    print(f"serve: one-shot {res['oneshot']['tokens_per_s']:.1f} tok/s, "
          f"chunked {res['chunked']['tokens_per_s']:.1f} tok/s, sequential "
          f"{res['sequential_tokens_per_s']:.1f} tok/s; TTFT p50 "
          f"{res['ttft_ms'][0]:.1f} ms p99 {res['ttft_ms'][1]:.1f} ms "
          f"(latency mode {res['latency_tokens_per_s']:.1f} tok/s) "
          f"[{time.perf_counter() - t0:.1f} s] on {card}", flush=True)

    t0 = time.perf_counter()
    fs_errs = flash_ssm_checks(torch, args.seed, device)
    print(f"flash/ssm checks [{time.perf_counter() - t0:.1f} s]", flush=True)

    t0 = time.perf_counter()
    hy = serve_hybrid(torch, np, args, device)
    torch.cuda.synchronize()
    print(f"serve zamba2-2.7b (dense layout): {hy['tokens_per_s']:.1f} decode "
          f"tok/s, sequential {hy['sequential_tokens_per_s']:.1f} tok/s; "
          f"TTFT p50 {hy['ttft_ms'][0]:.1f} ms p99 {hy['ttft_ms'][1]:.1f} ms "
          f"(latency mode {hy['latency_tokens_per_s']:.1f} tok/s); "
          f"{hy['step_ms']:.1f} ms per decode step (8 slots) "
          f"[{time.perf_counter() - t0:.1f} s] on {card}", flush=True)

    kernels = time_kernels(torch, np, args.seed, res["serve_limits"],
                           res["oneshot"]["launches"], device)
    kernels += time_flash_ssm(torch, args.seed, fs_errs, hy["launches"],
                              device)
    kernels += time_paper_kernels(torch, args.seed, errs, paper_launches,
                                  device)
    check(len(kernels) == 7 and all(k["launches"] > 0 for k in kernels),
          f"kernels line: {[(k['name'], k['launches']) for k in kernels]}")
    k = kernels[0]
    print(f"kernel {k['name']}: {k['ms']:.4f} ms (plain "
          f"{k['plain_ms']:.4f}, sdpa {k['library_ms']:.4f}, bound "
          f"{k['bound_ms']:.4f} by {k['bound_by']}: bytes over "
          f"{HBM_BYTES_PER_S / 1e12} TB/s, the H100 SXM data-sheet HBM3 "
          f"rate, the least time any kernel needs to move them) on {card}")
    print(f"bounds: bytes over {HBM_BYTES_PER_S / 1e12} TB/s, operations "
          f"over {BF16_FLOPS / 1e12} TFLOP/s (bf16 tensor cores) or "
          f"{FP32_FLOPS / 1e12} TFLOP/s (float32 CUDA cores), H100 SXM data "
          f"sheet; times on {card}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
