"""The hybrid family (zamba2: Mamba2 + shared attention) and the dense KV
layout of the port vs the JAX package, on the CPU at the smoke size, float32.

* ``prefill`` / ``decode_step``: logits and every cache leaf against the
  reference's, within 1e-4 (float32, summed in another order; the cache
  leaves and logits agree to ~1e-5). Prompts longer than the smoke window
  (64) exercise the rolling cache and the windowed attention.
* Plans: program text and ``program_fingerprint`` equal the reference's in
  every engine mode of the reference's lint matrix that the hybrid family is
  in, and in the dense-layout modes of ``tinyllama-1.1b``.
* Serving: greedy hybrid streams equal the reference's, taken from a
  test-side loop over ``repro.models.api.prefill`` / ``decode_step`` with
  fresh inputs (never the reference ``Engine``, whose in-place host buffers
  race jax's asynchronous dispatch, ROADMAP Q3); inside the port, the engine
  on the dense layout equals ``serve_sequential``, greedy and sampled, and
  tinyllama's dense layout equals its paged one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES, ShapeCfg as JShape, \
    config as jconfig, smoke_config as jsmoke
from repro.core.lower import path_str
from repro.core.plans import build_program as j_build
from repro.core.printer import program_fingerprint as j_fp, to_mlir as j_text
from repro.models import api as japi
from repro_torch.configs import SHAPES, ShapeCfg, cell_supported, config, \
    smoke_config
from repro_torch.convert import from_reference
from repro_torch.core.lower import PlanCache
from repro_torch.core.plans import build_program
from repro_torch.core.printer import program_fingerprint, to_mlir
from repro_torch.models import api
from repro_torch.runtime.engine import (Engine, EngineConfig, RequestSpec,
                                        serve_sequential)
from repro_torch.runtime.sampling import SamplingParams

torch.set_num_threads(1)
HYBRID, DENSE = "zamba2-2.7b", "tinyllama-1.1b"
TOL = dict(rtol=1e-4, atol=1e-4)
BUCKETS, TOKENS = (16, 80), 6
MAX_SEQ = BUCKETS[-1] + TOKENS


def convert(arch):
    jc, tc = jsmoke(arch), smoke_config(arch)
    jp = jax.jit(functools.partial(japi.init_params, jc))(jax.random.key(0))
    flat = {path_str(p): np.asarray(jax.device_get(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return jc, tc, jp, from_reference(flat, cfg=tc, device="cpu")


@functools.lru_cache(maxsize=None)
def reference_fns(arch):
    """The JAX package's prefill (cache horizon MAX_SEQ) and decode step,
    jitted once per file."""
    jc = jsmoke(arch)
    return (jax.jit(functools.partial(japi.prefill, jc, s_max=MAX_SEQ)),
            jax.jit(functools.partial(japi.decode_step, jc)))


@pytest.fixture(scope="module")
def hybrid():
    return convert(HYBRID)


@pytest.fixture(scope="module")
def dense():
    return convert(DENSE)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ----------------------------------------------------------- model entry points


@pytest.mark.parametrize("S", [24, 80])
def test_hybrid_prefill_and_decode_match_reference(hybrid, S):
    jc, tc, jp, tp = hybrid
    prefill, decode = reference_fns(HYBRID)
    toks = np.random.default_rng(S).integers(0, tc.vocab, (2, S)) \
        .astype(np.int32)
    jl, jcache = prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = api.prefill(tc, tp, {"tokens": torch.from_numpy(toks).long()},
                             s_max=MAX_SEQ)
    close(tl, jl)
    assert set(tcache) == set(jcache) == {"conv", "ssm", "k", "v"}
    for k in jcache:
        assert tuple(tcache[k].shape) == jcache[k].shape
        close(tcache[k], jcache[k])
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((2,), S + step, np.int32)
        jl, jcache = decode(jp, jcache, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos)})
        tl, tcache = api.decode_step(tc, tp, tcache,
                                     {"tokens": torch.from_numpy(tok).long(),
                                      "pos": torch.from_numpy(pos).long()})
        close(tl, jl)
        for k in jcache:
            close(tcache[k], jcache[k])


def test_dense_layout_decode_step_matches_reference(dense):
    jc, tc, jp, tp = dense
    prefill, decode = reference_fns(DENSE)
    toks = np.random.default_rng(5).integers(0, tc.vocab, (3, 8)) \
        .astype(np.int32)
    jl, jcache = prefill(jp, {"tokens": jnp.asarray(toks)})
    _, tcache = api.prefill(tc, tp, {"tokens": torch.from_numpy(toks).long()},
                            s_max=MAX_SEQ)
    for step in range(3):
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        pos = np.full((3,), 8 + step, np.int32)
        jl, jcache = decode(jp, jcache, {"tokens": jnp.asarray(tok),
                                         "pos": jnp.asarray(pos)})
        tl, tcache = api.decode_step(tc, tp, tcache,
                                     {"tokens": torch.from_numpy(tok).long(),
                                      "pos": torch.from_numpy(pos).long()})
        close(tl, jl)
        for k in jcache:
            close(tcache[k], jcache[k])


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", [HYBRID, DENSE])
def test_cache_specs_equal_reference(arch, smoke):
    jc, tc = (jsmoke(arch), smoke_config(arch)) if smoke else \
        (jconfig(arch), config(arch))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in japi.cache_specs(jc, 4, 128).items()}
    assert api.cache_specs(tc, 4, 128) == want
    assert api.cache_batch_dims(tc, 128) == dict(japi.cache_batch_dims(jc,
                                                                       128))
    assert api.family_spec(tc).capabilities == \
        japi.family_spec(jc).capabilities


# ------------------------------------------------------------------------ plans

# the reference lint matrix's modes (src/repro/launch/lint.py) for a family
# without the 'pageable' capability, on its engine-shaped decode cell
LINT_MODES = {"dense": {},
              "sched": {"scheduling": {"policy": "priority", "preempt": True}},
              "traced": {"traced": True},
              "ft": {"fault_tolerant": True}}
PLAN_CASES = [(HYBRID, m) for m in LINT_MODES] \
    + [(HYBRID, c) for c in SHAPES if SHAPES[c].kind != "train"] \
    + [(DENSE, m) for m in ("sched", "traced", "ft")]


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch,mode", PLAN_CASES,
                         ids=[f"{a}-{m}" for a, m in PLAN_CASES])
def test_program_text_and_fingerprint_equal_reference(arch, mode, smoke):
    jc, tc = (jsmoke(arch), smoke_config(arch)) if smoke else \
        (jconfig(arch), config(arch))
    if mode in SHAPES:
        assert cell_supported(tc, SHAPES[mode])[0]
        a, b = j_build(jc, J_SHAPES[mode]), build_program(tc, SHAPES[mode])
    else:
        a = j_build(jc, JShape("lint_b4", "decode", 128, 4),
                    **LINT_MODES[mode])
        b = build_program(tc, ShapeCfg("lint_b4", "decode", 128, 4),
                          **LINT_MODES[mode])
    assert to_mlir(b) == j_text(a)
    assert program_fingerprint(b) == j_fp(a)


# ---------------------------------------------------------------------- serving


def workload(vocab, n=6, seed=3):
    """Prompts of 1-80 tokens: buckets 16 and 80, the longer past the
    smoke window of 64."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=int(rng.integers(1, 81))).tolist(),
             int(rng.integers(1, TOKENS + 1))) for _ in range(n)]


def specs(work, sampling=None):
    return [RequestSpec(tuple(p), n, sampling=sampling) for p, n in work]


def engine(cfg, tp, layout="dense", slots=4):
    return Engine(cfg, EngineConfig(slots=slots, prompt_buckets=BUCKETS,
                                    max_seq=MAX_SEQ, kv_layout=layout,
                                    page_size=8),
                  params=tp, plan_cache=PlanCache(), device="cpu")


def run(e, work, sampling=None):
    reqs = e.run(specs(work, sampling))
    assert all(r.state == "done" for r in reqs)
    return [e.finalize_request(r) for r in reqs]


def reference_streams(jp, work):
    """Greedy streams of the JAX package, one request at a time; every
    input is a fresh array that nothing changes after the call."""
    prefill, decode = reference_fns(HYBRID)
    out = []
    for prompt, n in work:
        bucket = next(b for b in BUCKETS if b >= len(prompt))
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :len(prompt)] = prompt
        logits, cache = prefill(jp, {"tokens": jnp.asarray(toks)})
        stream = [int(np.argmax(np.asarray(logits[0, -1])))]
        for i in range(n - 1):
            logits, cache = decode(jp, cache, {
                "tokens": jnp.asarray(np.array([[stream[-1]]], np.int32)),
                "pos": jnp.asarray(np.array([bucket + i], np.int32))})
            stream.append(int(np.argmax(np.asarray(logits[0, -1]))))
        out.append(stream)
    return out


def test_hybrid_greedy_streams_equal_reference(hybrid):
    _, tc, jp, tp = hybrid
    work = workload(tc.vocab)
    e = engine(tc, tp)
    assert run(e, work) == reference_streams(jp, work)
    st = e.stats()
    assert st["kv_layout"] == "dense" and "evictions" not in st
    assert st["capabilities"] == ["stateful_cache"]


SAMPLED = SamplingParams(temperature=0.9, top_k=16, top_p=0.9, seed=5)


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("arch", [HYBRID, DENSE])
def test_dense_engine_equals_serve_sequential(hybrid, dense, arch, sampled):
    _, tc, _, tp = hybrid if arch == HYBRID else dense
    work = workload(tc.vocab, n=5, seed=9)
    sampling = SAMPLED if sampled else None
    got = run(engine(tc, tp), work, sampling)
    seq = serve_sequential(tc, tp, specs(work, sampling), max_seq=MAX_SEQ,
                           prompt_buckets=BUCKETS, kv_layout="dense",
                           device="cpu")
    assert got == [seq["tokens"][i + 1] for i in range(len(work))]
    assert seq["tokens_generated"] == sum(n - 1 for _, n in work)
    if sampled:
        assert got != run(engine(tc, tp), work)   # it really sampled


def test_dense_layout_equals_paged_for_tinyllama(dense):
    _, tc, _, tp = dense
    work = workload(tc.vocab, n=6, seed=11)
    for sampling in (None, SAMPLED):
        assert run(engine(tc, tp), work, sampling) == \
            run(engine(tc, tp, layout="paged"), work, sampling)


def test_hybrid_is_not_pageable(hybrid):
    _, tc, _, tp = hybrid
    with pytest.raises(api.CapabilityError, match="pageable"):
        engine(tc, tp, layout="paged")
    with pytest.raises(api.CapabilityError, match="pageable"):
        api.init_paged_cache(tc, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="kv_layout"):
        serve_sequential(tc, tp, [], max_seq=MAX_SEQ, kv_layout="rolling",
                         device="cpu")


def test_launcher_serves_hybrid_on_the_dense_layout(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", HYBRID, "--kv-layout", "dense", "--smoke", "--device",
          "cpu", "--requests", "3", "--slots", "2", "--tokens", "4",
          "--sequential"])
    out = capsys.readouterr().out
    assert "kv_layout=dense" in out and "completed=3" in out
    assert "streams identical: True" in out
