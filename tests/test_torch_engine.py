"""The port's serving engine vs the JAX package, on the CPU at the smoke size.

Reference streams come from a test-side loop over the JAX package's
``api.prefill`` and ``api.decode_step_paged``, fed fresh numpy inputs that
nothing changes after the call; its tokens are the argmax, or for sampled
workloads the JAX package's ``sampling.sample_tokens``, which draws
``gumbel(fold_in(request_key, pos))`` — not from the reference ``Engine``, whose
in-place host buffers race jax's asynchronous CPU dispatch (ROADMAP Q3).
Nothing here changes JAX's configuration.

The workloads are those of ``tests/test_engine.py``: the mixed-length
workload (one-shot and chunked prefill) and the overcommitted pool that
forces eviction-by-recompute. Inside the port the reference's own contracts
must hold too: engine == ``serve_sequential``, chunked == one-shot, and
sampled streams replay identically after eviction.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke
from repro.core.lower import path_str
from repro.models import api as japi
from repro.models.layers import cache_write_pages as j_write_pages
from repro.runtime import sampling as jsamp
from repro_torch.configs import smoke_config
from repro_torch.convert import from_reference
from repro_torch.core.lower import PlanCache
from repro_torch.runtime import engine as eng_mod
from repro_torch.runtime.engine import (Engine, EngineConfig, RequestSpec,
                                        serve_sequential)
from repro_torch.runtime.sampling import SamplingParams

torch.set_num_threads(1)
ARCH = "tinyllama-1.1b"
JC, CFG = jsmoke(ARCH), smoke_config(ARCH)
BUCKET, TOKENS, PAGE = 8, 6, 4
MAX_SEQ = BUCKET + TOKENS


@pytest.fixture(scope="module")
def params():
    jp = japi.init_params(JC, jax.random.key(0))
    flat = {path_str(p): np.asarray(jax.device_get(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return jp, from_reference(flat, cfg=CFG, device="cpu")


def mixed_workload(n=6, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab, size=int(rng.integers(1, BUCKET + 1))
                          ).tolist(), int(rng.integers(1, TOKENS + 1)))
            for _ in range(n)]


def prompts(n, length=BUCKET, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab, size=length).tolist() for _ in range(n)]


def reference_streams(jp, work, sampling=None, trace=None):
    """Streams of the JAX package, one request at a time through its paged
    decode step; every input is a fresh array. Greedy takes the argmax; a
    ``sampling`` policy samples with the request key of rid ``index + 1``
    (the rids a fresh engine assigns) at each position. ``trace`` (a list)
    collects each request's (position, f32 logits) per emitted token."""
    pages = -(-MAX_SEQ // PAGE)
    decode = jax.jit(functools.partial(japi.decode_step_paged, JC))
    table = np.arange(1, pages + 1, dtype=np.int32)[None, :]
    out = []
    for rid, (prompt, n) in enumerate(work, start=1):
        steps = []

        def pick(logits, pos):
            lg = np.asarray(logits[0, -1], np.float32)
            steps.append((pos, lg))
            if sampling is None or sampling.greedy:
                return int(np.argmax(lg))
            return int(reference_select(lg, sampling, rid, pos))

        toks = np.zeros((1, BUCKET), np.int32)
        toks[0, :len(prompt)] = prompt
        n_pre = -(-BUCKET // PAGE)
        logits, cache = japi.prefill(JC, jp, {"tokens": jnp.asarray(toks)},
                                     s_max=n_pre * PAGE)
        pool = japi.init_paged_cache(JC, pages, PAGE)
        ids = jnp.asarray(np.arange(1, n_pre + 1, dtype=np.int32))
        pool = {"k_pages": j_write_pages(pool["k_pages"], cache["k"], ids),
                "v_pages": j_write_pages(pool["v_pages"], cache["v"], ids)}
        stream = [pick(logits, BUCKET - 1)]
        for i in range(n - 1):
            batch = {"tokens": jnp.asarray(np.array([[stream[-1]]], np.int32)),
                     "pos": jnp.asarray(np.array([BUCKET + i], np.int32))}
            logits, pool = decode(jp, pool, jnp.asarray(table.copy()), batch)
            stream.append(pick(logits, BUCKET + i))
        out.append(stream)
        if trace is not None:
            trace.append(steps)
    return out


_jsample = jax.jit(jsamp.sample_tokens)


def reference_select(lg, sampling, rid, pos, scores=False):
    """The JAX package's sampled token at ``pos`` of request ``rid``; with
    ``scores`` its perturbed scores (masked, scaled logits + Gumbel)."""
    js = jsamp.SamplingParams(temperature=sampling.temperature,
                              top_k=sampling.top_k, top_p=sampling.top_p,
                              seed=sampling.seed)
    key = jnp.asarray(jsamp.request_key(js, rid)[None])
    temps = jnp.asarray([js.temperature], jnp.float32)
    top_ks = jnp.asarray([js.top_k], jnp.int32)
    top_ps = jnp.asarray([js.top_p], jnp.float32) if js.top_p < 1.0 else None
    lg = jnp.asarray(lg[None])
    if not scores:
        return _jsample(lg, key, jnp.asarray([pos], jnp.int32), temps,
                        top_ks, top_ps)[0]
    masked = jnp.where(jsamp.policy_mask(lg, top_ks, top_ps),
                       lg / temps[:, None], -jnp.inf)
    gum = jax.random.gumbel(jax.random.fold_in(key[0], pos), lg.shape[-1:],
                            jnp.float32)
    return np.asarray(masked[0] + gum)


def engine(tp, slots=2, num_pages=0, prefill_chunk=0, **kw):
    return Engine(CFG, EngineConfig(slots=slots, prompt_buckets=(BUCKET,),
                                    max_seq=MAX_SEQ, page_size=PAGE,
                                    num_pages=num_pages,
                                    prefill_chunk=prefill_chunk, **kw),
                  params=tp, plan_cache=PlanCache(), device="cpu")


def specs(work, sampling=None, eos_id=None):
    return [RequestSpec(tuple(p), n, sampling=sampling, eos_id=eos_id)
            for p, n in work]


def run(e, work, **kw):
    reqs = e.run(specs(work, **kw))
    assert all(r.state == "done" for r in reqs)
    return [e.finalize_request(r) for r in reqs]


@pytest.mark.parametrize("chunk", [0, PAGE])
def test_greedy_streams_equal_reference(params, chunk):
    jp, tp = params
    work = mixed_workload()
    e = engine(tp, prefill_chunk=chunk)
    assert run(e, work) == reference_streams(jp, work)
    if chunk:
        assert e.stats()["prefill_chunks"] > 0
    e.check_invariants()
    assert e.allocator.in_use == 0


def test_overcommit_eviction_equals_reference(params):
    jp, tp = params
    work = [(p, TOKENS) for p in prompts(6)]
    e = engine(tp, slots=4, num_pages=10)
    got = run(e, work)
    st = e.stats()
    assert st["evictions"] > 0
    assert got == reference_streams(jp, work)
    assert st["pages_in_use"] == 0
    assert e.allocator.available == e.num_pages
    assert st["peak_pages"] <= e.num_pages


@pytest.mark.parametrize("chunk", [0, PAGE])
def test_engine_equals_serve_sequential(params, chunk):
    _, tp = params
    work = mixed_workload(5, seed=9)
    got = run(engine(tp, prefill_chunk=chunk), work)
    seq = serve_sequential(CFG, tp, specs(work), max_seq=MAX_SEQ,
                           prompt_buckets=(BUCKET,), page_size=PAGE,
                           device="cpu")
    assert got == [seq["tokens"][i + 1] for i in range(len(work))]
    assert seq["tokens_generated"] == sum(n - 1 for _, n in work)


def test_chunked_equals_oneshot_and_counts_chunks(params):
    _, tp = params
    work = mixed_workload(5, seed=11)
    one = run(engine(tp), work)
    e = engine(tp, prefill_chunk=PAGE)
    assert run(e, work) == one
    e2 = engine(tp, prefill_chunk=PAGE)
    run(e2, [([1] * BUCKET, 3)])
    assert e2.stats()["prefill_chunks"] == BUCKET // PAGE


SAMPLED = SamplingParams(temperature=0.9, top_k=40, top_p=0.9, seed=5)
# a sampled stream may leave the reference's only where two tokens' perturbed
# scores are this close: the port's f32 logits agree with the reference's to
# ~1e-6 at the smoke size, and its Gumbel noise to 2 ulp (~4e-6 at |g| < 16)
SCORE_TIE = 1e-4


# the sampled workloads of tests/test_engine.py, at this file's smoke size
@pytest.mark.parametrize("sampling,slots,num_pages,chunk,n", [
    (SamplingParams(temperature=0.9, top_k=4, seed=7), 2, 0, 0, 4),
    (SamplingParams(temperature=1.2, top_p=0.7, seed=5), 2, 0, 0, 4),
    (SamplingParams(temperature=1.0, seed=7), 4, 10, 0, 6),
    (SamplingParams(temperature=1.2, top_k=16, seed=3), 2, 0, PAGE, 4),
    (SAMPLED, 2, 0, PAGE, 4),
], ids=["top_k", "top_p", "eviction", "chunked", "top_k_top_p"])
def test_sampled_streams_equal_reference(params, sampling, slots, num_pages,
                                         chunk, n):
    jp, tp = params
    work = [(p, TOKENS) for p in prompts(n, seed=13)]
    e = engine(tp, slots=slots, num_pages=num_pages, prefill_chunk=chunk)
    got = run(e, work, sampling=sampling)
    if num_pages:
        assert e.stats()["evictions"] > 0
    trace = []
    want = reference_streams(jp, work, sampling, trace)
    assert any(t != int(np.argmax(lg))             # it really sampled
               for w, steps in zip(want, trace)
               for t, (_, lg) in zip(w, steps))
    differ = 0
    for rid, (g, w) in enumerate(zip(got, want), start=1):
        j = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None:
            continue
        differ += 1
        pos, lg = trace[rid - 1][j]
        sc = reference_select(lg, sampling, rid, pos, scores=True)
        assert abs(sc[g[j]] - sc[w[j]]) <= SCORE_TIE, (
            f"request {rid} leaves the reference at token {j} where the "
            f"scores are no near-tie")
    print(f"sampled streams differing from the reference: {differ}/{n}")


def test_sampled_replay_after_eviction(params):
    _, tp = params
    work = [(p, TOKENS) for p in prompts(6, seed=4)]
    roomy = run(engine(tp, slots=4), work, sampling=SAMPLED)
    e = engine(tp, slots=4, num_pages=10)
    tight = run(e, work, sampling=SAMPLED)
    assert e.stats()["evictions"] > 0
    assert tight == roomy
    seq = serve_sequential(CFG, tp, specs(work, sampling=SAMPLED),
                           max_seq=MAX_SEQ, prompt_buckets=(BUCKET,),
                           page_size=PAGE, device="cpu")
    assert roomy == [seq["tokens"][i + 1] for i in range(len(work))]
    greedy = run(engine(tp, slots=4), work)
    assert roomy != greedy                  # the sampler actually sampled


def test_penalized_and_eos_streams_equal_serve_sequential(params):
    _, tp = params
    work = [(p, TOKENS) for p in prompts(4, seed=6)]
    pen = SamplingParams(presence_penalty=1.5, frequency_penalty=0.5)
    got = run(engine(tp, eos_poll_every=1), work, sampling=pen)
    seq = serve_sequential(CFG, tp, specs(work, sampling=pen),
                           max_seq=MAX_SEQ, prompt_buckets=(BUCKET,),
                           page_size=PAGE, device="cpu")
    assert got == [seq["tokens"][i + 1] for i in range(len(work))]
    eos = got[0][2]
    e = engine(tp, eos_poll_every=1)
    cut = run(e, work, sampling=pen, eos_id=eos)
    assert cut[0] == got[0][:3]
    assert all(s == g[:g.index(eos) + 1] if eos in g else s == g
               for s, g in zip(cut, got))
    assert e.stats()["eos_finished"] >= 1


def test_admission_rejections(params):
    _, tp = params
    e = engine(tp, num_pages=3, max_queue=1)
    r = e.submit(RequestSpec((1,) * BUCKET, TOKENS))   # needs 4 pages > 3
    assert r.state == "rejected" and "pages" in r.reason
    r = e.submit(RequestSpec((1,) * (BUCKET + 1), 1))
    assert r.state == "rejected" and "bucket" in r.reason
    assert e.submit(RequestSpec((1,), 1)).state == "queued"
    r = e.submit(RequestSpec((1,), 1))
    assert r.reason == "REJECTED_QUEUE_FULL"
    assert e.stats()["rejected_queue_full"] == 1


@pytest.mark.parametrize("name,value", [
    (n, {False: True, 0: 4, None: object()}[d])
    for n, d, _ in eng_mod._UNPORTED])
def test_unported_features_raise(params, name, value):
    _, tp = params
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine(tp, **{name: value})


def test_dense_layout_raises(params):
    """The dense layout is ported (tests/test_torch_hybrid.py holds it
    against the reference); a layout that is neither raises, naming both."""
    _, tp = params
    assert engine(tp, kv_layout="dense").stats()["kv_layout"] == "dense"
    with pytest.raises(ValueError, match="'dense' or 'paged'"):
        engine(tp, kv_layout="rolling")


def test_plan_is_cached_and_carries_geometry(params):
    _, tp = params
    cache = PlanCache()
    a = Engine(CFG, EngineConfig(prompt_buckets=(BUCKET,), max_seq=MAX_SEQ,
                                 page_size=PAGE), params=tp,
               plan_cache=cache, device="cpu")
    b = Engine(CFG, EngineConfig(prompt_buckets=(BUCKET,), max_seq=MAX_SEQ,
                                 page_size=PAGE), params=tp,
               plan_cache=cache, device="cpu")
    assert a.plan is b.plan and cache.hits == 1
    assert a.plan.page_geometry == (a.num_pages, PAGE, a.pages_per_slot)
