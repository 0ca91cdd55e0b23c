"""The port's UPIR planner vs the JAX package's: the program text and its
``program_fingerprint`` must be byte-identical for the same (config, shape,
engine mode), and the ``PlanCache`` must hit, miss and evict as the
reference's does (``tests/test_engine.py``)."""
import pytest

from repro.configs import ShapeCfg as JShape, config as jconfig, \
    smoke_config as jsmoke
from repro.core.plans import build_program as j_build
from repro.core.printer import program_fingerprint as j_fp, to_mlir as j_text
from repro.runtime.scheduling import SchedulingPolicy as JPolicy
from repro_torch.configs import ShapeCfg, config, smoke_config
from repro_torch.core.lower import PlanCache, plan_from_program
from repro_torch.core.passes import run_pipeline
from repro_torch.core.plans import build_program
from repro_torch.core.printer import program_fingerprint, to_mlir
from repro_torch.runtime.scheduling import SchedulingPolicy
from repro_torch.runtime.server import serving_plan

ARCH = "tinyllama-1.1b"
CFG = smoke_config(ARCH)
MAX_SEQ = 14


def decode_shape(batch=2):
    return ShapeCfg(f"engine_b{batch}", "decode", MAX_SEQ, batch)


MODES = {
    "dense": {},
    "paged": dict(page_geometry=(8, 4, 4)),
    "paged_fifo": dict(page_geometry=(8, 4, 4), scheduling="fifo"),
    "paged_priority": dict(page_geometry=(8, 4, 4), scheduling="priority"),
    "prefix": dict(page_geometry=(8, 4, 4), prefix_sharing=True),
    "ft_traced": dict(page_geometry=(8, 4, 4), fault_tolerant=True,
                      traced=True),
    "tiered": dict(page_geometry=(8, 4, 4), prefix_sharing=True, tiering=16),
    "disagg": dict(page_geometry=(8, 4, 4), disaggregated=True),
    "spec": dict(spec_decode=("draft", 3)),
}


def _kw(mode, policy_cls):
    kw = dict(MODES[mode])
    if "scheduling" in kw:
        kw["scheduling"] = policy_cls(kind=kw["scheduling"]).ext()
    return kw


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_program_text_and_fingerprint_equal_reference(smoke, mode):
    jc, tc = (jsmoke(ARCH), CFG) if smoke else (jconfig(ARCH), config(ARCH))
    jshape = JShape("engine_b8", "decode", 1024, 8)
    tshape = ShapeCfg("engine_b8", "decode", 1024, 8)
    a = j_build(jc, jshape, **_kw(mode, JPolicy))
    b = build_program(tc, tshape, **_kw(mode, SchedulingPolicy))
    assert to_mlir(b) == j_text(a)
    assert program_fingerprint(b) == j_fp(a)


@pytest.mark.parametrize("smoke", [True, False])
def test_prefill_program_equal_reference(smoke):
    jc, tc = (jsmoke(ARCH), CFG) if smoke else (jconfig(ARCH), config(ARCH))
    a = j_build(jc, JShape("p128", "prefill", 128, 1))
    b = build_program(tc, ShapeCfg("p128", "prefill", 128, 1))
    assert to_mlir(b) == j_text(a)
    assert program_fingerprint(b) == j_fp(a)


def test_train_programs_wait_for_the_training_slice():
    with pytest.raises(NotImplementedError, match="training slice"):
        build_program(CFG, ShapeCfg("t", "train", 16, 2))
    with pytest.raises(NotImplementedError, match="verifier"):
        build_program(CFG, decode_shape(), verify=True)


def test_paged_plan_carries_geometry():
    plan = plan_from_program(run_pipeline(build_program(
        CFG, decode_shape(), page_geometry=(8, 4, 4),
        scheduling=SchedulingPolicy().ext())))
    assert plan.page_geometry == (8, 4, 4)
    assert plan.capabilities == ("pageable",)
    assert plan.scheduling == (("policy", "fifo"),)
    assert not plan.prefix_sharing and not plan.fault_tolerant


# -------------------------------------- PlanCache (as tests/test_engine.py)


def test_fingerprint_stable_across_builds_and_pipeline():
    a = build_program(CFG, decode_shape())
    b = build_program(CFG, decode_shape())
    assert program_fingerprint(a) == program_fingerprint(b)
    assert program_fingerprint(run_pipeline(a)) == \
        program_fingerprint(run_pipeline(b))
    assert program_fingerprint(a) != \
        program_fingerprint(build_program(CFG, decode_shape(batch=4)))


def test_plan_cache_hit_miss():
    cache = PlanCache()
    p1 = cache.lowered_plan(build_program(CFG, decode_shape()))
    assert (cache.hits, cache.misses) == (0, 1)
    p2 = cache.lowered_plan(build_program(CFG, decode_shape()))
    assert (cache.hits, cache.misses) == (1, 1)
    assert p1 is p2
    assert p1.fingerprint
    assert cache.stats()["hit_rate"] == 0.5


def test_plan_cache_miss_on_different_key():
    cache = PlanCache()
    cache.lowered_plan(build_program(CFG, decode_shape()))
    cache.lowered_plan(build_program(CFG, decode_shape()), backend="gspmd")
    cache.lowered_plan(build_program(CFG, decode_shape(batch=4)))
    assert cache.misses == 3 and cache.hits == 0


def test_plan_cache_skips_pipeline_on_hit():
    cache = PlanCache()
    trace = []
    cache.lowered_plan(build_program(CFG, decode_shape()), trace=trace)
    n_pass_entries = len(trace)
    assert n_pass_entries > 0
    cache.lowered_plan(build_program(CFG, decode_shape()), trace=trace)
    assert len(trace) == n_pass_entries


def test_plan_cache_lru_bound():
    cache = PlanCache(maxsize=2)
    for b in (2, 3, 4):
        cache.lowered_plan(build_program(CFG, decode_shape(batch=b)))
    assert cache.stats()["size"] == 2


def test_serving_plan_goes_through_the_cache():
    cache = PlanCache()
    a = serving_plan(CFG, decode_shape(), plan_cache=cache,
                     page_geometry=(8, 4, 4))
    b = serving_plan(CFG, decode_shape(), plan_cache=cache,
                     page_geometry=(8, 4, 4))
    assert a is b and (cache.hits, cache.misses) == (1, 1)
    c = serving_plan(CFG, decode_shape(), plan_cache=cache,
                     page_geometry=(8, 8, 2))
    assert c.fingerprint != a.fingerprint and cache.misses == 2
