"""The port's dense model vs the JAX package's: parameter names and shapes,
the parameter conversion, and prefill / paged decode / chunked-prefill logits
with converted parameters (float32 smoke config, ``rtol=atol=1e-4``: the two
frameworks sum in different orders across four layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import config as jconfig, smoke_config as jsmoke
from repro.core.lower import path_str, tree_symbols as j_tree_symbols
from repro.models import api as japi
from repro_torch.configs import config as tconfig, smoke_config as tsmoke
from repro_torch.convert import from_reference, to_flat
from repro_torch.core.lower import tree_symbols
from repro_torch.models import api as tapi
from repro_torch.models.transformer import KernelSpec

torch.set_num_threads(1)
ARCH = "tinyllama-1.1b"
JC, TC = jsmoke(ARCH), tsmoke(ARCH)
TOL = dict(rtol=1e-4, atol=1e-4)
PS = 4


@pytest.fixture(scope="module")
def params():
    jp = japi.init_params(JC, jax.random.key(0))
    flat = {path_str(p): np.asarray(jax.device_get(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    return jp, flat, from_reference(flat, cfg=TC, device="cpu")


@pytest.mark.parametrize("smoke", [True, False])
def test_param_specs_equal_reference(smoke):
    jc, tc = (JC, TC) if smoke else (jconfig(ARCH), tconfig(ARCH))
    assert tree_symbols(tapi.param_specs(tc)) == \
        j_tree_symbols(japi.param_specs(jc))


def test_from_reference_round_trips(params):
    _, flat, tp = params
    back = to_flat(tp)
    assert set(back) == set(flat)
    for k, v in flat.items():
        assert back[k].dtype == torch.float32
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_from_reference_rejects_wrong_shapes(params):
    _, flat, _ = params
    bad = dict(flat)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError, match="shapes"):
        from_reference(bad, cfg=TC, device="cpu")
    del bad["embed"]
    with pytest.raises(ValueError, match="names"):
        from_reference(bad, cfg=TC, device="cpu")


def toks(shape, seed):
    return np.random.default_rng(seed).integers(0, TC.vocab, size=shape)


def test_prefill_logits_and_cache(params):
    jp, _, tp = params
    x = toks((2, 12), 1)
    lj, cj = japi.prefill(JC, jp, {"tokens": jnp.asarray(x)}, s_max=16)
    lt, ct = tapi.prefill(TC, tp, {"tokens": torch.from_numpy(x)}, s_max=16)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), **TOL)


def _pools(seed, n_pages=12):
    """A pool with random K/V in every page, identical for both packages."""
    shape = (TC.n_layers, n_pages + 1, PS, TC.n_kv_heads, TC.hd)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("k_pages", "v_pages")}


@pytest.mark.parametrize("attn_impl", ["cuda", "torch"])
def test_decode_step_paged_logits_and_pool(params, attn_impl):
    jp, _, tp = params
    pool = _pools(2)
    pt = np.array([[3, 7, 1], [2, 0, 0], [0, 0, 0]], np.int32)  # row 2: idle
    pos = np.array([9, 2, 0], np.int32)
    x = toks((3, 1), 3)
    lj, pj = japi.decode_step_paged(
        JC, jp, {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(pt), {"tokens": jnp.asarray(x), "pos": jnp.asarray(pos)})
    lt, pt_out = tapi.decode_step_paged(
        TC, tp, {k: torch.from_numpy(v.copy()) for k, v in pool.items()},
        torch.from_numpy(pt), {"tokens": torch.from_numpy(x),
                               "pos": torch.from_numpy(pos)},
        kernel=KernelSpec(attn_impl))
    np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2], **TOL)
    for k in pool:   # the null page 0 takes stray writes in both: skip it
        np.testing.assert_allclose(pt_out[k][:, 1:].numpy(),
                                   np.asarray(pj[k])[:, 1:], **TOL)


@pytest.mark.parametrize("offset,width", [(0, 0), (8, 2), (8, 4)])
def test_prefill_chunk_logits_and_kv(params, offset, width):
    jp, _, tp = params
    pool = _pools(4)
    row = np.array([5, 9, 2, 11], np.int32)[:width]
    x = toks((1, 8), 5)
    lj, (kj, vj) = japi.prefill_chunk(
        JC, jp, {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(row),
        {"tokens": jnp.asarray(x)}, jnp.int32(offset))
    lt, (kt, vt) = tapi.prefill_chunk(
        TC, tp, {k: torch.from_numpy(v) for k, v in pool.items()},
        torch.from_numpy(row), {"tokens": torch.from_numpy(x)}, offset)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **TOL)


def test_init_params_shapes_and_device_switch():
    p = tapi.init_params(TC, 0, device="cpu")
    assert tree_symbols(to_flat(p)) == tree_symbols(tapi.param_specs(TC))
    q = tapi.init_params(TC, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(to_flat(p).values(), to_flat(q).values()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapi.init_params(TC, 0)


def test_other_families_are_not_registered():
    import dataclasses
    moe_like = dataclasses.replace(TC, family="moe")
    with pytest.raises(KeyError, match="ROADMAP"):
        tapi.family_spec(moe_like)
