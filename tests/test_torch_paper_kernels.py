"""The paper's four kernels in the port vs the JAX package, on the CPU.

For a CPU tensor each wrapper runs its plain version; here that is held
against the JAX package's Pallas kernel in interpret mode
(``repro.kernels.ops``) at the smallest shape of ``tests/test_kernels.py``
per kernel and dtype, with that file's tolerances. The Pallas stencil does
not run on this JAX (``pl.load`` is gone), so the stencil is held against the
JAX oracle ``repro.kernels.ref.stencil2d``. The registry routes ``simd``
programs to the CUDA wrappers and ``worksharing`` programs to the oracles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import axpy as jaxpy_mod
from repro.kernels import matmul as jmatmul_mod
from repro.kernels import matvec as jmatvec_mod
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import stencil2d as jstencil_mod
from repro_torch.core.frontends import omp
from repro_torch.kernels import axpy, matmul, matvec, ops, ref, stencil2d
from repro_torch.kernels.programs import frontend_programs, symbols_of

torch.set_num_threads(1)
TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-1, atol=2e-1)}
WRAPPERS = {"axpy": axpy.axpy, "matmul": matmul.matmul,
            "matvec": matvec.matvec, "stencil2d": stencil2d.stencil2d}


def rnd(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(arr, dtype):
    """The same values as a torch and a jax array of ``dtype``."""
    t = torch.from_numpy(arr).to(getattr(torch, dtype))
    return t, jnp.asarray(arr).astype(getattr(jnp, dtype))


def f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_axpy_matches_pallas(dtype):
    (tx, jx), (ty, jy) = both(rnd(512, 1), dtype), both(rnd(512, 2), dtype)
    got = axpy.axpy(2.5, tx, ty, block=128)
    want = jops.axpy(2.5, jx, jy, block=128)
    assert got.dtype == tx.dtype and got.shape == (512,)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(dtype):
    (ta, ja), (tb, jb) = (both(rnd((128, 512), 3, 0.3), dtype),
                          both(rnd((512, 128), 4, 0.3), dtype))
    got = matmul.matmul(ta, tb, bm=128, bn=128, bk=256)
    want = jops.matmul(ja, jb, bm=128, bn=128, bk=256)
    assert got.dtype == ta.dtype and got.shape == (128, 128)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


def test_matvec_matches_pallas():
    (ta, ja), (tx, jx) = both(rnd((512, 512), 5), "float32"), \
        both(rnd(512, 6), "float32")
    got = matvec.matvec(ta, tx, bm=256, bk=256)
    want = jops.matvec(ja, jx, bm=256, bk=256)
    np.testing.assert_allclose(f32(got), f32(want), **TOL["float32"])


@pytest.mark.parametrize("m,n,bm,bn", [(256, 256, 128, 128),
                                       (128, 384, 64, 128)])
def test_stencil_matches_jax_oracle(m, n, bm, bn):
    tu, ju = both(rnd((m, n), 7), "float32")
    got = stencil2d.stencil2d(tu, bm=bm, bn=bn)
    np.testing.assert_allclose(f32(got), f32(jref.stencil2d(ju)),
                               rtol=2e-5, atol=2e-5)
    got = stencil2d.stencil2d(tu, w_center=0.5, w_side=-0.25, bm=bm, bn=bn)
    np.testing.assert_allclose(f32(got), f32(jref.stencil2d(ju, 0.5, -0.25)),
                               rtol=2e-5, atol=2e-5)


def test_stencil_bf16_equals_jax_oracle():
    """In bfloat16 the plain version computes in u's dtype, rounding after
    every op, as the JAX oracle does: the two agree bit for bit."""
    a = rnd((128, 96), 9)
    tu = torch.from_numpy(a).to(torch.bfloat16)
    ju = jnp.asarray(a).astype(jnp.bfloat16)
    for w in ((-4.0, 1.0), (0.5, -0.25)):
        got = stencil2d.stencil2d(tu, w_center=w[0], w_side=w[1])
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(got), f32(jref.stencil2d(ju, *w)))


def test_oracles_keep_the_reference_dtype_rules():
    tb = torch.from_numpy(rnd((64, 32), 8)).to(torch.bfloat16)
    assert ref.matmul(tb, tb.T.contiguous()).dtype == torch.bfloat16
    assert ref.matvec(tb, tb[0]).dtype == torch.bfloat16
    assert ref.axpy(2.5, tb[0], tb[1]).dtype == torch.bfloat16
    # f32 axpy: the product rounds before the sum (no fused multiply-add)
    x, y = torch.tensor([1 + 2**-23], dtype=torch.float32), \
        torch.tensor([-1.0], dtype=torch.float32)
    a = 1 + 2**-23
    assert ref.axpy(a, x, y).item() == np.float32(np.float32(a) * x.item()) - 1


CASES = {"axpy": lambda: (2.5, torch.from_numpy(rnd(512, 1)),
                          torch.from_numpy(rnd(512, 2))),
         "matmul": lambda: (torch.from_numpy(rnd((128, 256), 3, 0.3)),
                            torch.from_numpy(rnd((256, 64), 4, 0.3))),
         "matvec": lambda: (torch.from_numpy(rnd((256, 128), 5)),
                            torch.from_numpy(rnd(128, 6))),
         "stencil2d": lambda: (torch.from_numpy(rnd((64, 96), 7)),)}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_registry_routes_simd_to_cuda_and_worksharing_to_reference(kernel):
    args = CASES[kernel]()
    assert ops.resolve(kernel, "cuda") is WRAPPERS[kernel]
    assert ops.resolve(kernel, "reference") is getattr(ref, kernel)
    assert ops.resolve(kernel) is getattr(ref, kernel)
    extent = args[1].shape[0] if kernel == "axpy" else args[0].shape[0]
    syms = symbols_of(kernel, args)
    before = WRAPPERS[kernel].launches
    outs = []
    for simd, backend in ((True, ops.SIMD), (False, ops.REFERENCE)):
        for prog in frontend_programs(kernel, syms, extent,
                                      simd=simd).values():
            fn = ops.lower_kernel_program(prog)
            assert fn is backend[kernel]
            outs.append(fn(*args))
    for out in outs[1:]:                 # CPU tensors: one plain version
        assert torch.equal(out, outs[0])
    assert WRAPPERS[kernel].launches == before   # no kernel ran on the CPU


@pytest.mark.parametrize("name", ["flash_attention", "ssm_scan", "nope"])
@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_unported_names_raise_key_error(name, backend):
    """Every kernel is ported: a name resolves where the reference registers
    it (``ssm_scan`` has no ``reference`` entry there) and raises a KeyError
    elsewhere, as in the reference."""
    registered = name != "nope" and not (name == "ssm_scan"
                                         and backend == "reference")
    if registered:
        assert ops.resolve(name, backend) is ops.BACKENDS[backend][name]
    else:
        with pytest.raises(KeyError, match="not registered"):
            ops.resolve(name, backend)


def test_lowering_refuses_programs_it_cannot_place():
    with pytest.raises(ValueError, match="backend"):
        ops.resolve("axpy", "pallas")
    seq = omp.target(omp.teams(num_teams=1), loop=omp.for_loop("i", 8),
                     kernel="axpy", args=("a", "x", "y"), name="axpy")
    with pytest.raises(ValueError, match="neither simd nor worksharing"):
        ops.lower_kernel_program(seq)
    unknown = omp.target(omp.teams(num_teams=1), omp.simd(),
                         loop=omp.for_loop("i", 8), kernel="nope",
                         name="nope")
    with pytest.raises(KeyError, match="not registered"):
        ops.lower_kernel_program(unknown)


# shapes that the reference's divisibility asserts refuse, per kernel
REFUSED = [
    ("axpy", lambda m: (2.5, m.zeros(384), m.zeros(384)), dict(block=256)),
    ("matmul", lambda m: (m.zeros((384, 128)), m.zeros((128, 128))),
     dict(bm=256, bn=128, bk=128)),
    ("matmul", lambda m: (m.zeros((128, 384)), m.zeros((384, 128))),
     dict(bm=128, bn=128, bk=256)),
    ("matvec", lambda m: (m.zeros((128, 768)), m.zeros(768)),
     dict(bm=128, bk=512)),
    ("stencil2d", lambda m: (m.zeros((384, 128)),), dict(bm=256, bn=128)),
]
JAX_FNS = {"axpy": jaxpy_mod.axpy, "matmul": jmatmul_mod.matmul,
           "matvec": jmatvec_mod.matvec, "stencil2d": jstencil_mod.stencil2d}


@pytest.mark.parametrize("kernel,make,tiles", REFUSED,
                         ids=[f"{k}-{i}" for i, (k, _, _) in
                              enumerate(REFUSED)])
def test_reference_divisibility_refusals_are_kept(kernel, make, tiles):
    with pytest.raises(AssertionError):
        JAX_FNS[kernel](*make(jnp), **tiles)
    with pytest.raises(ValueError, match="divide"):
        WRAPPERS[kernel](*make(torch), **tiles)


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_wrappers_never_fall_back_for_a_non_cpu_tensor(kernel):
    """A tensor off the CPU launches the kernel or raises: a meta tensor
    stands for one here, and the wrapper refuses it before any build."""
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in CASES[kernel]())
    with pytest.raises(ValueError, match="must be on"):
        WRAPPERS[kernel](*args)
