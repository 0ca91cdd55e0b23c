"""The port's frontends and unparser (copies of the JAX package's) give the
same UPIR as the JAX package's for every program that
``tests/test_upir_frontends.py`` builds: equal printer text and fingerprint,
and equal OpenMP / OpenACC unparsings. The paper kernels' programs
(``kernels/programs.py``) are equal across the three frontends (claim C1)
and print as the JAX package's OpenMP frontend prints them."""
import pytest
import torch

from repro.core import printer as jprinter
from repro.core import unparse as junparse
from repro.core.frontends import acc as jacc
from repro.core.frontends import cuda as jcuda
from repro.core.frontends import omp as jomp
from repro_torch.core import printer, unparse
from repro_torch.core.frontends import acc, cuda, omp
from repro_torch.kernels.programs import (SIMDLEN, UNITS, SIGNATURES,
                                          frontend_programs, symbols_of)

torch.set_num_threads(1)
SYMS = {"a": ((), "float32"), "x": ((65536,), "float32"),
        "y": ((65536,), "float32"), "n": ((), "int32")}


def axpy_omp(omp, teams=64):
    return omp.target(
        omp.teams(num_teams=teams, thread_limit=256),
        omp.distribute_parallel_for(),
        loop=omp.for_loop("i", "n"), kernel="axpy", args=("a", "x", "y"),
        map_to=("a", "x"), map_tofrom=("y",), symbols=SYMS, name="axpy")


def axpy_acc(acc):
    return acc.parallel_loop(
        "axpy", num_gangs=64, vector_length=256, gang=True, vector=True,
        copyin=("a", "x"), copy=("y",), loop=("i", "n"),
        kernel="axpy", args=("a", "x", "y"), symbols=SYMS)


def axpy_cuda(cuda, **kw):
    return cuda.launch(
        "axpy", kernel="axpy", grid=(64,), block=(256,), args=("a", "x", "y"),
        extent=("i", "n"), reads=("a", "x"), read_writes=("y",), symbols=SYMS,
        **kw)


def simd_omp(omp):
    return omp.target(
        omp.teams(num_teams=8, thread_limit=128), omp.simd(simdlen=128),
        loop=omp.for_loop("i", "n"), kernel="axpy", args=("a", "x", "y"),
        map_to=("a", "x"), map_tofrom=("y",), symbols=SYMS, name="axpy")


def simd_acc(acc):
    return acc.simd_level(
        acc.parallel_loop("axpy", num_gangs=8, vector_length=128,
                          copyin=("a", "x"), copy=("y",), loop=("i", "n"),
                          kernel="axpy", args=("a", "x", "y"), symbols=SYMS),
        simdlen=128)


# (name, builder over (omp, acc, cuda) modules)
PROGRAMS = [
    ("axpy_omp", lambda o, a, c: axpy_omp(o)),
    ("axpy_acc", lambda o, a, c: axpy_acc(a)),
    ("axpy_cuda", lambda o, a, c: axpy_cuda(c)),
    ("axpy_omp_32_teams", lambda o, a, c: axpy_omp(o, teams=32)),
    ("simd_omp", lambda o, a, c: simd_omp(o)),
    ("simd_acc", lambda o, a, c: simd_acc(a)),
    ("cuda_async_memcpy", lambda o, a, c: c.memcpy(
        axpy_cuda(c, stream_async=True), "x", "to", is_async=True)),
    ("omp_barrier_after", lambda o, a, c: o.barrier_after(axpy_omp(o))),
]


@pytest.mark.parametrize("name,build", PROGRAMS, ids=[p[0] for p in PROGRAMS])
def test_same_text_fingerprint_and_unparse(name, build):
    got = build(omp, acc, cuda)
    want = build(jomp, jacc, jcuda)
    assert printer.to_mlir(got) == jprinter.to_mlir(want)
    assert printer.program_fingerprint(got) == \
        jprinter.program_fingerprint(want)
    assert unparse.to_openmp(got) == junparse.to_openmp(want)
    assert unparse.to_openacc(got) == junparse.to_openacc(want)


def test_frontends_agree_inside_the_port():
    assert axpy_omp(omp) == axpy_acc(acc) == axpy_cuda(cuda)
    assert simd_omp(omp) == simd_acc(acc)
    assert axpy_omp(omp, teams=32) != axpy_omp(omp)
    assert "#pragma omp target" in unparse.to_openmp(axpy_cuda(cuda))


@pytest.mark.parametrize("kernel", sorted(SIGNATURES))
@pytest.mark.parametrize("simd", [False, True])
def test_paper_kernel_programs(kernel, simd):
    shapes = {"axpy": (2.5, torch.zeros(512), torch.zeros(512)),
              "matvec": (torch.zeros(512, 256), torch.zeros(256),
                         torch.zeros(512)),
              "stencil2d": (torch.zeros(128, 384), torch.zeros(128, 384)),
              "matmul": (torch.zeros(128, 512, dtype=torch.bfloat16),
                         torch.zeros(512, 128, dtype=torch.bfloat16),
                         torch.zeros(128, 128, dtype=torch.bfloat16))}
    syms = symbols_of(kernel, shapes[kernel])
    extent = 512 if kernel == "axpy" else shapes[kernel][0].shape[0]
    progs = frontend_programs(kernel, syms, extent, simd=simd)
    assert progs["omp"] == progs["acc"] == progs["cuda"]
    args, reads, writes, read_writes = SIGNATURES[kernel]
    teams = -(-extent // UNITS)
    want = jomp.target(
        jomp.teams(num_teams=teams, thread_limit=UNITS),
        jomp.distribute_parallel_for(),
        *((jomp.simd(simdlen=SIMDLEN),) if simd else ()),
        loop=jomp.for_loop("i", extent), kernel=kernel, args=args,
        map_to=reads, map_from=writes, map_tofrom=read_writes, symbols=syms,
        name=kernel)
    assert printer.to_mlir(progs["cuda"]) == jprinter.to_mlir(want)
    assert ("simd(simdlen(32))" in printer.to_mlir(progs["omp"])) == simd
