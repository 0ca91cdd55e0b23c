"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``; its entry points
never fall back to the CPU on their own; and the CPU-only attention path is
refused for tensors on a card."""
import ast
from pathlib import Path

import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import api
from repro_torch.models.transformer import KernelSpec
from repro_torch.runtime.engine import Engine, EngineConfig, serve_sequential

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]
CFG = smoke_config("tinyllama-1.1b")


def imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    roots = {m.split(".")[0] for m in imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_has_the_modules_of_its_slice():
    names = {str(p.relative_to(REPO / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]}
    for want in ("configs/base.py", "configs/registry.py", "core/ir.py",
                 "core/plans.py", "core/lower.py", "models/layers.py",
                 "models/transformer.py", "models/api.py",
                 "kernels/paged_attention.py", "runtime/sampling.py",
                 "runtime/scheduling.py", "runtime/server.py",
                 "runtime/engine.py", "launch/serve.py", "convert.py",
                 "runtime/prng.py", "core/frontends/__init__.py",
                 "core/frontends/omp.py", "core/frontends/acc.py",
                 "core/frontends/cuda.py", "core/unparse.py",
                 "kernels/ref.py", "kernels/axpy.py", "kernels/matvec.py",
                 "kernels/stencil2d.py", "kernels/matmul.py",
                 "kernels/ops.py", "kernels/programs.py",
                 "kernels/flash_attention.py", "kernels/ssm_scan.py",
                 "models/mamba2.py"):
        assert want in names
    for cu in ("paged_attention", "axpy", "matvec", "stencil2d", "matmul",
               "flash_attention", "ssm_scan"):
        assert (REPO / f"src/repro_torch/kernels/csrc/{cu}.cu").exists()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")


def test_entry_points_default_to_the_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_params(CFG)
    params = api.init_params(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sequential(CFG, params, [], max_seq=16)


def test_torch_attention_refuses_cuda_tensors():
    if not torch.cuda.is_available():
        # a meta tensor stands for a non-CPU tensor without a card
        tokens = torch.zeros((1, 1), dtype=torch.int64, device="meta")
    else:
        tokens = torch.zeros((1, 1), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError, match="CPU"):
        api.decode_step_paged(CFG, {}, {}, tokens, {"tokens": tokens,
                                                    "pos": tokens[:, 0]},
                              kernel=KernelSpec("torch"))
    with pytest.raises(ValueError, match="CPU"):
        Engine(CFG, EngineConfig(decode_kernel="torch"),
               device="cuda" if torch.cuda.is_available() else "meta")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    assert build.sources() == ["axpy", "flash_attention", "matmul", "matvec",
                               "paged_attention", "ssm_scan", "stencil2d"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build, "Path", lambda *_: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
    assert not (tmp_path / "kernels").exists()


def test_kernel_spec_validates():
    with pytest.raises(ValueError):
        KernelSpec("pallas")
