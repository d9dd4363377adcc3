"""The port stands alone and never falls back quietly.

- No module of ``sug_tpu_torch``, and not ``chip_smoke.py``, imports JAX,
  flax, orbax or ``sug_tpu``: checked by an AST scan of the sources and by
  importing every module in a fresh interpreter.
- Asking for ``cuda`` without a card raises at every entry point.
- The kernel build raises when ``nvcc`` is missing or fails, with the
  compiler's output.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's tests import both frameworks)
import pytest
import torch

from sug_tpu_torch import infer, resolve_device, train_dg_single_gpu
from sug_tpu_torch.engine.evaluation import Evaluator
from sug_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "sug_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "optax", "sug_tpu"}


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules + ['chip_smoke']!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    for device in ("cuda", None, torch.device("cuda:0")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(device)
    with pytest.raises(RuntimeError, match="is_available"):
        Evaluator(lambda d: d)
    with pytest.raises(RuntimeError, match="is_available"):
        infer.main(["--ckpt", "absent.pt", "--dg", "--pts", "absent.npy"])
    with pytest.raises(RuntimeError, match="is_available"):
        train_dg_single_gpu.main(["--source", "modelnet"])


def test_tf32_is_off():
    """Importing the package turns TF32 off, as the JAX package runs f32."""
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """cuda_build with nothing loaded, building into a scratch directory."""
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda"))
    return tmp_path


def test_every_source_and_header_names_the_library(monkeypatch, tmp_path):
    """The library's name hashes its source and the headers beside it, so an
    edit to either is rebuilt; every CUDA source of the package has a name."""
    sources = sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    assert sources == ["chamfer_min", "edgeconv_bwd", "edgeconv_fwd", "fps", "vecattn_bwd",
                       "vecattn_fwd"]
    assert [p.name for p in cuda_build.CSRC_DIR.glob("*.cuh")] == ["vecattn_tile.cuh"]
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = {n: cuda_build._library_path(n) for n in ("a", "b")}
    (tmp_path / "shared.cuh").write_text("// edited\n")
    after = {n: cuda_build._library_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"] and all(before[n] != after[n] for n in before)
    (tmp_path / "a.cu").write_text("// a.cu edited\n")
    assert cuda_build._library_path("a") != after["a"]
    assert cuda_build._library_path("b") == after["b"]


def test_missing_nvcc_raises(monkeypatch, fresh_build):
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "no-cuda"))
    monkeypatch.setenv("PATH", str(fresh_build / "empty-bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load("edgeconv_fwd")


def test_failed_build_raises_with_compiler_output(monkeypatch, fresh_build):
    bin_dir = fresh_build / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: a compiler refusal' >&2\nexit 2\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(fresh_build / "cuda"))
    with pytest.raises(RuntimeError, match=r"(?s)exit 2.*a compiler refusal"):
        cuda_build.build("edgeconv_fwd")
    assert not list((fresh_build / "build").glob("*.so"))
