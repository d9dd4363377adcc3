"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with ``nvcc``
for ``sm_90a`` into ``build/sug_tpu_torch/lib<name>-<hash>.so`` at the root of
the checkout (``build/`` is git-ignored); the hash of the source, of the
headers beside it (``csrc/*.cuh``) and of the flags names the library, so an
edited source is rebuilt. A missing ``nvcc`` or a failed
build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "sug_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


@dataclass
class Built:
    """A loaded library, with its build's seconds and the compiler's output
    (empty when an up-to-date library was found on disk)."""

    lib: ctypes.CDLL
    path: Path
    seconds: float
    log: str


_LOADED: Dict[str, Built] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the default
    toolkit's; raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): the CUDA kernels cannot be built"
    )


def _library_path(name: str) -> Path:
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Built:
    """Build ``csrc/<name>.cu`` unless an up-to-date library is on disk, load
    it, and keep it loaded."""
    if name not in _LOADED:
        out = _library_path(name)
        seconds, log = 0.0, ""
        if not out.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
            seconds, log = time.perf_counter() - t0, proc.stdout
            if proc.returncode != 0:
                raise RuntimeError(
                    f"building {name}.cu failed (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{log}"
                )
            os.replace(tmp, out)
        _LOADED[name] = Built(ctypes.CDLL(str(out)), out, seconds, log)
    return _LOADED[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    return build(name).lib


def library(name: str, error_string: str, n_ptrs: int, n_ints: int,
            launcher: Optional[str] = None) -> ctypes.CDLL:
    """``load(name)`` with the argument types of its launcher (``launcher``,
    or ``name`` where the source has one: the pointers, then the ints, then
    the stream; returns a ``cudaError_t``) and of ``error_string``
    (``cudaGetErrorString``) declared."""
    lib = load(name)
    fn = getattr(lib, launcher or name)
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: an undeclared pointer
        # argument would be passed as a 32-bit int and cut
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_fn = getattr(lib, error_string)
        err_fn.argtypes = [ctypes.c_int]
        err_fn.restype = ctypes.c_char_p
    return lib
