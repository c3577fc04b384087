"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by hand
with ``nvcc`` into ``build/torch_kernels/lib<name>_<hash>.so`` at the root
of the checkout, at first use, and loaded with ``ctypes``.  The hash covers
the source and the flags, so an edited source builds anew and an unchanged
one is reused.  Nothing is built or loaded when the package is imported.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load", "CSRC", "BUILD_DIR"]

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# no --use_fast_math: it makes '/' approximate, and the kernels' numerics
# are pinned to IEEE division; -Xptxas -v reports registers and spills
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def build(name):
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.

    Returns ``(path, info)``: ``info`` holds the build's seconds and the
    compiler's resource report, or ``None`` when the library was reused.
    Raises ``RuntimeError`` with the compiler's output if ``nvcc`` fails.
    """
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}_{digest[:16]}.so"
    if lib.exists():
        return lib, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, {"seconds": time.perf_counter() - t0,
                 "ptxas": [ln.strip() for ln in proc.stderr.splitlines()
                           if "ptxas info" in ln]}


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path, _ = build(name)
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib
