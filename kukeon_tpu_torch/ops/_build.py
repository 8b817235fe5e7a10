"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each source under ``kukeon_tpu_torch/csrc/`` (``SOURCES``) compiles with
``nvcc`` into its own shared library under ``kukeon_tpu_torch/_build/`` at
first use. The file name carries a hash of the source and the flags, so a
changed source rebuilds and an unchanged one loads what is there.
:func:`build_all` starts one ``nvcc`` per source at once. Nothing is built
when a module is imported: hosts without ``nvcc`` (the CPU test hosts)
import every module and only fail if a kernel is actually asked for.

Run ``python -m kukeon_tpu_torch.ops._build`` to build every library and
print ``ptxas`` register and shared-memory use.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
INT8_MATMUL = "int8_matmul.cu"
FLASH_ATTENTION = "flash_attention.cu"
SOURCES = (INT8_MATMUL, FLASH_ATTENTION)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "CUDA kernels are built from source on the GPU host")
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(source: str) -> tuple[Path, str, float]:
    """Compile one source if its library is missing: (path, nvcc log,
    seconds spent compiling, 0.0 when the library already existed)."""
    out = library_path(source)
    if out.exists():
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    # Compile to a private name, then rename: a reader never sees a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr, time.monotonic() - t0


def build_all() -> dict[str, tuple[Path, str, float]]:
    """Build every source, one ``nvcc`` each, all started together:
    {source: (path, nvcc log, seconds)}."""
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        futures = {src: pool.submit(build, src) for src in SOURCES}
        return {src: f.result() for src, f in futures.items()}


@functools.cache
def load_int8_matmul() -> ctypes.CDLL:
    """The loaded int8_matmul library, built first if needed."""
    path, _log, _secs = build(INT8_MATMUL)
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    # h, q, s, out, ws, B, K, N, ks, transpose, is_bf16, stream
    lib.kukeon_int8_matmul.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.kukeon_int8_matmul.restype = ctypes.c_int
    # h, q, s, out, B, K, N, ks, stream
    lib.kukeon_int8_matmul_bf16.argtypes = [P, P, P, P, I, I, I, I, P]
    lib.kukeon_int8_matmul_bf16.restype = ctypes.c_int
    # x, q, s, out, ws, E, C, K, N, ks, is_bf16, stream
    lib.kukeon_int8_matmul_expert.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
    lib.kukeon_int8_matmul_expert.restype = ctypes.c_int
    return lib


@functools.cache
def load_flash_attention() -> ctypes.CDLL:
    """The loaded flash_attention library, built first if needed."""
    path, _log, _secs = build(FLASH_ATTENTION)
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    # q, k, v, o, q_pos, kv_pos, tile min/max workspace, kv-tile list
    # workspace and its length, B, S, H, KV, D, strides (12 x int64),
    # is_bf16, stream
    L = ctypes.POINTER(ctypes.c_longlong)
    lib.kukeon_flash_attention.argtypes = [P, P, P, P, P, P, P, P, ctypes.c_longlong,
                                           I, I, I, I, I, L, I, P]
    lib.kukeon_flash_attention.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    for src, (path, log, secs) in build_all().items():
        print(f"{src} -> {path} ({secs:.1f} s)\n{log}")
