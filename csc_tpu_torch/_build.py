"""Build the CUDA kernels with nvcc on first use and load them with ctypes.

The library is compiled from the sources in csrc/ into build/ at the root
of the checkout, under a name keyed by a hash of the sources and flags,
so a changed source builds anew and an unchanged one loads at once.  The
sources have a plain C interface (no PyTorch headers), which keeps a
build to seconds.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
K1_SOURCES = ["decode_k1.cu", "decode_k1.cuh"]

_lock = threading.Lock()
_k1 = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def build(sources, name):
    """Compile sources (names in csrc/, the first the .cu to compile) into
    build/lib<name>_<hash>.so unless it exists; return its path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp,
                                    os.path.join(CSRC, sources[0])]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}): {' '.join(cmd)}"
                           f"\n{r.stderr}")
    os.replace(tmp, so)
    return so


def k1_library():
    """The K1 decode library, built on first use."""
    global _k1
    with _lock:
        if _k1 is None:
            lib = ctypes.CDLL(build(K1_SOURCES, "csc_k1"))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.csc_k1_launch.restype = ctypes.c_int
            lib.csc_k1_launch.argtypes = [
                p, i64, p, i64, p, i32, p, i32, p, i64, i64, p, p, i32, i64,
                p, i32, p]
            _k1 = lib
        return _k1
