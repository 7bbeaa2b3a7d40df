"""Build the native code on first use and load it with ctypes.

The CUDA kernels are compiled with nvcc from the sources in csrc/ into
build/ at the root of the checkout, under a name keyed by a hash of the
sources and flags, so a changed source builds anew and an unchanged one
loads at once.  The sources have a plain C interface (no PyTorch
headers), which keeps a build to seconds.  `build_kernels` starts one
nvcc per kernel, all at once.  The host runtime (csrc/csc_host.cpp: the
content filters and the block analyzer) is compiled the same way with
g++.  A failed build raises: nothing falls back to another path.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
# kernel name -> sources (the first is the .cu that nvcc compiles)
KERNELS = {
    "csc_k1": ["decode_k1.cu", "decode_k1.cuh"],
    "csc_k2": ["encode_k2.cu", "encode_k2.cuh"],
    "csc_k3": ["encode_k3.cu", "encode_k3.cuh"],
}
# the spike probes (csc_tpu_torch/spikes): one library per spike file
SPIKE_FILES = ("carry", "dma", "gather", "marginal", "mxu_stage", "pallas",
               "pallas2", "pallas3", "regops", "roofline")
KERNELS.update({f"spike_{f}": [f"spike_{f}.cu", "spike_common.cuh"]
                for f in SPIKE_FILES})

_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_ARGTYPES = {
    "csc_k1": ("csc_k1_launch", [_p, _i64, _p, _i64, _p, _i32, _p, _i32, _p,
                                 _i64, _i64, _p, _p, _i32, _i64, _p, _i32,
                                 _p]),
    "csc_k2": ("csc_k2_launch", [_p, _p, _i64, _i32, _p, _p, _i32, _p, _p,
                                 _i32, _p, _i64, _p, _i32, _p]),
    "csc_k3": ("csc_k3_launch", [_p, _p, _p, _p, _i64, _p, _i64, _p, _i64,
                                 _p, _p, _i32, _p, _i32, _i64, _p, _p, _i32,
                                 _p]),
}
_ARGTYPES.update({f"spike_{f}": (f"spike_{f}_launch",
                                 [_i32, _i32, _i32] + [_p] * 9 + [_i64] * 6
                                 + [_p]) for f in SPIKE_FILES})

_lock = threading.Lock()
_libs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit to build")
    return path


def _target(sources, name, flags):
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _start(compiler, flags, sources, so):
    """Start one compile of csrc/<sources[0]> into `so`; returns
    (process, tmp path, command)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [compiler] + flags + ["-o", tmp, os.path.join(CSRC, sources[0])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, cmd


def _finish(job, so):
    proc, tmp, cmd = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{err}")
    with open(so + ".log", "w") as f:   # the compiler's report (ptxas -v)
        f.write(err)
    os.replace(tmp, so)


def build_log(name):
    """What the compiler said when it built the CUDA kernel `name` (with
    ptxas -v: each kernel's registers, shared memory and spills)."""
    path = _target(KERNELS[name], name, NVCC_FLAGS) + ".log"
    if not os.path.exists(path):
        raise RuntimeError(f"no build report of {name} ({path}): build it "
                           f"with build_kernels() first")
    with open(path) as f:
        return f.read()


def build(sources, name, compiler=None, flags=NVCC_FLAGS):
    """Compile sources (names in csrc/, the first the file to compile)
    into build/lib<name>_<hash>.so unless it exists; return its path."""
    so = _target(sources, name, flags)
    if not os.path.exists(so):
        _finish(_start(compiler or _nvcc(), flags, sources, so), so)
    return so


def build_kernels(names=tuple(KERNELS)):
    """Build the named CUDA kernels that are not built yet, one nvcc per
    kernel, all started together.  Returns {name: .so path}."""
    paths = {n: _target(KERNELS[n], n, NVCC_FLAGS) for n in names}
    jobs = {n: _start(_nvcc(), NVCC_FLAGS, KERNELS[n], so)
            for n, so in paths.items() if not os.path.exists(so)}
    errors = []
    for n, job in jobs.items():
        try:
            _finish(job, paths[n])
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def kernel_library(name):
    """The ctypes library of one kernel ("csc_k1", "csc_k2", "csc_k3",
    "spike_<file>"), built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(KERNELS[name], name))
            fn_name, argtypes = _ARGTYPES[name]
            fn = getattr(lib, fn_name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            if name.startswith("spike_"):
                smem = getattr(lib, f"{name}_smem")
                smem.restype = ctypes.c_int64
                smem.argtypes = [_i32, _i32, _i32] + [_i64] * 6
            _libs[name] = lib
        return lib


def host_library():
    """The host runtime (csrc/csc_host.cpp) built with g++, on first
    use."""
    with _lock:
        lib = _libs.get("csc_host")
        if lib is None:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the host runtime "
                                   "(csrc/csc_host.cpp) needs it to build")
            lib = ctypes.CDLL(build(["csc_host.cpp"], "csc_host", gxx,
                                    GXX_FLAGS))
            _libs["csc_host"] = lib
        return lib
