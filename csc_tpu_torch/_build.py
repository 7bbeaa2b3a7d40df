"""Build the native code on first use and load it with ctypes.

The CUDA kernels are compiled with nvcc from the sources in csrc/ into
build/ at the root of the checkout, under a name keyed by a hash of the
sources and flags, so a changed source builds anew and an unchanged one
loads at once.  The sources have a plain C interface (no PyTorch
headers), which keeps a build to seconds.  `build_kernels` starts one
nvcc per kernel, all at once; a file in PARTS is compiled in parts, one
nvcc a part, and linked.  The host runtime (csrc/csc_host.cpp: the
content filters and the block analyzer) is compiled the same way with
g++.  A failed build raises: nothing falls back to another path.
"""
import contextlib
import ctypes
import hashlib
import os
import re
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
    "csc_k4": ["encode_k4.cu", "encode_k4.cuh"],
    "csc_k5": ["encode_k5.cu", "encode_k5.cuh"],
    "csc_k6": ["encode_k6.cu", "encode_k6.cuh", "encode_k5.cuh"],
}
# files compiled in parts: file -> (macro, parts), part i compiled with
# -D<macro>=i (where the file names the macro; an older checkout's file
# is one part)
PARTS = {"encode_k6.cu": ("K6_PART", 5)}
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
    "csc_k4": ("csc_k4_launch", [_p, _p, _i64, _i32, _p, _p, _i32, _p, _p,
                                 _i32, _p, _p, _i64, _i64, _p, _p, _i32,
                                 _p]),
    "csc_k5": ("csc_k5_launch", [_p, _i64, _p, _i32, _p, _p, _i32, _i32,
                                 _i32, _i32, _p, _p, _p, _p, _i64, _i64, _p,
                                 _p, _i32, _p]),
    "csc_k6": ("csc_k6_launch", [_p, _i64, _p, _i32, _p, _p, _i32, _i32,
                                 _i32, _p, _p, _p, _p, _p, _p, _p, _i64, _p,
                                 _p, _i32, _p]),
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


def _target(sources, name, flags, csrc=CSRC):
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(csrc, src), "rb") as f:
            h.update(src.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _parts(src):
    """The macro and count of parts <src> is compiled in (None: one)."""
    part = PARTS.get(os.path.basename(src))
    if part is not None:
        with open(src) as f:
            if part[0] not in f.read():
                part = None
    return part


def _start(compiler, flags, sources, so, csrc=CSRC):
    """Start the compile of <csrc>/<sources[0]> into `so`, one process or
    one a part (PARTS); returns (processes, commands, link command, tmp
    path)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    src = os.path.join(csrc, sources[0])
    part = _parts(src)
    if part is None:
        cmds, link = [[compiler] + flags + ["-o", tmp, src]], None
    else:
        objs = [f"{tmp}.{i}.o" for i in range(part[1])]
        base = [f for f in flags if f != "-shared"] + ["-c"]
        cmds = [[compiler] + base + [f"-D{part[0]}={i}", "-o", o, src]
                for i, o in enumerate(objs)]
        link = [compiler, "-shared", "-o", tmp] + objs
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    return procs, cmds, link, tmp


def _finish(job, so):
    procs, cmds, link, tmp = job
    errs, failed = [], []
    for proc, cmd in zip(procs, cmds):
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"build failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if not failed and link is not None:
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"link failed ({res.returncode}): "
                          f"{' '.join(link)}\n{res.stderr}")
    if link is not None:
        for obj in link[4:]:
            with contextlib.suppress(FileNotFoundError):
                os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    with open(so + ".log", "w") as f:   # the compiler's report (ptxas -v)
        f.write("".join(errs))
    os.replace(tmp, so)


def build_log(name, csrc=CSRC):
    """What the compiler said when it built the CUDA kernel `name` (with
    ptxas -v: each kernel's registers, shared memory and spills)."""
    path = _target(KERNELS[name], name, NVCC_FLAGS, csrc) + ".log"
    if not os.path.exists(path):
        raise RuntimeError(f"no build report of {name} ({path}): build it "
                           f"with build_kernels() first")
    with open(path) as f:
        return f.read()


def sass(name, csrc=CSRC):
    """The SASS of the built CUDA kernel `name`, as `cuobjdump -sass`
    (beside nvcc) prints it; raises if it cannot be read."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    so = _target(KERNELS[name], name, NVCC_FLAGS, csrc)
    res = subprocess.run([tool, "-sass", so], capture_output=True,
                         text=True)
    if res.returncode != 0 or "Function" not in res.stdout:
        raise RuntimeError(f"cuobjdump -sass {so} failed "
                           f"({res.returncode}): {res.stderr[-2000:]}")
    return res.stdout


def _entry_name(mangled):
    """A kernel's name from its mangled one, a bool template argument
    shown: _Z15k5_parse_kernelILb1EEv... -> k5_parse_kernel<1>."""
    m = re.match(r"_Z(\d+)", mangled)
    if m is None:
        return mangled
    n = int(m.group(1))
    name = mangled[m.end():m.end() + n]
    args = re.match(r"I((?:Lb[01]E)+)E", mangled[m.end() + n:])
    if args:
        name += "<" + ",".join(re.findall(r"Lb([01])E", args.group(1))) + ">"
    return name


def resources(name, csrc=CSRC):
    """What the build of the CUDA kernel `name` says of its kernels:
    registers, stack frame and spill bytes (ptxas -v; the most over its
    entry functions, and `registers_<entry>` for each where it has more
    than one), and the count of local-memory loads and stores (LDL / STL)
    in its SASS."""
    log = build_log(name, csrc)
    entries = []
    for part in log.split("Compiling entry function '")[1:] or [log]:
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", part)
        if regs is None or frame is None:
            raise RuntimeError(f"the build report of {name} names no "
                               f"register count or stack frame for "
                               f"{part.split(chr(39))[0]}")
        entries.append((_entry_name(part.split("'")[0]), int(regs.group(1)),
                        *(int(g) for g in frame.groups())))
    code = sass(name, csrc)
    res = {"registers": max(e[1] for e in entries),
           "stack_frame": max(e[2] for e in entries),
           "spill_stores": max(e[3] for e in entries),
           "spill_loads": max(e[4] for e in entries),
           "ldl": len(re.findall(r"\bLDL\b", code)),
           "stl": len(re.findall(r"\bSTL\b", code))}
    if len(entries) > 1:
        res.update({f"registers_{e[0]}": e[1] for e in entries})
    return res


def build(sources, name, compiler=None, flags=NVCC_FLAGS, csrc=CSRC):
    """Compile sources (names in csrc/, the first the file to compile;
    `csrc`: another checkout's sources) into build/lib<name>_<hash>.so
    unless it exists; return its path."""
    so = _target(sources, name, flags, csrc)
    if not os.path.exists(so):
        _finish(_start(compiler or _nvcc(), flags, sources, so, csrc), so)
    return so


def build_kernels(names=tuple(KERNELS), csrc=CSRC):
    """Build the named CUDA kernels that are not built yet, one nvcc per
    kernel, all started together; `csrc`: another checkout's sources.
    Returns {name: .so path}."""
    paths = {n: _target(KERNELS[n], n, NVCC_FLAGS, csrc) for n in names}
    jobs = {n: _start(_nvcc(), NVCC_FLAGS, KERNELS[n], so, csrc)
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


def load(name, csrc=CSRC):
    """The ctypes library of kernel `name` built from the sources in
    `csrc` (by build_kernels)."""
    lib = ctypes.CDLL(_target(KERNELS[name], name, NVCC_FLAGS, csrc))
    fn_name, argtypes = _ARGTYPES[name]
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib


def kernel_library(name):
    """The ctypes library of one kernel ("csc_k1" .. "csc_k6",
    "spike_<file>"), built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(KERNELS[name], name)
            lib = load(name)
            if name.startswith("spike_"):
                smem = getattr(lib, f"{name}_smem")
                smem.restype = ctypes.c_int64
                smem.argtypes = [_i32, _i32, _i32] + [_i64] * 6
            _libs[name] = lib
        return lib


@contextlib.contextmanager
def swapped(name, lib):
    """Within the block, the wrappers of kernel `name` launch `lib` (a
    library from `load`, for example another checkout's build)."""
    saved = kernel_library(name)
    _libs[name] = lib
    try:
        yield
    finally:
        _libs[name] = saved


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
