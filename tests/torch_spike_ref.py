"""Run the TPU spike kernels of tools/spike_*.py on the CPU, in Pallas
interpret mode, at a test's own small shapes and step counts, for the
tests that hold the card probes' plain versions (csc_tpu_torch.spikes) to
them.  No spike file is edited:

- a spike module is loaded from its file under a patched sys.argv, and
  handed a `pl` whose pallas_call adds interpret=True;
- its timers (`marginal`, `timeit`) are replaced by one that records the
  jitted function and its arguments, so a test calls the kernel once more
  on its own inputs;
- the spikes that measure when imported (spike_gather, spike_regops,
  spike_mxu_stage) are loaded from their function definitions alone
  (ast), leaving out the module-level loop; a `jax.jit` that records the
  function it wraps reaches the kernel inside `make`.
"""
import ast
import importlib.util
import os
import sys
import types

import jax
import numpy as np
from jax.experimental import pallas as real_pl

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


class _Pl(types.ModuleType):
    def __getattr__(self, k):
        return getattr(real_pl, k)


def _pallas_call(*a, **k):
    PL.LAST = (a, k)
    return real_pl.pallas_call(*a, interpret=True, **k)


PL = _Pl("pl")
PL.pallas_call = _pallas_call


def last_kernel():
    """The kernel of the last pallas_call a spike made, with its specs,
    in interpret mode: for a spike whose jitted wrapper passes its own
    arrays in place of its arguments."""
    a, k = PL.LAST
    return jax.jit(real_pl.pallas_call(*a, interpret=True, **k))


def final_state(*ins):
    """The last pallas_call a spike made, run in interpret mode on `ins`
    with its kernel wrapped to copy the final contents of every input ref
    (the state its DMAs and stores update in place) into extra outputs.
    Returns (its outputs, [each input's final contents])."""
    (kernel,), k = PL.LAST
    k = dict(k)
    single = not isinstance(k["out_shape"], (tuple, list))
    outs = [k["out_shape"]] if single else list(k["out_shape"])
    specs = [k["out_specs"]] if single else list(k["out_specs"])
    n_in, n_out = len(ins), len(outs)
    assert len(k["in_specs"]) == n_in, "inputs do not match the kernel's"

    def wrapped(*refs):
        kernel(*refs[:n_in + n_out], *refs[n_in + n_out + n_in:])
        for src, dst in zip(refs[:n_in], refs[n_in + n_out:]):
            dst[...] = src[...]

    k["out_shape"] = tuple(outs) + tuple(
        jax.ShapeDtypeStruct(np.shape(x), np.asarray(x).dtype) for x in ins)
    k["out_specs"] = tuple(specs) + tuple(k["in_specs"])
    res = jax.jit(real_pl.pallas_call(wrapped, interpret=True, **k))(*ins)
    return ([np.asarray(r) for r in res[:n_out]],
            [np.asarray(r) for r in res[n_out:]])


def assert_final_state(p, size, args, want, got):
    """Hold probe p's updated inputs (p.mutable) to the state the spike's
    kernel leaves in its refs.  `args` are the kernel's inputs (the
    probe's inputs last, in its order), `want` its first output as the
    spike returned it, `got` the plain version's {name: tensor}."""
    outs, final = final_state(*args)
    np.testing.assert_array_equal(outs[0], want)   # the same kernel
    final = final[len(args) - len(p.ins(size)):]
    for a, v in zip(p.ins(size), final):
        if a.name in p.mutable:
            np.testing.assert_array_equal(got[a.name].numpy(), v,
                                          err_msg=a.name)


class Recorder:
    """Stands in for a spike's timer: records the last (fn, args) and
    returns 1.0 as the time."""

    def __init__(self):
        self.fn = self.args = None

    def marginal(self, make_fn):
        self.fn, self.args = make_fn(self.steps)
        return 1.0

    def timeit(self, fn, *args, **k):
        self.fn, self.args = fn, args
        return 1.0

    def call(self, *args):
        r = self.fn(*args)
        return np.asarray(r[0] if isinstance(r, (tuple, list)) else r)


def load(name, argv=("spike",)):
    """tools/<name>.py as a module, its pallas_call in interpret mode and
    its timers recording (module.REC)."""
    old = sys.argv
    sys.argv = list(argv)
    try:
        spec = importlib.util.spec_from_file_location(
            f"_ref_{name}", os.path.join(TOOLS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = old
    rec = Recorder()
    mod.pl, mod.REC, mod.JITTED = PL, rec, []
    mod.jax = _JaxRecord(mod.JITTED)
    if hasattr(mod, "marginal"):
        mod.marginal = lambda make_fn, *a, **k: rec.marginal(make_fn)
    if hasattr(mod, "timeit"):
        mod.timeit = rec.timeit
    return mod


class _JaxRecord(types.ModuleType):
    """jax, with a jit that records each function it jits."""

    def __init__(self, sink):
        super().__init__("jax")
        self._sink = sink

    def __getattr__(self, k):
        return getattr(jax, k)

    def jit(self, fn):
        f = jax.jit(fn)
        self._sink.append(f)
        return f


class Captured(Exception):
    pass


class _Jax(types.ModuleType):
    """jax, with a jit that hands back the function it wraps (jitted) on
    the first call and stops the caller."""

    def __init__(self, sink):
        super().__init__("jax")
        self._sink = sink

    def __getattr__(self, k):
        return getattr(jax, k)

    def jit(self, fn):
        def stop(*a, **k):
            self._sink.append(jax.jit(fn))
            raise Captured
        return stop


def load_defs(name, **glob):
    """The imports and function definitions of tools/<name>.py, without
    its module-level statements, in a namespace with `glob` set (B, ...),
    `pl` in interpret mode and `jax.jit` capturing (namespace CAPTURED)."""
    path = os.path.join(TOOLS, f"{name}.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [n for n in tree.body
            if isinstance(n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    ns = {"__name__": f"_ref_{name}"}
    exec(compile(ast.Module(keep, []), path, "exec"), ns)
    captured = []
    ns.update(glob, pl=PL, jax=_Jax(captured), CAPTURED=captured)
    return ns


def capture(ns, make, *a):
    """Call ns[make](*a) until its first jitted call; return that jitted
    function."""
    ns["CAPTURED"].clear()
    try:
        ns[make](*a)
    except Captured:
        pass
    return ns["CAPTURED"][-1]


def capture_call(ns, fn, *args):
    """Call a function returned by a `make` (jitted by the capturing
    jit) once; return the jitted function it wraps."""
    ns["CAPTURED"].clear()
    try:
        fn(*args)
    except Captured:
        pass
    return ns["CAPTURED"][-1]


def host_lib(tmpdir):
    """csc_tpu_torch/csrc/spike_host.cpp (the probes' step code) built
    with g++ into tmpdir and loaded."""
    import ctypes
    import subprocess
    src = os.path.join(os.path.dirname(TOOLS), "csc_tpu_torch", "csrc",
                       "spike_host.cpp")
    so = os.path.join(str(tmpdir), "libspikehost.so")
    subprocess.run(["g++", "-O1", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", src, "-o", so], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.spike_host_run.restype = ctypes.c_int
    lib.spike_host_run.argtypes = [ctypes.c_char_p, i32, i32, p] + [p] * 8 \
        + [i64] * 6
    return lib


def host_run(lib, p, size, ins, steps):
    """Probe p through the g++ build of its step code (layout a, stream
    after stream) on numpy inputs; {name: array} like the plain version."""
    bufs = [ins[a.name].copy() for a in p.ins(size)]
    outs = [np.zeros(shape, dt) for _, shape, dt, _ in p.outs(size)]
    st = np.array([steps], np.int32)
    ptrs = [b.ctypes.data for b in bufs + outs]
    q = list(p.q(size))
    rc = lib.spike_host_run(p.file.encode(), p.kid(size), p.streams(size),
                            st.ctypes.data, *(ptrs + [None] * (8 - len(ptrs))),
                            *(q + [0] * (6 - len(q))))
    assert rc == 0, f"{p.key}: spike_host_run returned {rc}"
    res = {name: o for (name, *_), o in zip(p.outs(size), outs)}
    res.update({a.name: b for a, b in zip(p.ins(size), bufs)
                if a.name in p.mutable})
    return res
