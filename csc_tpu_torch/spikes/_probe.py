"""What every spike probe shares: the Probe record, the wrapper that
launches a probe's CUDA kernel (csrc/spike_<file>.cu) or, for CPU tensors,
runs its plain PyTorch version, the marginal timer, and the bound.

A probe answers one pl.pallas_call site of tools/spike_<file>.py on the
card: the same inputs, step rule, step count and output, in one of two
layouts ("a": one stream per block, one thread, as K1-K3 run; "b": one
stream per thread, 128 streams to a block).  LAUNCHES counts kernel
launches by spike file.
"""
import dataclasses
import re
from typing import Callable, Optional

import numpy as np
import torch

LAYOUTS = {"a": 0, "b": 1}
PACK = 128                  # streams per block in layout b
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (NVIDIA data sheet)
OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 peak; int32 is no faster
FILES = ("carry", "dma", "gather", "marginal", "mxu_stage", "pallas",
         "pallas2", "pallas3", "regops", "roofline")
LAUNCHES = {f: 0 for f in FILES}

_DT = {np.int32: torch.int32, np.uint8: torch.uint8,
       np.uint16: torch.uint16, np.float32: torch.float32}


@dataclasses.dataclass
class Arg:
    """One input: its shape, dtype, the spike's own values (a function of
    nothing) and, for tests, a seeded random fill in [lo, hi)."""
    name: str
    shape: tuple
    dtype: type
    spike: Callable
    lo: int = 0
    hi: int = 256
    rand: Optional[Callable] = None   # rng -> array, in place of lo / hi

    def make(self, rng=None):
        if rng is None:
            v = self.spike()
        elif self.rand is not None:
            v = self.rand(rng)
        else:
            v = rng.integers(self.lo, self.hi, self.shape)
        return np.ascontiguousarray(
            np.broadcast_to(v, self.shape).astype(self.dtype))


@dataclasses.dataclass
class Probe:
    """One spike site on the card.

    ins(size) -> [Arg]; outs(size) -> [(name, shape, np dtype, zeroed)],
    the spike's own output first; `mutable` names the inputs the probe
    updates and returns after the outputs.  plain(size, steps, **inputs)
    -> {name: tensor}.  cost(size) -> (bytes, ops) of one step.  q(size)
    -> the kernel's int parameters; streams(size) -> its stream count.
    """
    name: str
    file: str
    kid: Callable
    site: str
    size: dict
    small: dict
    ins: Callable
    outs: Callable
    plain: Callable
    q: Callable
    streams: Callable
    steps: tuple
    cost: Callable
    mutable: tuple = ()
    per: int = 1            # ops a step holds, for ns per op
    unit: str = "op"        # what `per` counts
    library: Optional[Callable] = None   # (size, inputs) -> one torch call
    sizes: tuple = ()       # more (label, size, steps) the runner times
    racy: tuple = ()        # outputs that hang on the order of the streams

    @property
    def key(self):
        return f"{self.file}.{self.name}"


def _check(p, size, inputs):
    dev = None
    for a in p.ins(size):
        t = inputs.get(a.name)
        if t is None:
            raise ValueError(f"{p.key}: input {a.name} missing")
        if t.dtype != _DT[a.dtype] or tuple(t.shape) != tuple(a.shape):
            raise ValueError(f"{p.key}: {a.name} must be {a.dtype.__name__} "
                             f"{tuple(a.shape)}, not {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{p.key}: {a.name} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{p.key}: inputs on {dev} and {t.device}")
        dev = t.device
    return dev


def _launch(p, size, bufs, steps_t, layout):
    """One raw launch on prepared device buffers (inputs, then outputs);
    the state buffers are updated in place."""
    from .. import _build
    lib = _build.kernel_library(f"spike_{p.file}")
    ptrs = [b.data_ptr() for b in bufs] + [0] * (8 - len(bufs))
    q = list(p.q(size)) + [0] * (6 - len(p.q(size)))
    with torch.cuda.device(steps_t.device):
        stream = torch.cuda.current_stream(steps_t.device).cuda_stream
        rc = getattr(lib, f"spike_{p.file}_launch")(
            p.kid(size), LAYOUTS[layout], p.streams(size),
            steps_t.data_ptr(), *ptrs, *q, stream)
    if rc != 0:
        raise RuntimeError(f"{p.key} launch failed: cudaError_t {rc}")
    LAUNCHES[p.file] += 1


def _outputs(p, size, dev):
    return [(torch.zeros if zero else torch.empty)(
        shape, dtype=_DT[dt], device=dev)
        for _, shape, dt, zero in p.outs(size)]


def run(p, inputs, steps, layout="a", size=None):
    """The probe over `steps` steps on {name: tensor} inputs; returns
    {name: tensor}: its outputs, then the updated copies of its mutable
    inputs.  CPU tensors take the plain version; CUDA tensors launch the
    kernel in `layout`; any other device raises."""
    size = p.size if size is None else size
    dev = _check(p, size, inputs)
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be 'a' or 'b', not {layout!r}")
    if dev.type == "cpu":
        return p.plain(size, steps, **inputs)
    if dev.type != "cuda":
        raise ValueError(f"{p.key} runs on CUDA tensors (or the plain "
                         f"version on CPU ones), not on {dev}")
    bufs = [inputs[a.name].clone() if a.name in p.mutable
            else inputs[a.name] for a in p.ins(size)]
    outs = _outputs(p, size, dev)
    steps_t = torch.tensor([steps], dtype=torch.int32, device=dev)
    _launch(p, size, bufs + outs, steps_t, layout)
    res = {name: t for (name, *_), t in zip(p.outs(size), outs)}
    res.update({a.name: b for a, b in zip(p.ins(size), bufs)
                if a.name in p.mutable})
    return res


def inputs(p, size=None, rng=None, device="cpu"):
    """The probe's inputs as tensors: the spike's own values, or a seeded
    random fill when rng is a numpy Generator."""
    size = p.size if size is None else size
    return {a.name: torch.from_numpy(a.make(rng)).to(device)
            for a in p.ins(size)}


def _hold():
    """Keep the stream busy (about 0.1 ms) while the host queues the next
    event and launch, so that an event pair times the kernel alone and
    not the host's launch latency."""
    torch.cuda._sleep(200_000)


def marginal_ns(p, layout, dev, size=None, steps=None, reps=3):
    """Device ns per step, as the spikes time it: (T(n_big) - T(n_small))
    / (n_big - n_small) with the spike's own step counts, each T the
    minimum of `reps` single launches timed with CUDA events after a
    warm-up.  A probe whose spike has no step loop (steps == (1, 1))
    gives ns per call, the kernel alone (see _hold)."""
    size = p.size if size is None else size
    ins = inputs(p, size, device=dev)
    bufs = [ins[a.name] for a in p.ins(size)] + _outputs(p, size, dev)

    def once(n):
        steps_t = torch.tensor([n], dtype=torch.int32, device=dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        _hold()
        e0.record()
        _launch(p, size, bufs, steps_t, layout)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    n_small, n_big = steps or p.steps
    once(n_small)
    once(n_big)
    t1 = min(once(n_small) for _ in range(reps))
    if n_big == n_small:
        return t1 * 1e6
    t2 = min(once(n_big) for _ in range(reps))
    return (t2 - t1) / (n_big - n_small) * 1e6


def plain_marginal_ns(p, dev, size=None, n=(2, 6)):
    """Device ns per step of the plain version on `dev` tensors, between
    two small step counts (the plain version runs one step per Python
    iteration)."""
    size = p.size if size is None else size
    ins = inputs(p, size, device=dev)

    def once(k):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        p.plain(size, k, **ins)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    if p.steps[0] == p.steps[1]:
        once(1)
        return min(once(1) for _ in range(2)) * 1e6
    once(n[0])
    t1 = min(once(n[0]) for _ in range(2))
    t2 = min(once(n[1]) for _ in range(2))
    return max(t2 - t1, 0.0) / (n[1] - n[0]) * 1e6


def library_ns(p, dev, size=None, reps=20):
    """Device ns of the one PyTorch call that computes the probe's step
    (p.library), median of `reps`; None where there is none."""
    if p.library is None:
        return None
    size = p.size if size is None else size
    fn = p.library(size, inputs(p, size, device=dev))
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        _hold()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)) * 1e6


def bound_ns(p, size=None):
    """Least ns a step could take on the card: its bytes (each input
    byte read once, each output byte written once) over the memory rate
    or its operations over the peak rate, the larger; and which."""
    nbytes, ops = p.cost(p.size if size is None else size)
    tb, to = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (tb * 1e9, "bytes") if tb >= to else (to * 1e9, "operations")


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_KID = re.compile(r"Li(\d+)E+v")
_REGS = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas(text):
    """{probe id: (registers, spill-store bytes, spill-load bytes)} from
    nvcc -Xptxas -v output of one spike file."""
    out, kid, spill = {}, None, (0, 0)
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            ks = _KID.findall(m.group(1))
            kid = int(ks[-1]) if ks else None
            spill = (0, 0)
            continue
        m = _SPILL.search(line)
        if m and kid is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = _REGS.search(line)
        if m and kid is not None:
            out[kid] = (int(m.group(1)),) + spill
            kid = None
    return out


# ----------------------------------------------------- shared plain steps
def rows(b, dev):
    return torch.arange(b, device=dev)


def i32(t):
    return t.to(torch.int32)


def adapt(p):
    """The bit model's update after bit p & 1 (int32 tensors)."""
    return torch.where((p & 1) == 1, p + ((4095 - p) >> 5), p - (p >> 5))


def bitstep_plain(pidx, tbl, steps, reps=1, acc_last=False):
    """m1 / m1b / onehot_step_cost / p8 / r3: p = tbl[pidx]; adapt it in
    place; acc += p (only the last of `reps` when acc_last); pidx =
    (pidx * 5 + 1 + bit) % NP.  Returns (acc [B], tbl)."""
    b, np_ = tbl.shape
    dt = tbl.dtype
    t = i32(tbl).clone()
    r = rows(b, tbl.device)
    pi = i32(pidx).reshape(b).clone()
    acc = torch.zeros(b, dtype=torch.int32, device=tbl.device)
    for _ in range(steps):
        for _ in range(reps):
            p = t[r, pi]
            t[r, pi] = adapt(p)
            if not acc_last:
                acc += p
            pi = (pi * 5 + 1 + (p & 1)) % np_
        if acc_last:
            acc += p
    return acc, t.to(dt)


def wndread_plain(pos, wnd, steps):
    """m2 / m8 / p7 / s7 / w3: acc += wnd[pos]; pos = (pos * 5 + 3) % W."""
    b, w = wnd.shape
    r = rows(b, wnd.device)
    po = i32(pos).reshape(b).clone()
    acc = torch.zeros(b, dtype=torch.int32, device=wnd.device)
    for _ in range(steps):
        acc += i32(wnd[r, po])
        po = (po * 5 + 3) % w
    return acc


def chain_plain(x, steps, reps=1):
    """m6 / m6b / transition_cost: 300 chained select / arith ops."""
    a = i32(x).reshape(-1).clone()
    b, c = a + 1, a + 2
    for _ in range(steps * reps):
        for _ in range(300 // 6):
            m = a > b
            a = torch.where(m, a + 1, a - c)
            b = torch.where(m, b * 2 + 1, b)
            c = torch.where((c & 3) == 1, c + a, c + 1) & 0xFFFF
    return a + b + c


def rowgather_plain(ctx, tbl, cache, steps):
    """w4 / m9: cache = tbl[ctx]; acc += cache[0]; ctx = (ctx*3+1) % NROW."""
    b, nrow, _ = tbl.shape
    r = rows(b, tbl.device)
    cx = i32(ctx).reshape(b).clone()
    ca = cache.clone()
    acc = torch.zeros(b, dtype=torch.int32, device=tbl.device)
    for _ in range(steps):
        ca = tbl[r, cx].clone()
        acc += ca[:, 0]
        cx = (cx * 3 + 1) % nrow
    return acc, ca


def move_rows(w, bsel, dst, src, n):
    """w[bsel[i], dst[i]:dst[i]+n] = snapshot of w[bsel[i], src[i]:+n],
    copy after copy (a DMA's snapshot semantics)."""
    for b, d, s in zip(bsel.tolist(), dst.tolist(), src.tolist()):
        w[b, d:d + n] = w[b, s:s + n].clone()


def const(v):
    return lambda: np.asarray(v)


def timed_sizes(p):
    """Every (label, size, steps) the runner times: the spike's own size,
    then the probe's extra sizes."""
    return (("spike", p.size, p.steps),) + p.sizes


def compare(p, dev, steps=5):
    """The kernel in both layouts against the plain version, on the
    spike's own inputs on `dev` at every size the runner times, over
    `steps` steps (one call for a probe without a step loop): {label: the
    max abs difference over every output and updated input} (0 = equal)."""
    n = 1 if p.steps == (1, 1) else steps
    errs = {}
    for label, size, _ in timed_sizes(p):
        ins = inputs(p, size, device=dev)
        want = p.plain(size, n, **ins)
        err = 0.0
        for layout in LAYOUTS:
            got = run(p, ins, n, layout, size)
            if sorted(got) != sorted(want):
                raise RuntimeError(f"{p.key}: fields {sorted(got)} != "
                                   f"{sorted(want)}")
            for k, w in want.items():
                d = (got[k].double() - w.double()).abs().max().item()
                err = max(err, d)
        errs[label] = err
    return errs
