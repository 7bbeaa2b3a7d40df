"""S4: the probes of tools/spike_marginal.py: `_pc` :55 (its
pl.pallas_call :62) serving m1 :71 (with m1b, uint16 [256, 1280]), m2
:102, m3 :126, m6 :259 (with m6b, unrolled x8), m7 :284, m8 :305, m9
:326; and m4 :166 (:177), m5 :190 (:201), m5b :215 (:246).

On the card the one-hot sums and take_along_axis gathers are indexed
loads, the 16-byte window copy is a thread's loop, the scalar sweep (m4)
and the request block to SMEM (m5) go through shared memory and
__syncthreads, and m5b's DMAs are copies by the stream's own thread.
"""
import numpy as np
import torch

from ._probe import Arg, Probe, bitstep_plain, chain_plain, const, i32
from ._probe import wndread_plain
from .dma import rowgather_probe

FILE = "marginal"
SRC = "tools/spike_marginal.py"


def _site(name, line, pc=None):
    return (f"{SRC}:{line} {name} (pallas_call :{pc})" if pc else
            f"{SRC}:{line} {name} (_pc :55 / pallas_call :62)")


def bitstep_probe(file, name, site, kid, size, small, steps, dtype):
    """m1 / m1b / onehot_step_cost / p8: the bit-model read and adapt in a
    per-stream [NP] table."""
    def plain(s, n, pidx, tbl):
        acc, t = bitstep_plain(pidx, tbl, n)
        return {"out": acc[None], "tbl": t}

    isz = np.dtype(dtype).itemsize
    return Probe(
        name=name, file=file, kid=lambda s: kid, site=site,
        size=size, small=small,
        ins=lambda s: [
            Arg("pidx", (1, s["B"]), np.int32,
                lambda s=s: np.arange(s["B"]) % s["NP"], 0, s["NP"]),
            Arg("tbl", (s["B"], s["NP"]), dtype, const(2048), 0, 4096)],
        outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
        mutable=("tbl",), plain=plain, q=lambda s: [s["NP"], 1, 0],
        streams=lambda s: s["B"], steps=steps,
        cost=lambda s: (s["B"] * 2 * isz, s["B"] * 10))


def wndread_probe(file, name, site, kid, size, small, steps, dtype,
                  library=False):
    """m2 / m8 / p7 / s7: a byte (or int32) read at a per-stream position
    of the [W] window, pos = (pos * 5 + 3) % W."""
    def lib(s, ins):
        wnd, idx = ins["wnd"], ins["pos"].reshape(-1, 1).long()
        return lambda: torch.gather(wnd, 1, idx)

    isz = np.dtype(dtype).itemsize
    return Probe(
        name=name, file=file, kid=lambda s: kid, site=site,
        size=size, small=small,
        ins=lambda s: [
            Arg("pos", (1, s["B"]), np.int32,
                lambda s=s: np.arange(s["B"]) * 17 % s["W"], 0, s["W"]),
            Arg("wnd", (s["B"], s["W"]), dtype, const(0), 0,
                256 if isz == 1 else 1 << 20)],
        outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
        plain=lambda s, n, pos, wnd: {"out": wndread_plain(pos, wnd, n)[None]},
        q=lambda s: [s["W"]], streams=lambda s: s["B"], steps=steps,
        cost=lambda s: (s["B"] * isz, s["B"] * 4),
        library=lib if library else None)


def sweep_probe(file, name, site, kid, steps, active=32, size=None,
                small=None):
    """m4 / s6 / p1: every step the sweep adds flag[b] where flag[b] <
    active, over all streams."""
    size = size or {"B": 256}
    small = small or {"B": 8}

    def plain(s, n, flag):
        a = s.get("A", active)
        v = torch.where(flag < a, flag, 0).to(torch.int64).sum() * n
        return {"out": v.to(torch.int32).reshape(1)}

    return Probe(
        name=name, file=file, kid=lambda s: kid, site=site,
        size=size, small=small,
        ins=lambda s: [Arg("flag", (s["B"],), np.int32,
                           lambda s=s: np.arange(s["B"]),
                           0, 2 * s.get("A", active))],
        outs=lambda s: [("out", (1,), np.int32, True)],
        plain=plain, q=lambda s: [s.get("A", active)],
        streams=lambda s: s["B"], steps=steps,
        cost=lambda s: (s["B"] * 4, s["B"] * 2))


def reqblock_probe(file, name, site, kid, steps, k=8, wait=1, mode=0):
    """m5 / p3 / p3b / s3 / vmem_to_smem(_latency): every step each
    stream's column of the [K, B] request block goes to the block's shared
    words (the TPU's copy to SMEM); wait = 1 synchronises every step."""
    def plain(s, n, req):
        if mode == 0:
            v = req[0, 0] + n
        elif mode == 1:
            v = (req[0, 0] + req[-1, -1]) * n
        elif mode == 2:
            v = req[0, 0] * n
        else:
            v = req[0].to(torch.int64).sum()
        return {"out": v.to(torch.int32).reshape(1)}

    return Probe(
        name=name, file=file, kid=lambda s: kid, site=site,
        size={"B": 256, "K": k}, small={"B": 8, "K": k},
        ins=lambda s: [Arg("req", (s["K"], s["B"]), np.int32,
                           lambda s=s: np.arange(s["K"] * s["B"]).reshape(
                               s["K"], s["B"]), 0, 1 << 20)],
        outs=lambda s: [("out", (1,), np.int32, True)],
        plain=plain, q=lambda s: [s["K"], wait], streams=lambda s: s["B"],
        steps=steps,
        cost=lambda s: (s["K"] * s["B"] * 4, s["B"]))


def rowsdma_plain(align):
    def plain(size, steps, wnd):
        b, n, r = size["B"], size["N"], size["R"]
        wnd = wnd.clone()
        for s in range(steps):
            for c in range(n):
                r0 = (s * 7 + c * 13) % (r - 16)
                r0 = r0 // 8 * 8 if align else r0
                wnd[c * (b // n), r0 + 8:r0 + 16] = \
                    wnd[c * (b // n), r0:r0 + 8].clone()
        return {"out": i32(wnd[0, 0])[None], "wnd": wnd}
    return plain


M1 = bitstep_probe(FILE, "m1", _site("m1", 71), 0, {"B": 256, "NP": 2048},
                   {"B": 8, "NP": 64}, (200, 4000), np.int32)
M1B = bitstep_probe(FILE, "m1b", _site("m1b", 71), 1,
                    {"B": 256, "NP": 1280}, {"B": 8, "NP": 40},
                    (200, 4000), np.uint16)
M2 = wndread_probe(FILE, "m2", _site("m2", 102), 2, {"B": 256, "W": 16384},
                   {"B": 8, "W": 256}, (200, 4000), np.uint8)


def _m3_plain(size, steps, pos, wnd):
    b, ch = wnd.shape[0], size["CH"]
    lim = size["W"] - 2 * ch
    r = torch.arange(b, device=wnd.device)[:, None]
    k = torch.arange(ch, device=wnd.device)[None]
    w, po = wnd.clone(), i32(pos).reshape(b).clone()
    acc = torch.zeros(b, dtype=torch.int32, device=wnd.device)
    for _ in range(steps):
        src = (po * 7 + 11) % lim
        got = w[r, src[:, None] + k].clone()
        w[r, po[:, None] + k] = got
        acc += i32(got[:, 0])
        po = (po * 5 + 3) % lim
    return {"out": acc[None], "wnd": w}


M3 = Probe(
    name="m3", file=FILE, kid=lambda s: 3, site=_site("m3", 126),
    size={"B": 256, "W": 16384, "CH": 16}, small={"B": 8, "W": 512, "CH": 16},
    ins=lambda s: [
        Arg("pos", (1, s["B"]), np.int32,
            lambda s=s: np.arange(s["B"]) * 17 % (s["W"] - 2 * s["CH"]),
            0, s["W"] - 2 * s["CH"]),
        Arg("wnd", (s["B"], s["W"]), np.uint8, const(0))],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    mutable=("wnd",), plain=_m3_plain, q=lambda s: [s["W"], s["CH"]],
    streams=lambda s: s["B"], steps=(100, 1000),
    cost=lambda s: (s["B"] * 2 * s["CH"], s["B"] * 2 * s["CH"]))

M4 = sweep_probe(FILE, "m4", _site("m4", 166, 177), 4, (100, 2000))
M5 = reqblock_probe(FILE, "m5", _site("m5", 190, 201), 5, (100, 2000))
M5B = Probe(
    name="m5b", file=FILE, kid=lambda s: 6, site=_site("m5b", 215, 246),
    size={"B": 256, "N": 32, "R": 128}, small={"B": 8, "N": 4, "R": 128},
    ins=lambda s: [Arg("wnd", (s["B"], s["R"], 128), np.uint8, const(0))],
    outs=lambda s: [("out", (1, 128), np.int32, False)],
    mutable=("wnd",), plain=rowsdma_plain(False),
    q=lambda s: [s["N"], s["R"], 0], streams=lambda s: s["B"],
    steps=(50, 500), cost=lambda s: (s["N"] * 1024 * 2, 0))


def chain_probe(file, name, site, kid, steps, reps=1):
    """m6 / m6b / transition_cost: 300 chained select / arith ops on [B]
    registers a step (x reps)."""
    return Probe(
        name=name, file=file, kid=lambda s: kid, site=site,
        size={"B": 256}, small={"B": 8},
        ins=lambda s: [Arg("x", (1, s["B"]), np.int32,
                           lambda s=s: np.arange(s["B"]), 0, 1 << 16)],
        outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
        plain=lambda s, n, x: {"out": chain_plain(x, n, reps)[None]},
        q=lambda s: [reps], streams=lambda s: s["B"], steps=steps,
        per=300 * reps, cost=lambda s: (0, s["B"] * 300 * reps))


M6 = chain_probe(FILE, "m6", _site("m6", 259), 7, (100, 2000))
M6B = chain_probe(FILE, "m6b", _site("m6b", 259), 8, (100, 2000), reps=8)


def _m7_plain(size, steps, pidx, tbl):
    b, np_ = tbl.shape
    r = torch.arange(b, device=tbl.device)
    pi = pidx.reshape(b).clone()
    acc = torch.zeros(b, dtype=torch.int32, device=tbl.device)
    for _ in range(steps):
        p = tbl[r, pi]
        acc += p
        pi = (pi * 5 + 1 + (p & 1)) % np_
    return {"out": acc[None]}


def _gather_lib(s, ins):
    src = ins["tbl"] if "tbl" in ins else ins["wnd"]
    idx = (ins["pidx"] if "pidx" in ins else ins["pos"]).reshape(-1, 1).long()
    return lambda: torch.gather(src, 1, idx)


M7 = Probe(
    name="m7", file=FILE, kid=lambda s: 9, site=_site("m7", 284),
    size={"B": 256, "NP": 2048}, small={"B": 8, "NP": 64},
    ins=lambda s: [
        Arg("pidx", (1, s["B"]), np.int32,
            lambda s=s: np.arange(s["B"]) % s["NP"], 0, s["NP"]),
        Arg("tbl", (s["B"], s["NP"]), np.int32, const(2048), 0, 4096)],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    plain=_m7_plain, q=lambda s: [s["NP"]], streams=lambda s: s["B"],
    steps=(200, 4000), cost=lambda s: (s["B"] * 4, s["B"] * 5),
    library=_gather_lib)
M8 = wndread_probe(FILE, "m8", _site("m8", 305), 10, {"B": 256, "W": 16384},
                   {"B": 8, "W": 256}, (200, 4000), np.uint8, library=True)
M9 = rowgather_probe(FILE, "m9", _site("m9", 326), 11)

PROBES = [M1, M1B, M2, M3, M4, M5, M5B, M6, M6B, M7, M8, M9]
