"""S8: the probes of tools/spike_pallas3.py: `_smem_loop` :36 (its
pl.pallas_call :45, serving p1 :54 and p2 :65), p3 :75 (:96), p3b :109
(:119), p4 :132 (:161), p5 :174 (:184), p6 :195 (:211), p7 :223 (:246),
p8 :256 (:278).

The scalar loop's cost split (p1, p2, p5) becomes the block's sweep in
shared memory; the request-block copies started with or without a wait
(p3b, p3) become stores to shared memory with or without a
__syncthreads a step; the 32 parallel 128-byte DMAs (p4) are byte copies
by the streams' threads; p6's aligned 256-byte store, p7's chunked byte
gather and p8's uint16 bit step are plain indexed accesses.
"""
import numpy as np
import torch

from ._probe import Arg, Probe, const
from .marginal import bitstep_probe, reqblock_probe, sweep_probe
from .marginal import wndread_probe

FILE = "pallas3"
SRC = "tools/spike_pallas3.py"


def _site(name, line, pc):
    return f"{SRC}:{line} {name} (pallas_call :{pc})"


P1 = sweep_probe(FILE, "p1", f"{SRC}:54 p1 (_smem_loop :36 / pallas_call "
                 f":45)", 0, (50, 500))


def _p2_plain(size, steps, flag):
    v = sum(b * 3 + 1 for b in range(size["B"])) * steps
    return {"out": torch.tensor([v], dtype=torch.int64,
                                device=flag.device).to(torch.int32)}


P2 = Probe(
    name="p2", file=FILE, kid=lambda s: 1,
    site=f"{SRC}:65 p2 (_smem_loop :36 / pallas_call :45)",
    size={"B": 256}, small={"B": 8},
    ins=lambda s: [Arg("flag", (s["B"],), np.int32,
                       lambda s=s: np.arange(s["B"]), 0, s["B"])],
    outs=lambda s: [("out", (1,), np.int32, True)],
    plain=_p2_plain, q=lambda s: [], streams=lambda s: s["B"],
    steps=(50, 500), cost=lambda s: (0, s["B"] * 3))
P3 = reqblock_probe(FILE, "p3", _site("p3", 75, 96), 2, (40, 304), wait=0)
P3B = reqblock_probe(FILE, "p3b", _site("p3b", 109, 119), 3, (30, 300))


def _p4_plain(size, steps, wnd):
    b, n, w = wnd.shape[0], size["N"], size["W"]
    wn = wnd.clone()
    for s in range(steps):
        for c in range(n):
            so = (s * 131 + c * 977) % (w // 2)
            do = w // 2 + (s * 57 + c * 389) % (w // 2 - 256)
            wn[c * (b // n), do:do + 128] = wn[c * (b // n), so:so + 128].clone()
    return {"out": wn[:1].clone(), "wnd": wn}


P4 = Probe(
    name="p4", file=FILE, kid=lambda s: 4, site=_site("p4", 132, 161),
    size={"B": 256, "N": 32, "W": 16384}, small={"B": 8, "N": 4, "W": 16384},
    ins=lambda s: [Arg("wnd", (s["B"], s["W"]), np.uint8, const(0))],
    outs=lambda s: [("out", (1, s["W"]), np.uint8, False)],
    mutable=("wnd",), plain=_p4_plain,
    q=lambda s: [128, s["W"], s["N"], 1], streams=lambda s: s["B"],
    steps=(20, 200), cost=lambda s: (s["N"] * 256, 0))


def _p5_plain(size, steps, x):
    v = x.to(torch.int64).sum() * steps
    return {"out": v.to(torch.int32).reshape(1)}


P5 = Probe(
    name="p5", file=FILE, kid=lambda s: 5, site=_site("p5", 174, 184),
    size={"B": 256}, small={"B": 8},
    ins=lambda s: [Arg("x", (1, s["B"]), np.int32,
                       lambda s=s: np.arange(s["B"]), 0, 1000)],
    outs=lambda s: [("out", (1,), np.int32, True)],
    plain=_p5_plain, q=lambda s: [], streams=lambda s: s["B"],
    steps=(20, 200), cost=lambda s: (s["B"] * 4, s["B"]))


def _p6_plain(size, steps, off, tile, wnd):
    b = wnd.shape[0]
    wn = wnd.clone()
    o = off.tolist()
    for s in range(steps):
        for c in range(size.get("NF", 2)):
            k = (s + c * 37) % b
            wn[k, o[k] * 256:(o[k] + 1) * 256] = tile[k]
    return {"out": wn[:1].clone(), "wnd": wn}


P6 = Probe(
    name="p6", file=FILE, kid=lambda s: 6, site=_site("p6", 195, 211),
    size={"B": 256, "W": 16384}, small={"B": 8, "W": 1024},
    ins=lambda s: [
        Arg("off", (s["B"],), np.int32,
            lambda s=s: np.arange(s["B"]) % (s["W"] // 256),
            0, s["W"] // 256),
        Arg("tile", (s["B"], 256), np.uint8, const(1)),
        Arg("wnd", (s["B"], s["W"]), np.uint8, const(0))],
    outs=lambda s: [("out", (1, s["W"]), np.uint8, False)],
    mutable=("wnd",), plain=_p6_plain, q=lambda s: [s["W"], 2],
    streams=lambda s: s["B"], steps=(20, 200),
    cost=lambda s: (2 * 512, s["B"] * 2))
P7 = wndread_probe(FILE, "p7", _site("p7", 223, 246), 7,
                   {"B": 256, "W": 16384}, {"B": 8, "W": 4096}, (30, 300),
                   np.uint8)
P8 = bitstep_probe(FILE, "p8", _site("p8", 256, 278), 8,
                   {"B": 256, "NP": 1280}, {"B": 8, "NP": 40}, (100, 1000),
                   np.uint16)

PROBES = [P1, P2, P3, P3B, P4, P5, P6, P7, P8]
