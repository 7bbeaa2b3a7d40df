"""S10: the probes of tools/spike_roofline.py (`_run` :32, its
pl.pallas_call :33, serving r1 :42, r2 :57, r3 :73, r4 :100, r5 :116).

r1 / r2 / r4 are read-modify-write passes of +1 over each stream's row
(a stream is a row: [256, 2048] int32 for r1 / r2, [1024, 1024] for r4's
4 MB), timed at the spike's sizes (inside the card's 50 MB L2) and at
256 MB, past it; r3 is the bit-model step unrolled x8, r5 the loop floor.
A step's bytes are one read and one write of the table, whatever its
passes: r2's step (+1 eight times) computes the table + 8 that one pass
gives (its library call).  The runner prints the rate of r2's passes
beside the bound.
"""
import numpy as np
import torch

from ._probe import Arg, Probe, bitstep_plain, const

FILE = "roofline"
SRC = "tools/spike_roofline.py"


def _rmw_plain(passes):
    def plain(size, steps, tbl):
        t = tbl + steps * passes
        out = t[:, 0][None] if size.get("all", True) else t[:1, :1]
        return {"out": out.contiguous(), "tbl": t}
    return plain


def _rmw(name, line, passes, nsteps, size, small, sizes):
    rows = (lambda s: s["B"]) if "B" in size else (lambda s: int(s["MB"] * 256))
    width = (lambda s: s["NP"]) if "B" in size else (lambda s: 1024)
    every = "B" in size
    return Probe(
        name=name, file=FILE, kid=lambda s, k={"r1": 0, "r2": 1, "r4": 3}[name]: k,
        site=f"{SRC}:{line} {name} (_run :32 / pallas_call :33)",
        size=size, small=small, sizes=sizes,
        ins=lambda s: [Arg("tbl", (rows(s), width(s)), np.int32, const(0),
                           0, 1 << 20)],
        outs=lambda s: [("out", (1, rows(s)) if every else (1, 1), np.int32,
                         False)],
        mutable=("tbl",),
        plain=_rmw_plain(passes) if every else
        lambda s, n, tbl: {"out": (tbl[:1, :1] + n * passes).contiguous(),
                           "tbl": tbl + n * passes},
        q=lambda s: [width(s), passes, int(every)],
        streams=rows, steps=nsteps, per=passes,
        unit="pass",
        cost=lambda s: (rows(s) * width(s) * 8,
                        rows(s) * width(s) * passes),
        library=lambda s, ins: (lambda t=ins["tbl"]: t.add_(passes)))


R1 = _rmw("r1", 42, 1, (100, 1000), {"B": 256, "NP": 2048},
          {"B": 8, "NP": 64}, (("256 MB", {"B": 32768, "NP": 2048}, (2, 12)),))
R2 = _rmw("r2", 57, 8, (25, 125), {"B": 256, "NP": 2048},
          {"B": 8, "NP": 64}, (("256 MB", {"B": 32768, "NP": 2048}, (1, 4)),))
R4 = _rmw("r4", 100, 1, (10, 100), {"MB": 4}, {"MB": 1},
          (("256 MB", {"MB": 256}, (2, 12)),))


def _r3_plain(size, steps, pidx, tbl):
    acc, t = bitstep_plain(pidx, tbl, steps, reps=8, acc_last=True)
    return {"out": acc[None], "tbl": t}


R3 = Probe(
    name="r3", file=FILE, kid=lambda s: 2,
    site=f"{SRC}:73 r3 (_run :32 / pallas_call :33)",
    size={"B": 256, "NP": 2048}, small={"B": 8, "NP": 64},
    ins=lambda s: [
        Arg("pidx", (1, s["B"]), np.int32,
            lambda s=s: np.arange(s["B"])[None] % s["NP"], 0, s["NP"]),
        Arg("tbl", (s["B"], s["NP"]), np.int32, const(2048), 0, 4096)],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    mutable=("tbl",), plain=_r3_plain,
    q=lambda s: [s["NP"], 8, 1], streams=lambda s: s["B"],
    steps=(25, 125), per=8, unit="bit step",
    cost=lambda s: (s["B"] * 8 * 8, s["B"] * 8 * 10))

R5 = Probe(
    name="r5", file=FILE, kid=lambda s: 4,
    site=f"{SRC}:116 r5 (_run :32 / pallas_call :33)",
    size={"B": 256}, small={"B": 8},
    ins=lambda s: [Arg("x", (1, s["B"]), np.int32, const(1), 0, 1000)],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    plain=lambda s, n, x: {"out": (x * n).to(torch.int32)},
    q=lambda s: [], streams=lambda s: s["B"], steps=(200, 2000),
    cost=lambda s: (0, s["B"]))

PROBES = [R1, R2, R3, R4, R5]
