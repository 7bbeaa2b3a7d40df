"""S9: the probes of tools/spike_regops.py (`make` :16, its
pl.pallas_call :48): a minimal loop (base), 100 and 400 chained [B]
register ops (reg100, reg400), and lut35, a 35-select phase-transition
table, which the card reads as two indexed loads from shared memory.
"""
import numpy as np
import torch

from ._probe import Arg, Probe

FILE = "regops"
SRC = "tools/spike_regops.py"
KINDS = {"base": (0, 1), "reg100": (1, 100), "reg400": (2, 400),
         "lut35": (3, 35)}


def _plain(kind):
    def plain(size, steps, x):
        a = x.reshape(-1).clone()
        b, d = a + 1, a + 2
        for _ in range(steps):
            if kind == "base":
                a = a + 1
            elif kind == "lut35":
                ph = a & 15
                nxt = torch.zeros_like(ph)
                for i in range(24):
                    nxt = torch.where(ph == (i % 12), i * 3 + 1, nxt)
                prm = torch.zeros_like(ph)
                for i in range(11):
                    prm = torch.where(nxt == i, i * 257, prm)
                a = a + nxt + (prm >> 4)
            else:
                for _ in range(KINDS[kind][1] // 4):
                    a = a + b
                    b = b ^ d
                    d = torch.where(a > b, d + 1, d)
                    a = a & 0xFFFF
        return {"out": (a + b + d)[None]}
    return plain


def _probe(kind):
    kid, ops = KINDS[kind]
    return Probe(
        name=kind, file=FILE, kid=lambda s, k=kid: k,
        site=f"{SRC}:16 make('{kind}') (pallas_call :48)",
        size={"B": 128}, small={"B": 8},
        ins=lambda s: [Arg("x", (1, s["B"]), np.int32,
                           lambda s=s: np.random.default_rng(0).integers(
                               0, 1000, (1, s["B"])), 0, 1000)],
        outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
        plain=_plain(kind), q=lambda s: [], streams=lambda s: s["B"],
        steps=(1000, 41000), cost=lambda s, o=ops: (0, s["B"] * o))


PROBES = [_probe(k) for k in KINDS]
