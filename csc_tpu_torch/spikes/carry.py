"""S1: the probes of tools/spike_carry.py (`run_tuple` :82 and
`run_packed` :94, their pl.pallas_call :84 and :96; kernel `mk_kernel`
:43, step `work` :30): N = 48 carried int32 registers per stream through
add / shift / select / xor.  run_tuple keeps them in registers; run_packed
carries them as one array, on the card in shared memory (or the output
rows in device memory when a block's share does not fit), read and
written back every step.  The runner also times N = 24, 96 and 192, and
prints each N's registers and spills (the spike's question: at what N do
carried registers spill).
"""
import numpy as np
import torch

from ._probe import Arg, Probe

FILE = "carry"
SRC = "tools/spike_carry.py"
NS = (8, 24, 48, 96, 192)     # the N the kernel is built for


def work(rs):
    """tools/spike_carry.py `work` on [N, B] int32."""
    a = torch.roll(rs, -1, 0)     # rs[(i + 1) % n]
    b = torch.roll(rs, -7, 0)     # rs[(i + 7) % n]
    v = rs + (a >> 3)
    return torch.where(b > rs, v ^ a, v + 1)


def _plain(size, steps, init):
    n = size["N"]
    out = init.clone()
    rs = init[:n].clone()
    for _ in range(steps):
        rs = work(rs)
    out[:n] = rs
    return {"out": out}


def _probe(variant, line, pc):
    return Probe(
        name=f"run_{variant}", file=FILE,
        kid=lambda s, v=variant: (NS.index(s["N"])
                                  + (len(NS) if v == "packed" else 0)),
        site=f"{SRC}:{line} run_{variant} (pallas_call :{pc})",
        size={"B": 128, "N": 48}, small={"B": 8, "N": 8},
        sizes=tuple((f"N={n}", {"B": 128, "N": n}, (2000, 22000))
                    for n in (24, 96, 192)),
        ins=lambda s: [Arg("init", (-(-s["N"] // 8) * 8, s["B"]), np.int32,
                           lambda s=s: np.random.default_rng(0).integers(
                               0, 1 << 20, (-(-s["N"] // 8) * 8, s["B"])),
                           0, 1 << 20)],
        outs=lambda s: [("out", (-(-s["N"] // 8) * 8, s["B"]), np.int32,
                         False)],
        plain=_plain, q=lambda s: [s["N"], -(-s["N"] // 8) * 8],
        streams=lambda s: s["B"], steps=(2000, 22000),
        cost=lambda s: (0, s["B"] * s["N"] * 5))


PROBES = [_probe("tuple", 82, 84), _probe("packed", 94, 96)]
