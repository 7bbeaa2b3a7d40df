"""S3: the probes of tools/spike_gather.py (`make_run` :28, its
pl.pallas_call :87): per step, REPS = 16 reads or writes of a per-stream
[256] int32 table (base, onehot256, onehot128, statlane, condroll,
adaptwrite, logrot).  On the card a one-hot sum is an indexed load from
the table in shared memory, and a roll is an offset added to the index.
"""
import numpy as np
import torch

from ._probe import Arg, Probe

FILE = "gather"
SRC = "tools/spike_gather.py"
MODES = ("base", "onehot256", "onehot128", "statlane", "condroll",
         "adaptwrite", "logrot")
REPS = 16


def _plain(mode):
    def plain(size, steps, x):
        b = x.shape[0]
        r_ = torch.arange(b, device=x.device)
        arr = x.clone()
        acc = torch.zeros(b, dtype=torch.int32, device=x.device)
        for _ in range(steps):
            idx = acc & 0xFF
            for r in range(REPS):
                if mode == "base":
                    acc = acc + 1
                elif mode == "onehot256":
                    acc = acc + arr[r_, (idx + r) & 0xFF]
                elif mode == "onehot128":
                    acc = acc + arr[r_, (idx + r) & 0x7F]
                elif mode == "statlane":
                    acc = acc + arr[:, (r * 37) % 256]
                elif mode == "condroll":
                    sh = 1 << (r % 8)
                    m = (acc & sh) != 0
                    arr = torch.where(m[:, None], torch.roll(arr, -sh, 1),
                                      arr)
                    acc = acc + arr[:, 0]
                elif mode == "adaptwrite":
                    k = (r * 37) % 256
                    arr[:, k] = torch.where((acc & 1) == 0, acc + r,
                                            arr[:, k])
                    acc = acc + arr[:, 0]
                else:   # logrot: the row rotated left by acc & 0xFF
                    acc = acc + arr[r_, acc & 0xFF]
        return {"out": (acc + arr[:, 0])[:, None], "x": arr}
    return plain


def _probe(mode):
    writes = mode == "adaptwrite"
    return Probe(
        name=mode, file=FILE, kid=lambda s, k=MODES.index(mode): k,
        site=f"{SRC}:28 make_run('{mode}') (pallas_call :87)",
        size={"B": 128}, small={"B": 8},
        ins=lambda s: [Arg("x", (s["B"], 256), np.int32,
                           lambda s=s: np.random.default_rng(0).integers(
                               0, 4096, (s["B"], 256)), 0, 4096)],
        outs=lambda s: [("out", (s["B"], 1), np.int32, False)],
        mutable=("x",), plain=_plain(mode), q=lambda s: [],
        streams=lambda s: s["B"], steps=(200, 2200), per=REPS,
        cost=lambda s: (0 if mode == "base" else
                        s["B"] * REPS * (8 if writes else 4),
                        s["B"] * REPS * 3))


PROBES = [_probe(m) for m in MODES]
