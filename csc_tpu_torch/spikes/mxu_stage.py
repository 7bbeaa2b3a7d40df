"""S5: the probes of tools/spike_mxu_stage.py (`make` :19, its
pl.pallas_call :75): stage a pair of 128-wide rows at a per-stream row of
a [B, 16, 128] tile (sel_i32 by a 16-row select scan, mxu_f32 by a
one-hot dot_general), or write one row back (wb_sel, wb_mxu).  The card
reads or writes the row directly, the tile in shared memory when it fits.
"""
import numpy as np
import torch

from ._probe import Arg, Probe

FILE = "mxu_stage"
SRC = "tools/spike_mxu_stage.py"
KINDS = ("sel_i32", "mxu_f32", "wb_sel", "wb_mxu")


def _plain(kind):
    def plain(size, steps, tile, sub):
        b = tile.shape[0]
        r_ = torch.arange(b, device=tile.device)
        t = tile.clone()
        s0 = sub.reshape(b)
        acc = torch.zeros(b, dtype=torch.int32, device=tile.device)
        for i in range(steps):
            sb = s0 + (i & 3)
            r0, r1 = sb & 15, (sb + 1) & 15
            if kind in ("sel_i32", "mxu_f32"):
                acc = (acc + t[r_, r0, 0].to(torch.int32)
                       + t[r_, r1, 0].to(torch.int32))
            else:
                row = acc[:, None].to(t.dtype).expand(b, 128)
                t[r_, r0, :] = row if kind == "wb_sel" else t[r_, r0, :] + row
                acc = acc + 1
        return {"out": acc[None], "tile": t}
    return plain


def _probe(kind):
    dt = np.float32 if "mxu" in kind else np.int32
    wb = kind.startswith("wb")
    return Probe(
        name=kind, file=FILE, kid=lambda s, k=KINDS.index(kind): k,
        site=f"{SRC}:19 make('{kind}') (pallas_call :75)",
        size={"B": 128}, small={"B": 8},
        ins=lambda s: [
            Arg("tile", (s["B"], 16, 128), dt,
                lambda s=s: np.random.default_rng(0).integers(
                    0, 4096, (s["B"], 16, 128)), 0, 4096),
            Arg("sub", (1, s["B"]), np.int32,
                lambda s=s: np.random.default_rng(1).integers(
                    0, 16, (1, s["B"])), 0, 16)],
        outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
        mutable=("tile",), plain=_plain(kind), q=lambda s: [],
        streams=lambda s: s["B"], steps=(1000, 21000),
        cost=lambda s: (s["B"] * (512 if wb else 8),
                        s["B"] * (128 if wb else 4)))


PROBES = [_probe(k) for k in KINDS]
