"""S7: the probes of tools/spike_pallas2.py: s1 onehot_window_byte :38
(pl.pallas_call :61), s2 dma_window_copy :72 (:106), s3
vmem_to_smem_block :127 (:139), s4 hbm_row_swap :151 (:188), s5
bitstep_full :202 (:244), s6 scalar_sweep :254 (:266), s7
take_along_axis_in_kernel :276 (:290).

On the card the window byte read and write are indexed accesses, the
unaligned 128-byte DMA is a byte copy by the stream's thread, the request
block and the sweep go through shared memory, the row swap is the
thread's own row write-back and fetch, and s7's per-row gather is an
indexed load.
"""
import numpy as np
import torch

from ._probe import Arg, Probe, adapt, const, i32
from .marginal import reqblock_probe, sweep_probe, wndread_probe

FILE = "pallas2"
SRC = "tools/spike_pallas2.py"


def _site(name, line, pc):
    return f"{SRC}:{line} {name} (pallas_call :{pc})"


def _s1_plain(size, steps, pos, wnd):
    b, w = wnd.shape
    r = torch.arange(b, device=wnd.device)
    wn, po = wnd.clone(), pos.reshape(b).clone()
    acc = torch.zeros(b, dtype=torch.int32, device=wnd.device)
    for _ in range(steps):
        byte = i32(wn[r, po])
        wn[r, (po + 7) % w] = ((byte + 1) & 0xFF).to(torch.uint8)
        acc += byte
        po = (po * 5 + 3) % w
    return {"out": acc[None], "wnd": wn}


S1 = Probe(
    name="s1", file=FILE, kid=lambda s: 0,
    site=_site("s1 onehot_window_byte", 38, 61),
    size={"B": 256, "W": 16384}, small={"B": 8, "W": 256},
    ins=lambda s: [
        Arg("pos", (1, s["B"]), np.int32,
            lambda s=s: np.arange(s["B"]) * 17 % s["W"], 0, s["W"]),
        Arg("wnd", (s["B"], s["W"]), np.uint8, const(0))],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    mutable=("wnd",), plain=_s1_plain, q=lambda s: [s["W"]],
    streams=lambda s: s["B"], steps=(30, 300),
    cost=lambda s: (s["B"] * 2, s["B"] * 8))


def _s2_plain(size, steps, src, dst, wnd):
    b, ch, a = wnd.shape[0], size["CH"], size["A"]
    w = wnd.clone()
    so, do = src.tolist(), dst.tolist()
    for _ in range(steps):
        for c in range(a):
            k = c * (b // a)
            w[k, do[k]:do[k] + ch] = w[k, so[k]:so[k] + ch].clone()
    return {"out": w[:1].clone(), "wnd": w}


S2 = Probe(
    name="s2", file=FILE, kid=lambda s: 1,
    site=_site("s2 dma_window_copy", 72, 106),
    size={"B": 256, "W": 16384, "CH": 128, "A": 32},
    small={"B": 8, "W": 512, "CH": 16, "A": 4},
    ins=lambda s: [
        Arg("src", (s["B"],), np.int32,
            lambda s=s: np.arange(s["B"]) * 7 % (s["W"] // 2) + 1,
            0, s["W"] - s["CH"]),
        Arg("dst", (s["B"],), np.int32,
            lambda s=s: np.arange(s["B"]) * 11 % (s["W"] // 2)
            + s["W"] // 2 + 3, 0, s["W"] - s["CH"]),
        Arg("wnd", (s["B"], s["W"]), np.uint8,
            lambda s=s: np.arange(s["W"]) & 0xFF)],
    outs=lambda s: [("out", (1, s["W"]), np.uint8, False)],
    mutable=("wnd",), plain=_s2_plain,
    q=lambda s: [s["CH"], s["W"], s["A"], 0], streams=lambda s: s["B"],
    steps=(20, 200), cost=lambda s: (s["A"] * s["CH"] * 2, 0))

S3 = reqblock_probe(FILE, "s3", _site("s3 vmem_to_smem_block", 127, 139),
                    2, (30, 300), k=8, mode=1)


def _s4_plain(size, steps, ctx, hbm, cache):
    b, a, rows = hbm.shape[0], size["A"], size["ROWS"]
    h, ca = hbm.clone(), cache.clone()
    cx = ctx.tolist()
    for _ in range(steps):
        for c in range(a):
            k = c * (b // a)
            ct, ct2 = cx[k], (cx[k] * 3 + 1) % rows
            h[k, ct * 256:(ct + 1) * 256] = ca[k]
            ca[k] = h[k, ct2 * 256:(ct2 + 1) * 256]
    return {"out": ca[:1].clone(), "hbm": h, "cache": ca}


S4 = Probe(
    name="s4", file=FILE, kid=lambda s: 3,
    site=_site("s4 hbm_row_swap", 151, 188),
    size={"B": 256, "A": 32, "ROWS": 256},
    small={"B": 8, "A": 4, "ROWS": 256},
    ins=lambda s: [
        Arg("ctx", (s["B"],), np.int32,
            lambda s=s: np.arange(s["B"]) % s["ROWS"], 0, s["ROWS"]),
        Arg("hbm", (s["B"], s["ROWS"] * 256), np.int32, const(0),
            0, 1 << 20),
        Arg("cache", (s["B"], 256), np.int32, const(0), 0, 1 << 20)],
    outs=lambda s: [("out", (1, 256), np.int32, False)],
    mutable=("hbm", "cache"), plain=_s4_plain,
    q=lambda s: [s["A"], s["ROWS"], 0, 0], streams=lambda s: s["B"],
    steps=(20, 200), cost=lambda s: (s["A"] * 4096, s["A"] * 512))


def _s5_plain(size, steps, pidx, tbl, cache):
    b, np_ = tbl.shape
    r = torch.arange(b, device=tbl.device)
    t, ca = tbl.clone(), cache.clone()
    pi = pidx.reshape(b).clone()
    node = torch.zeros(b, dtype=torch.int32, device=tbl.device)
    acc = torch.zeros(b, dtype=torch.int32, device=tbl.device)
    for _ in range(steps):
        in_cache = pi >= np_
        sp = torch.where(in_cache, 0, pi)
        p = torch.where(in_cache, ca[r, node], t[r, sp])
        newp = adapt(p)
        t[r, sp] = torch.where(in_cache, t[r, sp], newp)
        ca[r, node] = torch.where(in_cache, newp, ca[r, node])
        a, bb, c = pi, node, acc          # the ~60 transition selects,
        for _ in range(20):               # whose result the spike drops
            m = a > bb
            a = torch.where(m, a + 1, a - c) & 0xFFFF
            bb = torch.where(m, bb * 2 + 1, bb) & 0xFF
            c = torch.where((c & 3) == 1, c + a, c + 1) & 0xFFFF
        pi = (pi * 5 + 1 + (p & 1)) % (np_ + 256)
        node = (node * 2 + (p & 1)) & 0xFF
        acc = acc + p
    return {"out": acc[None], "tbl": t, "cache": ca}


S5 = Probe(
    name="s5", file=FILE, kid=lambda s: 4,
    site=_site("s5 bitstep_full", 202, 244),
    size={"B": 256, "NP": 2048}, small={"B": 8, "NP": 64},
    ins=lambda s: [
        Arg("pidx", (1, s["B"]), np.int32,
            lambda s=s: np.arange(s["B"]) % (s["NP"] + 256),
            0, s["NP"] + 256),
        Arg("tbl", (s["B"], s["NP"]), np.int32, const(2048), 0, 4096),
        Arg("cache", (s["B"], 256), np.int32, const(2048), 0, 4096)],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    mutable=("tbl", "cache"), plain=_s5_plain, q=lambda s: [s["NP"]],
    streams=lambda s: s["B"], steps=(100, 1000),
    cost=lambda s: (s["B"] * 8, s["B"] * 75))

S6 = sweep_probe(FILE, "s6", _site("s6 scalar_sweep", 254, 266), 5,
                 (50, 500), size={"B": 256, "A": 32},
                 small={"B": 8, "A": 4})
S7 = wndread_probe(FILE, "s7", _site("s7 take_along_axis_in_kernel", 276,
                                     290), 6, {"B": 256, "W": 4096},
                   {"B": 8, "W": 64}, (30, 300), np.int32, library=True)

PROBES = [S1, S2, S3, S4, S5, S6, S7]
