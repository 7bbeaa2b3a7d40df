"""S2: the probes of tools/spike_dma.py: w1 :44 (pallas_call :71), its
check kernel :82 (:89), w1b :106 (:133), w2 :149 (:177), w3 :192 (:200),
w4 :209 (:228), w5 :240 (:282).  The TPU's DMAs between VMEM, HBM and
SMEM become copies by the stream's own thread (16 bytes at a time where
both ends allow it), VMEM staging becomes shared memory, and w3's
legality question (take_along_axis) becomes one indexed load.
"""
import numpy as np
import torch

from ._probe import Arg, Probe, const, i32, rowgather_plain
from ._probe import wndread_plain

FILE = "dma"
SRC = "tools/spike_dma.py"


def _w1_plain(size, steps, buf):
    ch, half = size["CH"], size["L"] // 2
    buf = buf.clone()
    for s in range(steps):
        for c in range(size["N"]):
            so = (s * 131 + c * 977) % half // 1024 * 1024
            do = half + (s * 57 + c * 389) % (half - ch) // 1024 * 1024
            buf[do:do + ch] = buf[so:so + ch].clone()
    return {"out": i32(buf[:1]), "buf": buf}


W1 = Probe(
    name="w1", file=FILE, kid=lambda s: 0,
    site=f"{SRC}:44 w1 (pallas_call :71)",
    size={"CH": 1024, "N": 32, "L": 1 << 20},
    small={"CH": 64, "N": 4, "L": 1 << 20},
    ins=lambda s: [Arg("buf", (s["L"],), np.uint8,
                       lambda s=s: np.arange(s["L"]) & 0xFF)],
    outs=lambda s: [("out", (1,), np.int32, False)],
    mutable=("buf",), racy=("buf",), plain=_w1_plain,
    q=lambda s: [s["CH"], s["L"]], streams=lambda s: s["N"],
    steps=(100, 1000), cost=lambda s: (s["N"] * s["CH"] * 2, 0))


def _ck_plain(size, steps, buf):
    buf = buf.clone()
    for _ in range(steps):
        buf[4096:5120] = buf[1024:2048].clone()
    return {"out": buf[:2048].clone(), "buf": buf}


W1_CHECK = Probe(
    name="w1_check", file=FILE, kid=lambda s: 1,
    site=f"{SRC}:82 w1 check kernel (pallas_call :89)",
    size={"L": 1 << 20}, small={"L": 1 << 20},
    ins=lambda s: [Arg("buf", (s["L"],), np.uint8,
                       lambda s=s: np.arange(s["L"]) & 0xFF)],
    outs=lambda s: [("out", (2048,), np.uint8, False)],
    mutable=("buf",), plain=_ck_plain, q=lambda s: [],
    streams=lambda s: 1, steps=(1, 1),
    cost=lambda s: (2048 + 2048, 0))


def _w1b_plain(size, steps, hbm, stage):
    ch, lim = size["CH"], size["L"] - size["CH"]
    stage = stage.clone()
    for s in range(steps):
        for c in range(size["N"]):
            so = (s * 131 + c * 977) % lim // 1024 * 1024
            stage[c * ch:(c + 1) * ch] = hbm[so:so + ch]
    return {"out": torch.ones(1, dtype=torch.int32, device=hbm.device),
            "stage": stage}


W1B = Probe(
    name="w1b", file=FILE, kid=lambda s: 2,
    site=f"{SRC}:106 w1b (pallas_call :133)",
    size={"CH": 1024, "N": 32, "L": 1 << 22},
    small={"CH": 64, "N": 4, "L": 1 << 22},
    ins=lambda s: [Arg("hbm", (s["L"],), np.uint8, const(0)),
                   Arg("stage", (s["N"] * s["CH"],), np.uint8, const(0))],
    outs=lambda s: [("out", (1,), np.int32, False)],
    mutable=("stage",), plain=_w1b_plain,
    q=lambda s: [s["CH"], s["L"]], streams=lambda s: s["N"],
    steps=(100, 1000), cost=lambda s: (s["N"] * s["CH"] * 2, 0))


def _w2_plain(size, steps, wnd):
    b, n, r = size["B"], size["N"], size["R"]
    wnd = wnd.clone()
    for s in range(steps):
        for c in range(n):
            r0 = (s * 7 + c * 13) % (r - 16) // 8 * 8
            wnd[c * (b // n), r0 + 8:r0 + 16] = \
                wnd[c * (b // n), r0:r0 + 8].clone()
    return {"out": i32(wnd[0, 0])[None], "wnd": wnd}


W2 = Probe(
    name="w2", file=FILE, kid=lambda s: 3,
    site=f"{SRC}:149 w2 (pallas_call :177)",
    size={"B": 256, "N": 32, "R": 128}, small={"B": 8, "N": 4, "R": 128},
    ins=lambda s: [Arg("wnd", (s["B"], s["R"], 128), np.uint8, const(0))],
    outs=lambda s: [("out", (1, 128), np.int32, False)],
    mutable=("wnd",), plain=_w2_plain,
    q=lambda s: [s["N"], s["R"], 1], streams=lambda s: s["B"],
    steps=(100, 1000), cost=lambda s: (s["N"] * 1024 * 2, 0))


def _w3_lib(size, ins):
    wnd, idx = ins["wnd"], ins["pos"].reshape(-1, 1).long()
    return lambda: torch.gather(wnd, 1, idx)


W3 = Probe(
    name="w3", file=FILE, kid=lambda s: 4,
    site=f"{SRC}:192 w3 (pallas_call :200)",
    size={"B": 256, "W": 2048}, small={"B": 8, "W": 64},
    ins=lambda s: [
        Arg("pos", (1, s["B"]), np.int32,
            lambda s=s: np.arange(s["B"]) * 17 % s["W"], 0, s["W"]),
        Arg("wnd", (s["B"], s["W"]), np.int32, const(0), 0, 1 << 20)],
    outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
    plain=lambda s, n, pos, wnd: {"out": wndread_plain(pos, wnd, n)[None]},
    q=lambda s: [s["W"]], streams=lambda s: s["B"], steps=(1, 1),
    cost=lambda s: (s["B"] * 12, s["B"]), library=_w3_lib)


def _w4_plain(size, steps, ctx, tbl, cache):
    acc, ca = rowgather_plain(ctx, tbl, cache, steps)
    return {"out": acc[None], "cache": ca}


def rowgather_probe(file, name, site, kid):
    """w4 / m9: cache[b] = tbl[b, ctx[b]] a step ([B, 64, 256] int32)."""
    return Probe(
        name=name, file=file, kid=lambda s: kid, site=site,
        size={"B": 256, "NROW": 64}, small={"B": 8, "NROW": 8},
        ins=lambda s: [
            Arg("ctx", (1, s["B"]), np.int32,
                lambda s=s: np.arange(s["B"]) % s["NROW"], 0, s["NROW"]),
            Arg("tbl", (s["B"], s["NROW"], 256), np.int32, const(2048),
                0, 4096),
            Arg("cache", (s["B"], 256), np.int32, const(2048), 0, 4096)],
        outs=lambda s: [("out", (1, s["B"]), np.int32, False)],
        mutable=("cache",), plain=_w4_plain, q=lambda s: [s["NROW"]],
        streams=lambda s: s["B"], steps=(100, 1000),
        cost=lambda s: (s["B"] * 2048, s["B"] * 260))


W4 = rowgather_probe(FILE, "w4", f"{SRC}:209 w4 (pallas_call :228)", 5)


def _w5_req(s):
    b, n, half = s["B"], s["N"], s["L"] // 2
    req = np.zeros((3, b), np.int64)
    req[0] = np.arange(b) * 37 % half
    req[1] = np.arange(b) * 53 % half
    req[2] = np.where(np.arange(b) % (b // n) == 0, 0, n + 7)
    return req


def _w5_rand(s, rng):
    b, n, half = s["B"], s["N"], s["L"] // 2
    return np.stack([rng.integers(0, half, b), rng.integers(0, half, b),
                     rng.integers(0, 2 * n, b)])


def _w5_plain(size, steps, req, buf):
    n, ch, half = size["N"], size["CH"], size["L"] // 2
    buf = buf.clone()
    r0, r1, r2 = (req[k].tolist() for k in range(3))
    issued = 0
    for s in range(steps):
        for b in range(len(r2)):
            if r2[b] < n:
                so = (r0[b] + s) % half // 1024 * 1024
                do = half + (r1[b] + s) % (half - ch) // 1024 * 1024
                buf[do:do + ch] = buf[so:so + ch].clone()
                issued += 1
    dev = buf.device
    return {"out": req[0, :1].clone(),
            "issued": torch.tensor([issued], dtype=torch.int32, device=dev),
            "buf": buf}


W5 = Probe(
    name="w5", file=FILE, kid=lambda s: 6,
    site=f"{SRC}:240 w5 (pallas_call :282)",
    size={"B": 256, "N": 32, "CH": 1024, "L": 1 << 20},
    small={"B": 8, "N": 4, "CH": 64, "L": 1 << 20},
    ins=lambda s: [
        Arg("req", (3, s["B"]), np.int32, lambda s=s: _w5_req(s),
            rand=lambda rng, s=s: _w5_rand(s, rng)),
        Arg("buf", (s["L"],), np.uint8, const(0))],
    outs=lambda s: [("out", (1,), np.int32, False),
                    ("issued", (1,), np.int32, True)],
    mutable=("buf",), racy=("buf",), plain=_w5_plain,
    q=lambda s: [s["N"], s["CH"], s["L"]], streams=lambda s: s["B"],
    steps=(100, 1000),
    cost=lambda s: (s["N"] * s["CH"] * 2 + s["B"] * 12, s["B"] * 4))

PROBES = [W1, W1_CHECK, W1B, W2, W3, W4, W5]
