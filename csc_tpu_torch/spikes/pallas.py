"""S6: the probes of tools/spike_pallas.py: onehot_step_cost :34
(pl.pallas_call :56), transition_cost :67 (:84), scalar_loop_cost :94
(:112), row_swap_cost :123 (:140), vmem_to_smem :152 (:165),
vmem_to_smem_latency :177 (:188), hbm_row_dma_cost :200 (:230).

The scalar loops over the streams become the block's sweep through
shared memory, with each stream's guarded work done by its own thread;
the row copies and row DMAs become the thread's own row reads (from the
table staged in shared memory for the VMEM table, from device memory for
the HBM one).
"""
import numpy as np
import torch

from ._probe import Arg, Probe, const
from .marginal import bitstep_probe, chain_probe, reqblock_probe

FILE = "pallas"
SRC = "tools/spike_pallas.py"


def _site(name, line, pc):
    return f"{SRC}:{line} {name} (pallas_call :{pc})"


ONEHOT = bitstep_probe(FILE, "onehot_step_cost",
                       _site("onehot_step_cost", 34, 56), 0,
                       {"B": 256, "NP": 2048}, {"B": 8, "NP": 64},
                       (100, 1000), np.int32)
TRANSITION = chain_probe(FILE, "transition_cost",
                         _site("transition_cost", 67, 84), 1, (100, 1000))


def _loop_plain(size, steps, act, wnd):
    b = wnd.shape[0]
    lim = int(b * size["AF"])
    w = wnd.clone()
    on = torch.nonzero(act < lim).reshape(-1)
    base = (act[on] * 8) % (256 - 16)
    k = torch.arange(16, device=w.device)[None]
    # the read starts 16 further on, clamped to 240 as a dynamic slice is
    src = torch.clamp(base + 16, max=256 - 16)[:, None] + k
    for _ in range(steps):
        w[on[:, None], base[:, None] + k] = w[on[:, None], src] + 1
    return {"out": w[:1].clone(),
            "issued": torch.tensor([on.numel() * steps], dtype=torch.int32,
                                   device=w.device),
            "wnd": w}


SCALAR_LOOP = Probe(
    name="scalar_loop_cost", file=FILE, kid=lambda s: 2,
    site=_site("scalar_loop_cost", 94, 112),
    size={"B": 256, "AF": 1.0}, small={"B": 32, "AF": 1.0},
    sizes=(("active=0.125", {"B": 256, "AF": 0.125}, (20, 200)),),
    ins=lambda s: [
        Arg("act", (s["B"],), np.int32, lambda s=s: np.arange(s["B"]),
            0, s["B"]),
        Arg("wnd", (s["B"], 256), np.int32, const(0), 0, 1 << 20)],
    outs=lambda s: [("out", (1, 256), np.int32, False),
                    ("issued", (1,), np.int32, True)],
    mutable=("wnd",), plain=_loop_plain,
    q=lambda s: [int(s["B"] * s["AF"])], streams=lambda s: s["B"],
    steps=(20, 200),
    cost=lambda s: (int(s["B"] * s["AF"]) * 128 + s["B"] * 4,
                    s["B"] * 2 + int(s["B"] * s["AF"]) * 16))


def rowfetch_plain(size, steps, ctx, big, cache):
    """row_swap_cost / hbm_row_dma_cost: the streams b < R fetch row
    ctx[b] of their table into their cache, every step."""
    r = size.get("R", cache.shape[0])
    ca = cache.clone()
    if steps > 0:
        rows = big.reshape(big.shape[0], -1, 256)
        ca[:r] = rows[torch.arange(r, device=big.device), ctx[:r]]
    return {"out": ca[:1].clone(), "cache": ca}


def rowfetch_probe(name, site, kid, nrow, size, small, steps, stage,
                   sizes=()):
    return Probe(
        name=name, file=FILE, kid=lambda s: kid, site=site,
        size=size, small=small, sizes=sizes,
        ins=lambda s: [
            Arg("ctx", (s["B"],), np.int32,
                lambda s=s: np.arange(s["B"]) % s.get("NROW", nrow),
                0, s.get("NROW", nrow)),
            Arg("big", (s["B"], s.get("NROW", nrow) * 256), np.int32,
                const(0), 0, 1 << 20),
            Arg("cache", (s["B"], 256), np.int32, const(0), 0, 1 << 20)],
        outs=lambda s: [("out", (1, 256), np.int32, False)],
        mutable=("cache",), plain=rowfetch_plain,
        q=lambda s: [s.get("R", s["B"]), s.get("NROW", nrow), stage, 1],
        streams=lambda s: s["B"], steps=steps,
        cost=lambda s: (s.get("R", s["B"]) * 2048, s.get("R", s["B"]) * 256))


ROW_SWAP = rowfetch_probe("row_swap_cost", _site("row_swap_cost", 123, 140),
                          3, 64, {"B": 256, "NROW": 64},
                          {"B": 8, "NROW": 8}, (20, 200), 1)
VMEM_TO_SMEM = reqblock_probe(FILE, "vmem_to_smem",
                              _site("vmem_to_smem", 152, 165), 4, (1, 1),
                              k=1, mode=3)
VMEM_TO_SMEM_LATENCY = reqblock_probe(
    FILE, "vmem_to_smem_latency", _site("vmem_to_smem_latency", 177, 188),
    5, (20, 200), k=1, mode=2)
HBM_ROW_DMA = rowfetch_probe(
    "hbm_row_dma_cost", _site("hbm_row_dma_cost", 200, 230), 6, 64,
    {"B": 256, "R": 256}, {"B": 8, "R": 4}, (10, 100), 0,
    sizes=(("rows/step=32", {"B": 256, "R": 32}, (10, 100)),))

PROBES = [ONEHOT, TRANSITION, SCALAR_LOOP, ROW_SWAP, VMEM_TO_SMEM,
          VMEM_TO_SMEM_LATENCY, HBM_ROW_DMA]
