"""The card's counterparts of the TPU measurement spikes
(tools/spike_*.py): one module per spike file, one probe per
pl.pallas_call site, each a hand-written CUDA kernel
(csrc/spike_<file>.cu over the step code of csrc/spike_common.cuh) with
its plain PyTorch version beside it.  `python -m csc_tpu_torch.spikes`
times them on the card (see __main__.py).
"""
from . import (carry, dma, gather, marginal, mxu_stage, pallas, pallas2,
               pallas3, regops, roofline)
from ._probe import FILES, LAUNCHES, run

MODULES = {"carry": carry, "dma": dma, "gather": gather,
           "marginal": marginal, "mxu_stage": mxu_stage, "pallas": pallas,
           "pallas2": pallas2, "pallas3": pallas3, "regops": regops,
           "roofline": roofline}
# spike file -> the row id of PERF.md's kernel table
ROW = {"carry": "S1", "dma": "S2", "gather": "S3", "marginal": "S4",
       "mxu_stage": "S5", "pallas": "S6", "pallas2": "S7", "pallas3": "S8",
       "regops": "S9", "roofline": "S10"}
PROBES = {p.key: p for f in FILES for p in MODULES[f].PROBES}

__all__ = ["FILES", "LAUNCHES", "MODULES", "PROBES", "ROW", "run"]
