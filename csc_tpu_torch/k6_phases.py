"""Where K6's time goes on one card: block 0's SM cycles in each part of
the exact optimal parse.

    python -m csc_tpu_torch.k6_phases [--json FILE] [--other DIR]
                                      [--cells m5,task_m5,ring_m3]

Builds csrc/encode_k6.cu with -DK6_PHASES (clock64 marks at the phase
boundaries of encode_k6.cuh and of the finder's share in encode_k5.cuh,
read back through csc_k6_phases), launches it on the encode path's
inputs of the exact cells (m5 and m3 on 96 x 16 KB text, the m5 and m3
tasks of 4 x 1 MB, the m3 streams past their dictionary of 96 x 48 KB
text under a 36 KB dictionary: the ring kernel; the streams of
kernel_ab.py) and prints, for block 0's stream, each phase's cycles a
position (a find), its share of the stream's cycles, and the counts.
The phases:

  find     the find's hashes, table loads, lanes' compares and fold
           (K5's find_records up to the tree)
  walk     the tree's walk in a find (m5)
  insert   the slide's tree insertions (m5)
  slide    the rest of the slide (HT2 / HT3, at m3 / m4 the HT6 rows)
  price    the find's records priced: the length cache, the distance
           prices
  cells    a stretch position's state and rep queue from its back cell
  lit      the literal's price (p_lit)
  relax    the relaxation of the cells the find reaches
  code     the back-walk's tokens and the model's adaptation
  other    the run loop, the walk of the blocks, the sparse insertion
  mark     one mark's own cost (subtract it from each mark)

With --other DIR (the root of another checkout with the same marks,
for example a `git archive` of the parent commit under build/), that
checkout's phase build runs each cell too, before this one's, and its
lines are tagged "other".  The marks cost cycles of their own: read the
shares here and take the kernel's time from kernel_ab.py.  `run`
returns the phase build's outputs, which chip_smoke.py holds to the
normal build's (`launch`).
"""
import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from . import _build, corpus
from .kernel_ab import KB, MB, SEED, stage_args
from .ops import exact_ap_kernel
from .props import props_init

PHASES = ("find", "walk", "insert", "slide", "price", "cells", "lit",
          "relax", "code", "other", "mark")
COUNTS = ("finds", "walk_steps", "inserts", "insert_steps", "stretches")


def library(csrc=_build.CSRC):
    """The K6 library built with its phase clocks (from another
    checkout's sources: `csrc`, its csc_tpu_torch/csrc)."""
    so = _build.build(_build.KERNELS["csc_k6"], "csc_k6_phases",
                      flags=_build.NVCC_FLAGS + ["-DK6_PHASES"], csrc=csrc)
    lib = ctypes.CDLL(so)
    name, argtypes = _build._ARGTYPES["csc_k6"]
    getattr(lib, name).restype = ctypes.c_int
    getattr(lib, name).argtypes = argtypes
    lib.csc_k6_phases.restype = ctypes.c_int
    lib.csc_k6_phases.argtypes = [ctypes.c_void_p]
    return lib


def read(lib):
    """The phase clocks and counts since the last read."""
    buf = np.zeros(len(PHASES) + len(COUNTS), np.uint64)
    rc = lib.csc_k6_phases(buf.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"csc_k6_phases failed: cudaError_t {rc}")
    return [int(v) for v in buf]


def launch(lib, args):
    """One synchronized launch of K6 library `lib` (the phase build or
    the normal one) on parse_k6's arguments, counted in no LAUNCHES: its
    outputs as parse_k6 gives them."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, tcap, \
        bt, bt_sizes = args
    b, dev = data.shape[0], data.device
    scratch = exact_ap_kernel.new_scratch(b, hash_bits, hash_width, dev, bt,
                                          data.shape[1], bt_sizes)
    tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
    out = torch.zeros((3, b), dtype=torch.int32, device=dev)
    btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)
    exact_ap_kernel.launch(lib, data, blocks, sizes, dicts, hash_bits,
                           hash_width, good_len,
                           exact_ap_kernel.p2b_table(dev), scratch, tape,
                           out, btypes, bt, bt_sizes)
    torch.cuda.synchronize()
    return tape, out[0], out[1], out[2], btypes


def run(lib, args):
    """One launch of the phase build on parse_k6's arguments: its
    outputs as parse_k6 gives them and the phase clocks and counts."""
    read(lib)
    out = launch(lib, args)
    return out, read(lib)


def cell(lib, args):
    """One launch of the phase build on K6's arguments: block 0's
    phases, each a find (a position the parse found)."""
    out, v = run(lib, args)
    return summary(args, out, v)


def summary(args, out, v):
    """Block 0's phases (`cell`'s) from a launch's outputs and clocks."""
    tok_cnt, sizes = out[1], args[2]
    cyc = dict(zip(PHASES, v))
    cnt = dict(zip(COUNTS, v[len(PHASES):]))
    total = sum(cyc.values())
    finds = max(1, cnt["finds"])
    return dict(cycles=total, positions=int(sizes[0]),
                tokens=int(tok_cnt[0]), counts=cnt,
                cycles_per_position=round(total / int(sizes[0]), 1),
                share={k: round(c / total, 4) for k, c in cyc.items()},
                per_find={k: round(c / finds, 1) for k, c in cyc.items()})


def cells_inputs(dev, names, text=None):
    """K6's arguments of the named cells ("m5", "m3": 96 x 16 KB text;
    "task_m5", "task_m3": 4 x 1 MB; "ring_m3": kernel_ab.py's ring cell,
    96 x 48 KB text under a 36 KB dictionary), as the encode path gives
    them, from `text` (the corpus' 64 MB of torch sources by default)."""
    if text is None:
        text = corpus.torch_python_text(64 * MB)
    rng = np.random.default_rng(SEED)
    offs = sorted(int(o) for o in rng.choice(len(text) // MB - 2, 4,
                                             replace=False))
    group = [text[o * MB:(o + 1) * MB] for o in offs]
    enc = [text[i * 16 * KB:(i + 1) * 16 * KB] for i in range(96)]
    ring = [text[i * 48 * KB:(i + 1) * 48 * KB] for i in range(96)]
    for name in names:
        level = int(name[-1])
        if name.startswith("ring_"):
            args, _, _ = stage_args([props_init(26 * KB, level)
                                     for _ in ring], ring, dev)
            if not bool((args[2] > args[3]).all()):
                raise RuntimeError("k6_phases: the ring cell's streams are "
                                   "not past their dictionary")
            yield f"m{level} ring 96 x 48 KB", args
            continue
        task = name.startswith("task_")
        datas = group if task else enc
        args, _, _ = stage_args([props_init(MB if task else 16 * KB, level)
                                 for _ in datas], datas, dev, "exact")
        yield (f"{name[-2:]} {'task 4 x 1 MB' if task else '96 x 16 KB'}",
               args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the results here too")
    ap.add_argument("--other", help="root of another checkout whose phase "
                    "build runs each cell too")
    ap.add_argument("--cells", default="m5,task_m5,m3,task_m3,ring_m3",
                    help="the cells, of m5, task_m5, m3, task_m3, ring_m3")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {"this": library()}
    if a.other:
        libs = {"other": library(os.path.join(os.path.abspath(a.other),
                                              "csc_tpu_torch", "csrc")),
                **libs}
    res = {"card": smi}
    for name, args in cells_inputs(dev, a.cells.split(",")):
        for who, lib in libs.items():
            key = name if who == "this" else f"{name} (other)"
            res[key] = cell(lib, args)
            print(f"[k6_phases] {key}: {json.dumps(res[key])}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
