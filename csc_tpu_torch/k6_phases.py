"""Where K6's time goes on one card: block 0's SM cycles in each part of
the exact optimal parse.

    python -m csc_tpu_torch.k6_phases [--json FILE] [--cells m5,task_m5]

Builds csrc/encode_k6.cu with -DK6_PHASES (clock64 marks at the phase
boundaries of encode_k6.cuh and of the finder's share in encode_k5.cuh,
read back through csc_k6_phases), launches it on the encode path's
inputs of the exact cells (m5 and m3 on 96 x 16 KB text, the m5 and m3
tasks of 4 x 1 MB, the streams of kernel_ab.py) and prints, for block
0's stream, each phase's cycles a position (a find), its share of the
stream's cycles, and the counts.  The phases:

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

The marks cost cycles of their own: read the shares here and take the
kernel's time from kernel_ab.py.  `run` returns the phase build's
outputs, which chip_smoke.py holds to the normal build's.
"""
import argparse
import ctypes
import json
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


def library():
    """The K6 library built with its phase clocks."""
    so = _build.build(_build.KERNELS["csc_k6"], "csc_k6_phases",
                      flags=_build.NVCC_FLAGS + ["-DK6_PHASES"])
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


def run(lib, args):
    """One launch of the phase build on parse_k6's arguments: its
    outputs as parse_k6 gives them and the phase clocks and counts."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, tcap, \
        bt, bt_sizes = args
    b, dev = data.shape[0], data.device
    scratch = exact_ap_kernel.new_scratch(b, hash_bits, hash_width, dev, bt,
                                          data.shape[1], bt_sizes)
    tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
    out = torch.zeros((3, b), dtype=torch.int32, device=dev)
    btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)
    read(lib)
    exact_ap_kernel.launch(lib, data, blocks, sizes, dicts, hash_bits,
                           hash_width, good_len,
                           exact_ap_kernel.p2b_table(dev), scratch, tape,
                           out, btypes, bt, bt_sizes)
    torch.cuda.synchronize()
    return (tape, out[0], out[1], out[2], btypes), read(lib)


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


def cells_inputs(dev, names):
    """K6's arguments of the named cells ("m5", "m3": 96 x 16 KB text;
    "task_m5", "task_m3": 4 x 1 MB), as the encode path gives them."""
    text = corpus.torch_python_text(64 * MB)
    rng = np.random.default_rng(SEED)
    offs = sorted(int(o) for o in rng.choice(len(text) // MB - 2, 4,
                                             replace=False))
    group = [text[o * MB:(o + 1) * MB] for o in offs]
    enc = [text[i * 16 * KB:(i + 1) * 16 * KB] for i in range(96)]
    for name in names:
        task = name.startswith("task_")
        level = int(name[-1])
        datas = group if task else enc
        args, _, _ = stage_args([props_init(MB if task else 16 * KB, level)
                                 for _ in datas], datas, dev, "exact")
        yield (f"{name[-2:]} {'task 4 x 1 MB' if task else '96 x 16 KB'}",
               args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the results here too")
    ap.add_argument("--cells", default="m5,task_m5,m3,task_m3",
                    help="the cells, of m5, task_m5, m3, task_m3")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k6_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = library()
    res = {"card": smi}
    for name, args in cells_inputs(dev, a.cells.split(",")):
        res[name] = cell(lib, args)
        print(f"[k6_phases] {name}: {json.dumps(res[name])}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
