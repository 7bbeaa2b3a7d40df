"""Where K5's time goes on one card: block 0's SM cycles in each part of
the exact parse.

    python -m csc_tpu_torch.k5_phases [--json FILE]

Builds csrc/encode_k5.cu with -DK5_PHASES (clock64 marks at the phase
boundaries of encode_k5.cuh, read back through csc_k5_phases), launches
it on the encode path's inputs of the exact cells (m1 and m2 on 96 x 16
KB text, m1 on the 4 x 1 MB task, the streams of kernel_ab.py) and
prints, for block 0's stream, each phase's cycles a find (the slide's a
slide pass), its share of the stream's cycles, and the counts.  The
marks cost cycles of their own: read the shares here and take the
kernel's time from kernel_ab.py.  chip_smoke.py holds this build's
outputs to the normal build's on its exact m1 cell.
"""
import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from . import _build, corpus
from .kernel_ab import KB, MB, SEED, stage_args
from .ops import exact_kernel
from .props import props_init

PHASES = ("hash", "tables", "solo", "exit", "fold", "finish", "pick",
          "slide", "other", "mark")
COUNTS = ("finds", "passes", "extends", "misses")


def library():
    """The K5 library built with its phase clocks."""
    so = _build.build(_build.KERNELS["csc_k5"], "csc_k5_phases",
                      flags=_build.NVCC_FLAGS + ["-DK5_PHASES"])
    lib = ctypes.CDLL(so)
    name, argtypes = _build._ARGTYPES["csc_k5"]
    getattr(lib, name).restype = ctypes.c_int
    getattr(lib, name).argtypes = argtypes
    lib.csc_k5_phases.restype = ctypes.c_int
    lib.csc_k5_phases.argtypes = [ctypes.c_void_p]
    return lib


def read(lib):
    """The phase clocks and counts since the last read."""
    buf = np.zeros(len(PHASES) + len(COUNTS), np.uint64)
    rc = lib.csc_k5_phases(buf.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"csc_k5_phases failed: cudaError_t {rc}")
    return [int(v) for v in buf]


def run(lib, args):
    """One launch of the phase build on parse_k5's arguments: its
    outputs as parse_k5 gives them and the phase clocks and counts."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, lazy, \
        tcap, max_steps = args
    b, dev = data.shape[0], data.device
    tables = exact_kernel.new_tables(b, hash_bits, hash_width, dev)
    tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
    out = torch.zeros((4, b), dtype=torch.int32, device=dev)
    btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)
    read(lib)
    exact_kernel.launch(lib, data, blocks, sizes, dicts, hash_bits,
                        hash_width, good_len, lazy, tables, tape, max_steps,
                        out, btypes)
    torch.cuda.synchronize()
    return (tape, out[0], out[1], out[2], out[3], btypes), read(lib)


def cell(lib, args):
    """One launch of the phase build on K5's arguments: block 0's
    phases."""
    (_, tok_cnt, _, _, _, _), v = run(lib, args)
    sizes = args[2]
    cyc, cnt = dict(zip(PHASES, v)), dict(zip(COUNTS, v[len(PHASES):]))
    total = sum(cyc.values())
    per = {k: c / max(1, cnt["passes"] if k == "slide" else cnt["finds"])
           for k, c in cyc.items()}
    return dict(cycles=total, positions=int(sizes[0]),
                tokens=int(tok_cnt[0]), counts=cnt,
                share={k: round(c / total, 4) for k, c in cyc.items()},
                per_find={k: round(c, 1) for k, c in per.items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write the results here too")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lib = library()
    text = corpus.torch_python_text(64 * MB)
    rng = np.random.default_rng(SEED)
    offs = sorted(int(o) for o in rng.choice(len(text) // MB - 2, 4,
                                             replace=False))
    group = [text[o * MB:(o + 1) * MB] for o in offs]
    enc = [text[i * 16 * KB:(i + 1) * 16 * KB] for i in range(96)]
    res = {"card": smi}
    for name, level, datas in (("m1 96 x 16 KB", 1, enc),
                               ("m2 96 x 16 KB", 2, enc),
                               ("task m1 4 x 1 MB", 1, group)):
        args, _, _ = stage_args([props_init(len(d), level) for d in datas],
                                datas, dev, "exact")
        res[name] = cell(lib, args)
        print(f"[k5_phases] {name}: {json.dumps(res[name])}", flush=True)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
