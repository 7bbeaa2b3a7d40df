"""Time several builds of K6 in turns on one card: variants of
csc_tpu_torch/csrc, each built from its own checkout, on k6_phases.py's
cells, with their phase splits.

    python -m csc_tpu_torch.k6_variants NAMES CELLS [PHASE_CELLS
                                        [PHASE_NAMES]]

NAMES: comma-separated checkouts, `this` (this one) or the root of
another (for example a `git archive` of the parent commit under
build/); CELLS and PHASE_CELLS: k6_phases.py's cells (m3, m4, m5,
task_m3, task_m5, ring_m3); PHASE_NAMES: the checkouts whose phase-clock
build runs on PHASE_CELLS.  Every build is made at once, then each cell
is timed with each build in turns, forward then backward (CUDA events,
raw launches, the scratch zeroed outside the events), and each prints
its best time; every build's outputs must equal the first's.  Where
kernel_ab.py holds one other checkout to this one on the encode path's
cells, this holds several at once, so that a change is tried in a few
forms in one call.
"""
import json
import os
import sys
import threading
import time

import torch

from csc_tpu_torch import _build, k6_phases
from csc_tpu_torch.kernel_ab import event_ms, same
from csc_tpu_torch.ops import exact_ap_kernel

REPS = {"m3": 5, "m4": 5, "ring_m3": 3, "m5": 3, "task_m3": 1}


def csrc_of(name):
    """The csrc directory of checkout `name`."""
    if name == "this":
        return _build.CSRC
    return os.path.join(os.path.abspath(name), "csc_tpu_torch", "csrc")


def main(argv):
    names = argv[0].split(",")
    cells = argv[1].split(",")
    phase_cells = argv[2].split(",") if len(argv) > 2 else []
    phase_names = argv[3].split(",") if len(argv) > 3 else []
    if not torch.cuda.is_available():
        raise SystemExit("k6_variants: needs a CUDA card")
    t0 = time.time()
    libs, plibs, errs = {}, {}, []

    def build(n):
        try:
            _build.build_kernels(["csc_k6"], csrc_of(n))
            libs[n] = _build.load("csc_k6", csrc_of(n))
            if n in phase_names:
                plibs[n] = k6_phases.library(csrc_of(n))
        except RuntimeError as e:
            errs.append(f"{n}: {e}")
    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("builds", round(time.time() - t0, 1), errs, flush=True)
    for n in names:
        if n in libs:
            r = _build.resources("csc_k6", csrc_of(n))
            print("[res]", n, {k: v for k, v in r.items()
                               if k.startswith("registers_")}, flush=True)
    names = [n for n in names if n in libs]
    dev = torch.device("cuda", 0)
    p2b = exact_ap_kernel.p2b_table(dev)
    for cell, (cname, args) in zip(cells,
                                   k6_phases.cells_inputs(dev, cells)):
        data, blocks, sizes, dicts, hb, hw, gl, tcap, bt, bts = args
        b = data.shape[0]
        ms = {n: [] for n in names}
        outs = {}
        for n in names + names[::-1]:
            scratch = exact_ap_kernel.new_scratch(b, hb, hw, dev, bt,
                                                  data.shape[1], bts)
            tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
            out = torch.zeros((3, b), dtype=torch.int32, device=dev)
            bty = torch.zeros(blocks.shape[:2], dtype=torch.int32,
                              device=dev)

            def prep():
                for t in scratch[0] + (scratch[3] or ()) + (tape, bty):
                    t.zero_()

            def call(lib=libs[n]):
                exact_ap_kernel.launch(lib, data, blocks, sizes, dicts, hb,
                                       hw, gl, p2b, scratch, tape, out, bty,
                                       bt, bts)
                return (tape.clone(), out[0].clone(), out[1].clone(),
                        out[2].clone(), bty.clone())
            t, o = event_ms(call, REPS.get(cell, 1), prep)
            ms[n].append(t)
            outs[n] = o
        for n in names:
            if not same(outs[n], outs[names[0]]):
                raise RuntimeError(f"k6_variants: {n} differs from "
                                   f"{names[0]} on {cname}")
        best = {n: round(min(v), 3) for n, v in ms.items()}
        print(f"[var] {cname}: {json.dumps(best)}", flush=True)
        if cell in phase_cells:
            for n in names:
                if n in plibs:
                    s = k6_phases.cell(plibs[n], args)
                    print(f"[ph] {cname} {n}: cyc/pos "
                          f"{s['cycles_per_position']} "
                          + json.dumps(s["per_find"]), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
