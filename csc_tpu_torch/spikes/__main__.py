"""Time the spike probes on the card.

    python -m csc_tpu_torch.spikes [probe ...] [--device cpu] [--json FILE]

A probe is named by its spike file ("marginal": all its probes), by
file.name ("marginal.m1") or by its name alone ("m1"); no name means all.
On the card (the default; without one it raises) each probe prints one
line: the spike site it answers, ns per step in layout a (one stream per
block, one thread, as K1-K3 run) and in layout b (one stream per thread,
128 to a block) with each layout's grid and where its per-stream state
lives, ns per op where the spike printed that, the rate of the step's
bytes, the step's bound, registers and spills (nvcc -Xptxas -v), and the
card's name and power limit.  Each time is (T(n_big) - T(n_small)) /
(n_big - n_small) with the spike's own step counts, each T the minimum
of 3 CUDA-event-timed launches after a warm-up.  --device cpu runs the plain versions at the
tests' small sizes for a few steps: a rehearsal, with no times.
"""
import argparse
import json
import subprocess
import sys

import torch

from . import FILES, PROBES, _probe


def select(names):
    if not names:
        return list(PROBES.values())
    out = []
    for n in names:
        hit = [p for p in PROBES.values()
               if n in (p.file, p.key, p.name)]
        if not hit:
            raise SystemExit(f"no probe or spike file named {n!r}")
        out += [p for p in hit if p not in out]
    return out


def card_name():
    """nvidia-smi's name and power limit of the card, as one line."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _grid(p, size, layout):
    """The launch's grid, and whether the per-stream state sits in shared
    memory, from the library's own rule."""
    from .. import _build
    n = p.streams(size)
    per = 1 if layout == "a" else (_probe.PACK if n >= _probe.PACK
                                   else -(-n // 32) * 32)
    q = list(p.q(size)) + [0] * (6 - len(p.q(size)))
    lib = _build.kernel_library(f"spike_{p.file}")
    v = getattr(lib, f"spike_{p.file}_smem")(
        p.kid(size), _probe.LAYOUTS[layout], n, *q)
    where = "smem" if v & 1 else "global"
    return f"{-(-n // per)}x{per} {where} {v >> 1} B smem"


def measure(probes, dev, card, log=print):
    """Time each probe (and its extra sizes) in both layouts on `dev`;
    one dict per timing, one printed line each."""
    from .. import _build
    files = sorted({p.file for p in probes})
    _build.build_kernels([f"spike_{f}" for f in files])
    regs = {f: _probe.ptxas(_build.build_log(f"spike_{f}")) for f in files}
    rows = []
    for p in probes:
        for label, size, steps in _probe.timed_sizes(p):
            a = _probe.marginal_ns(p, "a", dev, size, steps)
            b = _probe.marginal_ns(p, "b", dev, size, steps)
            bnd, by = _probe.bound_ns(p, size)
            r = regs[p.file].get(p.kid(size))
            if r is None:
                raise RuntimeError(f"{p.key}: the build report of "
                                   f"spike_{p.file} names no registers for "
                                   f"kernel {p.kid(size)}")
            unit = "call" if steps == (1, 1) else "step"
            row = dict(key=p.key, file=p.file, name=p.name, site=p.site,
                       size=label, shape=size, steps=list(steps), unit=unit,
                       a_ns=a, b_ns=b, per=p.per, per_unit=p.unit,
                       bound_ns=bnd, bound_by=by, regs=r[0],
                       spill_stores=r[1], spill_loads=r[2],
                       grid_a=_grid(p, size, "a"), grid_b=_grid(p, size, "b"))
            rows.append(row)
            per_op = (f" | {a / p.per:.3f} / {b / p.per:.3f} ns per "
                      f"{p.unit} (a / b)" if p.per > 1 else "")
            nbytes = p.cost(size)[0]
            if nbytes and unit == "step" and min(a, b) > 0:
                row["a_gbps"], row["b_gbps"] = nbytes / a, nbytes / b
                per_op += (f" | {nbytes / a:.1f} / {nbytes / b:.1f} GB/s "
                           f"(a / b; published peak 3350)")
                if p.unit == "pass" and p.per > 1:
                    row["a_pass_gbps"] = nbytes * p.per / a
                    row["b_pass_gbps"] = nbytes * p.per / b
                    per_op += (f" | {row['a_pass_gbps']:.1f} / "
                               f"{row['b_pass_gbps']:.1f} GB/s of its "
                               f"{p.per} passes (a / b)")
            log(f"[spike] {p.key} {label} | {p.site} | "
                f"a ({row['grid_a']}): {a:.3f} ns/{unit} | "
                f"b ({row['grid_b']}): {b:.3f} ns/{unit}{per_op} | "
                f"bound {bnd:.6f} ns ({by}) | regs {r[0]}, spill "
                f"{r[1]}/{r[2]} B | {card}")
    return rows


def rehearse(probes, log=print):
    """The plain versions at the tests' small sizes, a few steps each."""
    for p in probes:
        n = 1 if p.steps == (1, 1) else 8
        ins = _probe.inputs(p, p.small, rng=None)
        out = _probe.run(p, ins, n, size=p.small)
        log(f"[spike] {p.key} | {p.site} | plain version on the CPU at "
            f"{p.small}, {n} steps: {sorted(out)} (a rehearsal: no device "
            f"times)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m csc_tpu_torch.spikes")
    ap.add_argument("probes", nargs="*")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--json", help="write the timings to this file")
    args = ap.parse_args(argv)
    probes = select(args.probes)
    if args.device == "cpu":
        rehearse(probes)
        return []
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes time the card "
                           "(--device cpu rehearses the plain versions)")
    card = card_name()
    rows = measure(probes, torch.device("cuda", 0), card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "files": list(FILES), "rows": rows}, f,
                      indent=1)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
