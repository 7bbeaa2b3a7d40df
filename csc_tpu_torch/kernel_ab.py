"""Time K1-K6 of this checkout against another checkout's, on one card,
in turns, at the cells of chip_smoke.py.

    python -m csc_tpu_torch.kernel_ab --other DIR
                                      [--kernels K1,K2,K3,K4,K5,K6]
                                      [--json FILE]

DIR is the root of another checkout (for example a `git archive` of the
parent commit unpacked under build/).  Its csc_tpu_torch/csrc/decode_k1.*,
encode_k2.* .. encode_k6.* are built beside this checkout's and launched
through this checkout's wrappers on the same inputs (the kernels' C
interface must be the same: a K5 that takes the LZ runs' ends rather
than the block table is left out with --kernels K1,K2,K3,K4); a kernel
the other checkout lacks is left out.
Cells: K1 on the decode headline (128 x 16 KB m1 text) and on the
extract group (256 x 1 MB m1 text, 4 slices x 64); K2 and K3 at m1 and at
m2 on the encode headline (96 x 16 KB text, filters on) and on the encode
task (4 x 1 MB m1 text); K4 at m3, m4 and m5 on 32 x 16 KB text, filters
on (bench.py's m3_text / m5_text rows, and m4), at m3 on 1 024 and 4 096
x 16 KB text (the largest group the encode path gives one launch: 64 MB,
ENCODE_GROUP_BYTES) and at m3 on the encode task (4 x 1 MB text: the
streams that keep their data in device memory); K5 (the exact parse) at
m1 and m2 on the encode headline, at m1 on 1 024 and 4 096 x 16 KB text
(the encode path's large groups; 4 096 needs more than eight K5 blocks
an SM) and on the encode task; K6 (the exact optimal parse) at m3 and
m4 on the encode headline, at m3 on 1 024 x 16 KB text and on the m3
encode task, at m3 on 96 x 48 KB text under a 36 KB dictionary (its ring
kernel: golden's ring window), at m3 on chip_smoke.py phase 9a's 4.67 MB
file past the cap (corpus.big_file, one stream: `c -m3`'s launch) and
past a 1 MB dictionary (`c -m3 -d 1m`'s, the ring kernel), and its
binary-tree kernel at m5 on the
encode headline, on 1 024 x 16 KB text, on the task and on the 4.67 MB
file (`c -m5`'s launch) (K6 against a checkout without it: `--other .`, this
checkout against itself; the m5 cells against a checkout without the
tree, and the ring cell against one without the ring kernel, time this
checkout against itself).  Only the wanted kernels of the other
checkout are built.  The inputs come from this checkout's encode path
on the card.  K4, K5 and K6 are launched
directly, with no debug copy (as on the encode path): the tape and the
hash tables are zeroed before each timed call, outside its events, and
the builds are compared on tape, tok_cnt, done and err (K5: and steps
and the block types; K6: and the block types).
Each cell is timed in turns, forward then backward (other, this, this,
other; CUDA events, the median of `reps` calls a turn, the best turn
kept), and the other build's outputs must equal this one's on every
field.  Prints, with the card's name and power limit: a line a cell (ms
of each build, ns per step of the longest stream: K3's per tape entry
and per modelled bit, a bit coded through a probability; K2, K4 and K5
per position and per LZ token, K5 also per lockstep micro-op, and per
byte of the whole batch), and each build's registers, stack frame, LDL /
STL and K1's blocks per SM.  Needs a CUDA card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from . import _build, corpus
from .constants import K_END, K_SENT_A
from .ops import (bits_kernel, bits_scan, decode_kernel, exact_ap_kernel,
                  exact_kernel, parse_ap_kernel, parse_kernel, pipeline)
from .props import props_init

KB, MB = 1024, 1024 * 1024
SEED = 20261016
NO_STEP_CAP = 1 << 62


def event_ms(fn, reps, prepare=None):
    """Median device ms of fn() over `reps` calls, and the last result;
    prepare() runs before each call, outside the timed events."""
    times, out = [], None
    for _ in range(reps):
        if prepare is not None:
            prepare()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000)      # the host's launch latency off
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), out


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def turns(name, other, fn, reps, calls=None):
    """fn() timed with this checkout's kernel `name` and with `other` (a
    library of it), in turns forward then backward; ({"other": best ms,
    "this": best ms}, this build's output).  calls: instead of fn, per
    build a (prepare, fn) pair, prepare run untimed before each call."""
    builds = {"other": other, "this": _build.kernel_library(name)}
    ms, outs = {k: [] for k in builds}, {}
    for who in ("other", "this", "this", "other"):
        prepare, call = calls[who] if calls else (None, fn)
        with _build.swapped(name, builds[who]):
            t, out = event_ms(call, reps, prepare)
        ms[who].append(t)
        outs[who] = out
    for who, out in outs.items():
        if not same(out, outs["this"]):
            raise RuntimeError(f"kernel_ab: {name} of {who} differs from "
                               f"this checkout's")
    return {k: min(v) for k, v in ms.items()}, outs["this"]


def coded_lengths(ends):
    ends = ends.cpu().numpy().astype(np.int64)
    return np.where(ends < 0x7FFFFFFF, ends, 0).max(axis=1)


def k1_cell(props, blobs, sizes, dev, other, reps):
    rc, bc, rce, bce = pipeline._demux(props, blobs, [0] * len(blobs))
    args = [torch.from_numpy(a).to(dev) for a in (rc, bc, rce, bce)]
    wnd = pipeline._bucket(max(sizes))
    ms, out = turns("csc_k1", other, lambda: decode_kernel.decode_k1(
        *args, wnd, NO_STEP_CAP), reps)
    if not (bool(out[3].all()) and not bool(out[4].any())):
        raise RuntimeError("kernel_ab: K1 did not decode every stream")
    bits = int(8 * (coded_lengths(args[2]) + coded_lengths(args[3])).max())
    return dict(ms=ms, ns_per_coded_bit={k: v * 1e6 / bits
                                         for k, v in ms.items()},
                ns_per_decoded_byte={k: v * 1e6 / max(sizes)
                                     for k, v in ms.items()},
                longest=dict(bytes=max(sizes), coded_bits=bits))


def stage_args(props, datas, dev, parse="fast"):
    """The parse kernel's (K2's, K4's, K5's or K6's) and K3's inputs on
    the encode path, and the encoded streams."""
    seen = {}

    def on_stage(name, **values):
        seen.update(values)
    outs = pipeline.encode_batch(props, datas, device=dev, on_stage=on_stage,
                                 parse=parse)
    args = next(seen[k] for k in ("k2_args", "k4_args", "k5_args",
                                  "k6_args") if k in seen)
    return args, seen["k3_args"], outs


def k4_calls(args, other):
    """(prepare, launch) of each build for K4's raw launch on the encode
    path's arguments: its tape and counters."""
    data, candp, run_ends, run_skip, sizes, dicts, prices, good_len, \
        tcap, max_steps = args
    b = data.shape[0]
    dev = data.device
    calls = {}
    for who, lib in (("this", _build.kernel_library("csc_k4")),
                     ("other", other)):
        tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
        out = torch.zeros((4, b), dtype=torch.int32, device=dev)

        def call(lib=lib, tape=tape, out=out):
            parse_ap_kernel.launch(lib, data, candp, run_ends, run_skip,
                                   sizes, dicts, prices, good_len, tape,
                                   max_steps, None, out)
            return tape, out[0], out[1], out[2]
        calls[who] = (tape.zero_, call)
    return calls


def k5_calls(args, other):
    """(prepare, launch) of each build for K5's raw launch on the encode
    path's arguments: its tape, zeroed hash tables, counters and block
    types."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, lazy, \
        tcap, max_steps = args
    b = data.shape[0]
    dev = data.device
    calls = {}
    for who, lib in (("this", _build.kernel_library("csc_k5")),
                     ("other", other)):
        tables = exact_kernel.new_tables(b, hash_bits, hash_width, dev)
        tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
        out = torch.zeros((4, b), dtype=torch.int32, device=dev)
        btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)

        def prepare(tables=tables, tape=tape, btypes=btypes):
            for t in tables + (tape, btypes):
                t.zero_()

        def call(lib=lib, tables=tables, tape=tape, out=out, btypes=btypes):
            exact_kernel.launch(lib, data, blocks, sizes, dicts, hash_bits,
                                hash_width, good_len, lazy, tables, tape,
                                max_steps, out, btypes)
            return tape, out[0], out[1], out[2], out[3], btypes
        calls[who] = (prepare, call)
    return calls


def k6_calls(args, other):
    """(prepare, launch) of each build for K6's raw launch on the encode
    path's arguments: its zeroed hash tables, its model and cell scratch
    (set up by the kernel), tape, counters and block types."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, tcap, \
        bt, bt_sizes = args
    b = data.shape[0]
    dev = data.device
    p2b = exact_ap_kernel.p2b_table(dev)
    calls = {}
    for who, lib in (("this", _build.kernel_library("csc_k6")),
                     ("other", other)):
        scratch = exact_ap_kernel.new_scratch(b, hash_bits, hash_width, dev,
                                              bt, data.shape[1], bt_sizes)
        tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
        out = torch.zeros((3, b), dtype=torch.int32, device=dev)
        btypes = torch.zeros(blocks.shape[:2], dtype=torch.int32, device=dev)

        def prepare(scratch=scratch, tape=tape, btypes=btypes):
            for t in scratch[0] + (scratch[3] or ()) + (tape, btypes):
                t.zero_()

        def call(lib=lib, scratch=scratch, tape=tape, out=out,
                 btypes=btypes):
            exact_ap_kernel.launch(lib, data, blocks, sizes, dicts,
                                   hash_bits, hash_width, good_len, p2b,
                                   scratch, tape, out, btypes, bt, bt_sizes)
            return tape, out[0], out[1], out[2], btypes
        calls[who] = (prepare, call)
    return calls


def parse_cell(name, args, sizes, other, reps):
    """A parse kernel's cell (name "csc_k2", "csc_k4", "csc_k5" or
    "csc_k6"): ms, and ns per position and per LZ token of the longest
    stream (K5: and per lockstep micro-op).  K2 through its wrapper; K4,
    K5 and K6 launched directly (k4_calls, k5_calls, k6_calls)."""
    if name == "csc_k2":
        ms, out = turns(name, other,
                        lambda: parse_kernel.parse_k2(*args), reps)
    else:
        calls = {"csc_k4": k4_calls, "csc_k5": k5_calls,
                 "csc_k6": k6_calls}[name](args, other)
        ms, out = turns(name, other, None, reps, calls)
    tape, tok_cnt = out[0], out[1]
    live = (torch.arange(tape.shape[1], device=tape.device)[None, :]
            < tok_cnt[:, None])
    lz = int(((tape[..., 0] & 7) < K_SENT_A).logical_and(live)
             .sum(dim=1).max())
    pos = max(sizes)
    cell = dict(ms=ms, ns_per_position={k: v * 1e6 / pos
                                        for k, v in ms.items()},
                ns_per_lz_token={k: v * 1e6 / lz for k, v in ms.items()},
                ns_per_byte={k: v * 1e6 / sum(sizes) for k, v in ms.items()},
                streams=len(sizes), longest=dict(positions=pos,
                                                 lz_tokens=lz))
    if name in ("csc_k5", "csc_k6"):
        if not (bool(out[2].all()) and not bool(out[3].any())):
            raise RuntimeError(f"kernel_ab: {name} did not finish every "
                               f"stream")
    if name == "csc_k5":
        ops = int(out[4].max())
        cell["longest"]["micro_ops"] = ops
        cell["ns_per_micro_op"] = {k: v * 1e6 / ops for k, v in ms.items()}
    return cell


def k3_longest(args):
    """The longest stream's tape entries (up to K_END) and modelled bits,
    of K3's arguments."""
    entries = int(((args[0] != K_END).sum(dim=1) + 1).max())
    bits = int(bits_scan.modelled_bits(*args[:4]).max())
    return dict(tape_entries=entries, modelled_bits=bits)


def k3_cell(args, other, reps):
    ms, _ = turns("csc_k3", other, lambda: bits_kernel.code_k3(*args), reps)
    longest = k3_longest(args)
    return dict(ms=ms, ns_per_tape_entry={
        k: v * 1e6 / longest["tape_entries"] for k, v in ms.items()},
        ns_per_modelled_bit={k: v * 1e6 / longest["modelled_bits"]
                             for k, v in ms.items()}, longest=longest)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--json", help="write the results here too")
    ap.add_argument("--kernels", default="K1,K2,K3,K4,K5,K6",
                    help="the kernels whose cells to time")
    a = ap.parse_args(argv)
    want = set(a.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    other_csrc = os.path.join(os.path.abspath(a.other), "csc_tpu_torch",
                              "csrc")
    # a kernel the other checkout does not have (K5, K6 before their
    # ports) is left out
    names = tuple(n for n in ("csc_k1", "csc_k2", "csc_k3", "csc_k4",
                              "csc_k5", "csc_k6")
                  if os.path.exists(os.path.join(other_csrc,
                                                 _build.KERNELS[n][0])))
    want &= {"K" + n[-1] for n in names}
    names = tuple(n for n in names if "K" + n[-1] in want)
    _build.build_kernels(names)
    _build.build_kernels(names, other_csrc)
    other = {n: _build.load(n, other_csrc) for n in names}
    k1, k2, k3, k4, k5, k6 = (other.get(f"csc_k{i}") for i in range(1, 7))
    res = {"card": smi, "resources": {
        "this": {n: _build.resources(n) for n in names},
        "other": {n: _build.resources(n, other_csrc) for n in names}}}
    if "csc_k1" in names:
        res["resources"]["this"]["csc_k1"]["blocks_per_sm"] = \
            decode_kernel.blocks_per_sm()
    for who, r in res["resources"].items():
        print(f"[resources] {who} " + json.dumps(r), flush=True)

    text = corpus.torch_python_text(64 * MB)
    rng = np.random.default_rng(SEED)
    offs = sorted(int(o) for o in rng.choice(len(text) // MB - 2, 4,
                                             replace=False))
    group = [text[o * MB:(o + 1) * MB] for o in offs]
    head = [text[i * 16 * KB:(i + 1) * 16 * KB] for i in range(128)]
    cells = {}
    hp = [props_init(16 * KB, 1) for _ in head]
    _, _, head_blobs = stage_args(hp, head, dev)
    if "K1" in want:
        cells["K1 headline 128 x 16 KB"] = k1_cell(
            hp, head_blobs, [len(d) for d in head], dev, k1, 5)
    gp = [props_init(MB, 1) for _ in group]
    k2_task, k3_task, group_blobs = stage_args(gp, group, dev)
    if "K1" in want:
        cells["K1 extract 256 x 1 MB"] = k1_cell(
            gp * 64, group_blobs * 64, [len(d) for d in group] * 64, dev,
            k1, 2)
    enc = head[:96]
    for level in (1, 2):
        ep = [props_init(16 * KB, level) for _ in enc]
        args2, args3, _ = stage_args(ep, enc, dev)
        if "K2" in want:
            cells[f"K2 m{level} 96 x 16 KB"] = parse_cell(
                "csc_k2", args2, [len(d) for d in enc], k2, 5)
        if "K3" in want:
            cells[f"K3 m{level} 96 x 16 KB"] = k3_cell(args3, k3, 5)
    if "K2" in want:
        cells["K2 task 4 x 1 MB"] = parse_cell(
            "csc_k2", k2_task, [len(d) for d in group], k2, 2)
    if "K3" in want:
        cells["K3 task 4 x 1 MB"] = k3_cell(k3_task, k3, 2)
    ap_streams = head[:32]
    for level in (3, 4, 5) if "K4" in want else ():
        aps = [props_init(16 * KB, level) for _ in ap_streams]
        args4, _, _ = stage_args(aps, ap_streams, dev)
        cells[f"K4 m{level} 32 x 16 KB"] = parse_cell(
            "csc_k4", args4, [len(d) for d in ap_streams], k4, 3)
    for count in (1024, 4096) if "K4" in want else ():
        # 16 KB slices of the text, from the start (wrapping at its end)
        many = [text[i * 16 * KB % (len(text) - 16 * KB):][:16 * KB]
                for i in range(count)]
        args4, _, _ = stage_args([props_init(16 * KB, 3) for _ in many],
                                 many, dev)
        if args4[0].shape[0] != count:
            raise RuntimeError(f"kernel_ab: {count} x 16 KB m3 took more "
                               f"than one K4 launch")
        cells[f"K4 m3 {count} x 16 KB"] = parse_cell(
            "csc_k4", args4, [len(d) for d in many], k4, 2)
        del args4
    if "K4" in want:
        args4, _, _ = stage_args([props_init(MB, 3) for _ in group], group,
                                 dev)
        cells["K4 task m3 4 x 1 MB"] = parse_cell(
            "csc_k4", args4, [len(d) for d in group], k4, 1)
    if "K5" in want:
        for level in (1, 2):
            args5, _, _ = stage_args([props_init(16 * KB, level)
                                      for _ in enc], enc, dev, "exact")
            cells[f"K5 m{level} 96 x 16 KB"] = parse_cell(
                "csc_k5", args5, [len(d) for d in enc], k5, 3)
        for count in (1024, 4096):
            many = [text[i * 16 * KB % (len(text) - 16 * KB):][:16 * KB]
                    for i in range(count)]
            args5, _, _ = stage_args([props_init(16 * KB, 1) for _ in many],
                                     many, dev, "exact")
            if args5[0].shape[0] != count:
                raise RuntimeError(f"kernel_ab: {count} x 16 KB m1 took "
                                   f"more than one K5 launch")
            cells[f"K5 m1 {count} x 16 KB"] = parse_cell(
                "csc_k5", args5, [len(d) for d in many], k5, 1)
            del args5
        args5, _, _ = stage_args(gp, group, dev, "exact")
        cells["K5 task m1 4 x 1 MB"] = parse_cell(
            "csc_k5", args5, [len(d) for d in group], k5, 1)
    if "K6" in want:
        for level in (3, 4):
            args6, _, _ = stage_args([props_init(16 * KB, level)
                                      for _ in enc], enc, dev, "exact")
            cells[f"K6 m{level} 96 x 16 KB"] = parse_cell(
                "csc_k6", args6, [len(d) for d in enc], k6, 3)
        many = [text[i * 16 * KB % (len(text) - 16 * KB):][:16 * KB]
                for i in range(1024)]
        args6, _, _ = stage_args([props_init(16 * KB, 3) for _ in many],
                                 many, dev, "exact")
        if args6[0].shape[0] != len(many):
            raise RuntimeError("kernel_ab: 1 024 x 16 KB m3 took more than "
                               "one K6 launch")
        cells["K6 m3 1024 x 16 KB"] = parse_cell(
            "csc_k6", args6, [len(d) for d in many], k6, 1)
        del args6
        args6, _, _ = stage_args([props_init(MB, 3) for _ in group], group,
                                 dev, "exact")
        cells["K6 task m3 4 x 1 MB"] = parse_cell(
            "csc_k6", args6, [len(d) for d in group], k6, 1)
        # the ring kernel (a checkout before it has none: this one's
        # against itself): 48 KB streams past a 36 KB dictionary
        this6 = _build.kernel_library("csc_k6")
        with open(os.path.join(other_csrc, "encode_k6.cu")) as f:
            k6r = k6 if "bool RING" in f.read() else this6
        ring = [text[i * 48 * KB:(i + 1) * 48 * KB] for i in range(96)]
        args6, _, _ = stage_args([props_init(26 * KB, 3) for _ in ring],
                                 ring, dev)
        if not bool((args6[2] > args6[3]).all()):
            raise RuntimeError("kernel_ab: the ring cell's streams are not "
                               "past their dictionary")
        cells["K6 m3 ring 96 x 48 KB"] = parse_cell(
            "csc_k6", args6, [len(d) for d in ring], k6r, 3)
        # chip_smoke.py phase 9a's 4.67 MB file at m3, one stream: `c
        # -m3`'s launch past the cap, and `c -m3 -d 1m`'s past a 1 MB
        # dictionary (the ring kernel)
        big = corpus.big_file(text, corpus.torch_library_exe(), SEED + 9)
        args6, _, _ = stage_args([props_init(len(big), 3)], [big], dev)
        cells["K6 m3 past the cap 4.67 MB"] = parse_cell(
            "csc_k6", args6, [len(big)], k6, 1)
        args6, _, _ = stage_args([props_init(MB, 3)], [big], dev)
        if not bool((args6[2] > args6[3]).all()):
            raise RuntimeError("kernel_ab: `c -m3 -d 1m`'s stream is not "
                               "past its dictionary")
        cells["K6 m3 past -d 1m 4.67 MB"] = parse_cell(
            "csc_k6", args6, [len(big)], k6r, 1)
        # m5, K6's binary-tree kernel (a checkout before it has none: its
        # cells then time this one's against itself)
        k6t = k6 if hasattr(k6, "csc_k6_bt_launch") else this6
        args6, _, _ = stage_args([props_init(16 * KB, 5) for _ in enc], enc,
                                 dev, "exact")
        cells["K6 m5 96 x 16 KB"] = parse_cell(
            "csc_k6", args6, [len(d) for d in enc], k6t, 3)
        args6, _, _ = stage_args([props_init(16 * KB, 5) for _ in many],
                                 many, dev, "exact")
        if args6[0].shape[0] != len(many):
            raise RuntimeError("kernel_ab: 1 024 x 16 KB m5 took more than "
                               "one K6 launch")
        cells["K6 m5 1024 x 16 KB"] = parse_cell(
            "csc_k6", args6, [len(d) for d in many], k6t, 1)
        del args6
        args6, _, _ = stage_args([props_init(MB, 5) for _ in group], group,
                                 dev, "exact")
        cells["K6 task m5 4 x 1 MB"] = parse_cell(
            "csc_k6", args6, [len(d) for d in group], k6t, 1)
        args6, _, _ = stage_args([props_init(len(big), 5)], [big], dev)
        cells["K6 m5 past the cap 4.67 MB"] = parse_cell(
            "csc_k6", args6, [len(big)], k6t, 1)
    for name, c in cells.items():
        print(f"[ab] {name}: " + " ".join(
            f"{k}={v}" for k, v in c.items()), flush=True)
    res["cells"] = cells
    if a.json:
        with open(a.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
