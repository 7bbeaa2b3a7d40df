#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (csc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; the first failure raises:
  1. device          nvidia-smi name and power limit, torch's device name
  2. build           K1-K6 and the ten spike libraries (csrc/*.cu) with
                     nvcc into build/, one nvcc per source (K6's in five
                     parts, _build.PARTS) started together, with ptxas's
                     reports of K1-K6 and their registers (K5's of each
                     of its two kernels), stack
                     frame, LDL / STL counts (SASS), K1's blocks per SM
                     and K4's, K5's and K6's shared memory a block and
                     blocks per SM (K6's of each of its four kernels:
                     the hash chains' and m5's binary tree's, each for
                     streams their dictionary covers and for the ring);
                     it fails unless each of K1-K6 (all of K6's kernels)
                     has a 0-byte stack frame and no LDL / STL, K1
                     holds two blocks an SM, K4 four or more of 16 KB,
                     K5 eight or more and each K6 kernel four or more;
                     K5's and K6's phase-clock builds (-DK5_PHASES,
                     -DK6_PHASES; csc_tpu_torch/k5_phases.py,
                     k6_phases.py) alongside
  3. corpus          text = this machine's torch/**/*.py, exe = torch/lib/
                     libc10.so, plus seeded random / DLT data
  4. headline        the decode main path: decode_batch of 128 x 16 KB m1
                     text, encoded on the card by encode_batch
  5. encode_headline the encode main path: encode_batch of 96 x 16 KB text
                     (filters on) at m1 and m2, its stages, K2 / K3 times,
                     a round trip through K1
  6. encode_ap       the optimal parse: encode_batch of 32 x 16 KB text
                     (filters on) at m3, m4 and m5, its stages, K4 / K3
                     times, a round trip through K1
  7. encode_extract  4 x 1 MB m1 text (the archiver's autosplit cap); the
                     same streams at m3 and K4's g++ build
                     (csrc/encode_k4_host.cpp) against K4 on the first
                     whole 1 MB stream
  7b. encode_exact   the exact parse: encode_batch(parse="exact") of 96 x
                     16 KB text (filters on) at m1 and m2 and of the 4 x 1
                     MB m1 task, its stages (plan, k5, stitch, k3, remux),
                     K5 / K3 times, a round trip through K1, the fast
                     parse's ratio on the same streams and whether its
                     bytes equal the exact ones; at m1, K5's phase-clock
                     build on the same inputs, its outputs equal to K5's
                     and its split of block 0's cycles; K5's g++ build
                     against K5 on the first whole 1 MB task stream
  7c. encode_exact_ap
                     the exact optimal parse: encode_batch(parse="exact")
                     of 96 x 16 KB text (filters on) at m3, m4 and m5 and
                     of the 4 x 1 MB task at m3 and m5 (m5: K6's
                     binary-tree kernel), its stages (plan, k6, stitch,
                     k3, remux), K6 / K3 times, a round trip through K1,
                     the fast parse's (K4) ratio on the same streams;
                     K6's g++ build (csrc/encode_k6_host.cpp) against K6
                     on the first whole 1 MB task stream (k6_host); at
                     m3, m5 and the m5 task K6's phase-clock build on the
                     same inputs, its outputs equal to K6's and its split
                     of block 0's cycles (k6_phases), and on kernel_ab.py's
                     ring cell (96 x 48 KB m3 past a 36 KB dictionary: the
                     ring kernel) against the normal build's raw launch
  8. extract         one archiver extract group: 256 x 1 MB m1 text
  9. cli             `c` then `d` with --backend cuda on a 1 MB file, `c
                     --parse exact` then `d` on it, and `d` of the first
                     stream under a 266 KB dictionary header, which makes
                     decode_batch regrow its window
  9a. cli_big        `c -m1` (the default parse, which takes the exact
                     parse past the 1 MB cap) and `c -m1 --parse exact`
                     of a ~4.5 MB file (torch text, a libc10.so slice,
                     512 KB random, a DLT ramp, a random 8 KB block
                     repeated after 64 KB of text; two raw chunks), each
                     launching K5 and K3 alone, the two files equal, `d`
                     restoring it byte-exact through K1; K5 on the
                     stream's inputs timed and held to its g++ build on
                     every field, block types included; the no-LZ
                     blocks and those the probe re-typed DT_NORMAL
  9a2. cli_ring      `c -m1 -d 1m` and `c -m2 -d 1m` of phase 9a's file:
                     a dictionary of 1 MB + 10 KB, so the window wraps
                     four times off the 8 KB grid (every run type, the
                     probe's hit); `d` of each restoring it through K1;
                     K5 on the m1 stream's inputs timed and held to its
                     g++ build on every field (run beside phase 9b2)
  9a3. cli_big_m3    `c -m3` of phase 9a's file (past the cap: one K6
                     chain, K6 and K3 alone) and `d` restoring it through
                     K1; K6 on the stream's inputs timed and held to its
                     g++ build on every field, block types included
  9a4. cli_big_m5    the same at m5 (`c -m5`: K6's binary-tree kernel)
  9a5. cli_ring_ap   `c -m3 -d 1m` and `c -m5 -d 1m` of phase 9a's file
                     (the ring wraps four times): K6's ring kernels; `d`
                     of the m3 file restoring it through K1; at m5
                     golden's tree raises IndexError past bt_size where a
                     lap ends in a match, so `c` either writes a file
                     that decodes or raises EncodeError naming the stream
                     (ERR_BT); K6 on each stream's inputs held to its g++
                     build on every field, and on a prefix of those
                     inputs (about 1.1 MB; at m5 past golden's fault,
                     which it reaches at the whole stream's token) timed,
                     its plain version's job in phase 12
  9b. archiver       csarc on a tree built here (the first 1 000 .py
                     files of torch under torch/, libc10.so, 3 MB of
                     seeded random bytes and a 2 MB DLT ramp past the 1
                     MB task cap, an empty file): `a -r` at the default
                     level and at -m1, `a -m2 --parse=exact`, `a -m3
                     --parse=exact` and `a -m5 --parse=exact` of the
                     whole tree (BAD and DLT tasks included; K5, K6),
                     each then `x`
                     (the tree restored byte-exact), `t` and `l`, the
                     trailer's parse (the exact one, always), the walls
                     split by layer;
                     `a` in two processes (CSC_DIST_*, Gloo on localhost,
                     both on this card) equal to the one-process
                     archive; the batch split (parallel/mesh.py) over
                     [cuda:0, cuda:0] on an odd batch equal to one device
  9b2. arc_many      csarc `a` of a tree of 4 096 generated 64-byte files,
                     whose index is past the trailer's 266 KB dictionary
                     (its ring wraps), then `x` (every file restored) and
                     `t`; the trailer read back equals the packed index
 10. encode_parity   on the parity batch (2 KB streams, m1 and m2, and its
                     text and EXE streams at m3 and, exactly, at m3 and
                     m5, its text streams exactly at m1 and m2):
                     the candidates on the card equal those on the CPU;
                     K2, K4, K5 or K6 and the stitch equal their plain
                     versions (on the card's inputs; K6's runs on the
                     host), and K3 its plain version on the card in the
                     m3 group, on the host CPU in phase 12's workers in
                     the others (started as each group ends)
 11. parity          K1 against its plain version (on the card) on the
                     parity batch, a corrupted stream among them
 12. plain           each kernel against its plain version on the first
                     streams of its headline inputs (phases 4-7b; K5's
                     cut by a step budget), K3 on its edge tapes
                     (tests/torch_edge_cases.py), K5 on ring48 (48 KB
                     past its 36 KB dictionary, the whole stream, every
                     field; torch_edge_cases), and K5 against its g++
                     build (csrc/encode_k5_host.cpp) on the first 8
                     whole streams of its m1 cell; K6 on the first 4
                     streams of its m3 and m5 cells, and its ring
                     kernels on the ring's edge streams
                     (torch_edge_cases.exact_ap_ring_cases(3),
                     exact_bt_ring_cases(): golden's IndexError stream
                     among them, ERR_BT), in one batch past 64 KB and
                     those of at most 64 KB in a staged batch, and on
                     phase 9a5's prefixes at m3 and m5; K3 on the
                     parity groups of phase 10 but m3
 13. spikes          the spike probes' main path, `python -m
                     csc_tpu_torch.spikes` (every probe of tools/spike_*.py
                     timed in layouts a and b), then every probe in both
                     layouts, at every size the runner times, against its
                     plain version on the card, with
                     K1-K6's own ns per step of their longest stream (K3:
                     per tape entry and per modelled bit; K5: per
                     position and per lockstep micro-op; K6: per
                     position)
Every count of launches is read around a main-path run (phases 4-9b2,
13; K6's ring kernels: 9a5).
Phase 12's plain versions run on the host's CPU in worker processes
(`chip_smoke.py --plain FILE`, one thread each, at a lower priority than
the main process): those of phases 4-7c start once 7c is timed, so they
overlap phases 8-11, the others once phase 9 is timed; on the card a
plain version takes several ms a lockstep step.  Each line's `at_s` is
the seconds since the script started.  The last two lines are the
kernels' JSON record and the ok line.
"""
import json
import os
import pathlib
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))

from csc_tpu_torch import (_build, corpus, k5_phases, k6_phases,  # noqa: E402
                           spikes)
from csc_tpu_torch.archiver import csarc, index  # noqa: E402
from csc_tpu_torch.constants import (DT_NO_LZ, DT_NORMAL, K_END,  # noqa: E402
                                     K_LIT, K_MATCH, K_REP, K_REP0L1,
                                     K_SENT_A)
from csc_tpu_torch.ops import (bits_kernel, bits_scan, decode_kernel,  # noqa: E402
                               decode_scan, encode_host, exact_ap_kernel,
                               exact_ap_scan, exact_kernel, exact_scan,
                               parse_ap_kernel, parse_ap_scan,
                               parse_kernel, parse_pre, parse_scan, pipeline,
                               stitch)
from csc_tpu_torch.parallel import mesh  # noqa: E402
from csc_tpu_torch.props import props_init, write_properties  # noqa: E402
from csc_tpu_torch.spikes import __main__ as spike_main  # noqa: E402
from csc_tpu_torch.spikes import _probe  # noqa: E402
import torch_edge_cases  # noqa: E402
from test_torch_exact_ap_host import (build_k6_host, k6_args,  # noqa: E402
                                      k6_host)
from test_torch_exact_host import build_k5_host, k5_host  # noqa: E402
from test_torch_parse_ap_host import build_k4_host, k4_host  # noqa: E402
from torch_archiver_trees import listing, run_in, tree_bytes  # noqa: E402

SEED = 20261016
KB, MB = 1024, 1024 * 1024
PARITY_BYTES = 2 * KB                 # per parity stream
HEAD_STREAMS, HEAD_BYTES = 128, 16 * KB   # bench.py's decode headline shape
ENC_STREAMS = 96                      # bench.py's encode shape: 96 x 16 KB
AP_STREAMS = 32                       # bench.py's m3 / m5 shape: 32 x 16 KB
# headline streams each kernel's plain version runs on (the first ones)
PLAIN_STREAMS = {"K1": 16, "K2": 8, "K3": 8, "K4": 4, "K5": 4, "K6": 4}
# K5's plain job: its first streams cut by this step budget (about 40 %
# of a 16 KB m1 stream's micro-ops), K5 launched under the same budget;
# and the g++ build of K5 on this many whole streams
K5_PLAIN_STEPS, K5_HOST_STREAMS = 40_000, 8
PLAIN_WAIT_S = 600                    # the plain workers' deadline
GROUP_SLICES, GROUP_REPEAT, GROUP_BYTES = 4, 64, MB   # one extract group
CLI_BYTES, CLI_DICT = MB, 256 * KB
# the archiver tree: torch's first .py files, and random bytes and a DLT
# ramp over the 1 MB task cap, so that autosplit runs
ARC_PY_FILES, ARC_RANDOM, ARC_RAMP = 1000, 3 * MB, 2 * MB
ARC_WAIT_S = 300                      # the two archiver processes' deadline
# cli_ring's -d: its dictionary is 1 MB + 10 KB, four wraps of phase 9a's
# file off the 8 KB grid
RING_D = "1m"
# cli_ring_ap's plain jobs: a prefix of its stream past the ring's first
# wrap (and at m5 past golden's fault) by this many bytes
RING_PAST = 96 * KB
# arc_many's tree: files of 64 bytes with names of about 40 characters,
# enough for an index past the trailer's 266 KB dictionary
ARC_MANY_FILES, ARC_MANY_BYTES = 4096, 64
MESH_STREAMS = 5                      # an odd batch for the split
NO_STEP_CAP = 1 << 62     # K1 and the plain version run each stream out
FIELDS = {"K1": ("wnd", "blk_log", "wnd_pos", "done", "err", "blk_cnt"),
          "K2": ("tape", "tok_cnt", "done", "err"),
          "K4": ("tape", "tok_cnt", "done", "err", "finds"),
          "K5": ("tape", "tok_cnt", "done", "err", "steps", "btypes"),
          "K6": ("tape", "tok_cnt", "done", "err", "btypes"),
          "K3": ("rc_out", "bc_out", "rc_blkmap", "bc_blkmap", "chunk_log",
                 "stats")}
PLAIN = {"K1": decode_scan.decode_plain, "K2": parse_scan.parse_plain,
         "K3": bits_scan.bits_plain, "K4": parse_ap_scan.parse_ap_plain,
         "K5": exact_scan.exact_plain, "K6": exact_ap_scan.exact_ap_plain}
LAUNCH = {"K1": decode_kernel.decode_k1, "K2": parse_kernel.parse_k2,
          "K3": bits_kernel.code_k3, "K4": parse_ap_kernel.parse_k4,
          "K5": exact_kernel.parse_k5, "K6": exact_ap_kernel.parse_k6}
# arguments of a kernel that are not batch-first (K4's price tables)
WHOLE = {"K4": (6,)}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 peak; int32 is no faster


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


START = time.time()


def phase(tag, **kv):
    """A phase's line; `at_s` the seconds since the script started."""
    kv["at_s"] = f"{time.time() - START:.1f}"
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def sync_time():
    torch.cuda.synchronize()
    return time.time()


def event_ms(fn, reps):
    """Median device time of fn() over `reps` calls (CUDA events), and
    the last call's result."""
    times, out = [], None
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times), out


def bound(nbytes, ops):
    """Least time on the card: bytes over the memory rate or operations
    over the peak rate, the larger; (ms, "bytes" | "operations")."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return (tb * 1e3, "bytes") if tb >= to else (to * 1e3, "operations")


def max_diff(a, b):
    return int(np.abs(a.cpu().numpy().astype(np.int64)
                      - b.cpu().numpy().astype(np.int64)).max(initial=0))


def compare(tag, kernel, got, want):
    """Max abs difference of two output tuples of `kernel`, field by
    field; fails on any difference (the tolerance is 0)."""
    err = 0
    for name, g, w in zip(FIELDS[kernel], got, want):
        d = max_diff(g, w)
        check(d == 0, f"{tag}: {kernel} {name} differs (max abs {d})")
        err = max(err, d)
    return err


def first_args(args, k, kernel):
    """A kernel's arguments cut to its first k streams (every tensor
    argument but those WHOLE names is batch-first)."""
    return tuple(a[:k].contiguous() if torch.is_tensor(a) and i not in
                 WHOLE.get(kernel, ()) else a for i, a in enumerate(args))


def to_cpu(x):
    if torch.is_tensor(x):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    return x


def coded_lengths(ends):
    """Coded bytes of each stream of a batch from its [B, NB] cumulative
    block-end table (padded with 0x7FFFFFFF)."""
    ends = ends.cpu().numpy().astype(np.int64)
    return np.where(ends < 0x7FFFFFFF, ends, 0).max(axis=1)


def coded_length(ends):
    """Total coded bytes of a batch."""
    return int(coded_lengths(ends).sum())


def demux_upload(props, blobs, dev):
    rc, bc, rce, bce = pipeline._demux(props, blobs, [0] * len(blobs))
    return [torch.from_numpy(a).to(dev) for a in (rc, bc, rce, bce)]


class Stages:
    """encode_batch's on_stage hook: a synchronize and a timestamp after
    each stage, and the values the stages hand on."""

    def __init__(self):
        self.t, self.names, self.values = [time.time()], [], {}

    def __call__(self, name, **values):
        self.t.append(sync_time())
        self.names.append(name)
        self.values.update(values)

    def ms(self):
        return {n: round((b - a) * 1e3, 3)
                for n, a, b in zip(self.names, self.t, self.t[1:])}


def plain_job(tag, kernel, args, reps):
    """The kernel on the first PLAIN_STREAMS[kernel] streams of `args`
    (the inputs a main path gave it; K5 under the budget K5_PLAIN_STEPS):
    its time and outputs, and the job that holds them against the plain
    version in phase 12."""
    k = PLAIN_STREAMS[kernel]
    sub = first_args(args, k, kernel)
    if kernel == "K5":
        sub = sub[:-1] + (K5_PLAIN_STEPS,)
    ms, out = event_ms(lambda: LAUNCH[kernel](*sub), reps)
    return dict(tag=tag, kernel=kernel, streams=k, args=to_cpu(sub),
                kernel_out=to_cpu(out), kernel_ms=ms)


def same_rows(tag, kernel, full, sub, k):
    """The first k streams of a full-batch call equal a k-stream call."""
    if kernel == "K3":
        check(max_diff(full[5][:, :k], sub[5]) == 0, f"{tag}: K3 stats of "
              f"the full call differ from the {k}-stream call")
        full, sub = full[:5], sub[:5]
    for name, f, s in zip(FIELDS[kernel], full, sub):
        check(max_diff(f[:k], s) == 0, f"{tag}: {kernel} {name} of the "
              f"full call differs from the {k}-stream call")


# ----------------------------------------------------------- phase 5 parts
def parse_stage(values):
    """The parse kernel of an encode pass from its on_stage values: K2 at
    m1 / m2, K4 at m3-m5, K5 (m1 / m2) or K6 (m3 / m4) under the exact
    parse; (kernel, its arguments, its outputs)."""
    kernel = ("K6" if "k6_args" in values else
              "K5" if "k5_args" in values else
              "K4" if "k4_args" in values else "K2")
    low = kernel.lower()
    return kernel, values[low + "_args"], values[low + "_out"]


def encode_cell(tag, props, datas, dev, reps, parse="fast"):
    """The encode main path on one preset group: encode_batch once with
    the launch counts set to 0 (it must launch its parse kernel, K2, K4
    or, under parse="exact", K5 or K6, and K3), `reps` timed calls, one pass
    split by stage, a round trip through K1, and the parse kernel and K3
    timed on the inputs that pass gave them.  Returns the phase's
    numbers."""
    parse_kernel.LAUNCHES = parse_ap_kernel.LAUNCHES = 0
    exact_kernel.LAUNCHES = bits_kernel.LAUNCHES = 0
    exact_ap_kernel.LAUNCHES = exact_ap_kernel.TREE_LAUNCHES = 0
    outs = pipeline.encode_batch(props, datas, device=dev, parse=parse)
    counts = {"K2": parse_kernel.LAUNCHES, "K4": parse_ap_kernel.LAUNCHES,
              "K5": exact_kernel.LAUNCHES, "K6": exact_ap_kernel.LAUNCHES,
              "K3": bits_kernel.LAUNCHES}
    tree_launches = exact_ap_kernel.TREE_LAUNCHES
    walls = []
    for _ in range(reps):
        t0 = time.time()
        again = pipeline.encode_batch(props, datas, device=dev, parse=parse)
        walls.append(time.time() - t0)
        check(again == outs, f"{tag}: encode_batch is not deterministic")
    stages = Stages()
    check(pipeline.encode_batch(props, datas, device=dev, on_stage=stages,
                                parse=parse) == outs,
          f"{tag}: the staged pass differs from encode_batch")
    back = pipeline.decode_batch(props, outs,
                                 out_sizes=[len(d) for d in datas],
                                 device=dev)
    check(back == datas, f"{tag}: the round trip through K1 differs")
    v = stages.values
    parse_k, p_args, p_out = parse_stage(v)
    launches = {parse_k: counts[parse_k], "K3": counts["K3"]}
    check(min(launches.values()) >= 1 and sum(counts.values()) == sum(
        launches.values()), f"{tag}: the encode path did not launch "
        f"{parse_k} and K3 alone ({counts})")
    k3_args = v["k3_args"]
    p_ms, p_out2 = event_ms(lambda: LAUNCH[parse_k](*p_args), reps)
    k3_ms, k3_out = event_ms(lambda: bits_kernel.code_k3(*k3_args), reps)
    compare(f"{tag} relaunch", parse_k, p_out2, p_out)
    compare(f"{tag} relaunch", "K3", k3_out, v["k3_out"])
    total = sum(len(d) for d in datas)
    tape, tok_cnt = p_out[0], p_out[1]
    live = (torch.arange(tape.shape[1], device=tape.device)[None, :]
            < tok_cnt[:, None])
    lz = int(((tape[..., 0] & 7) < K_SENT_A).logical_and(live).sum())
    ntok = int(tok_cnt.sum())
    if parse_k == "K5":
        # K5 reads the data once and writes 8 bytes a token; it takes one
        # operation at least for each lockstep micro-op it counts
        probes = lz
        p_bound = bound(total + 8 * ntok, int(p_out[4].long().sum()))
    elif parse_k == "K6":
        # K6 reads the data once and writes 8 bytes a token; it takes one
        # operation at least for each position it parses
        probes = lz
        p_bound = bound(total + 8 * ntok, total)
    else:
        # The parse reads all C candidate words at each position it
        # probes and writes 8 bytes a token.  K2: every LZ token (kinds
        # below K_SENT_A) starts at a probed position (each step emits
        # one token and probes at most twice, and a step that probes none
        # follows one that probed twice), so the LZ tokens are a lower
        # bound on the probes; it reads the data only where it extends a
        # match, so its bound leaves the data out.  K4's lanes run at the
        # FIND positions it counts (`finds`, held to the plain version's
        # count: not the cap, nor the positions a post-stretch match
        # covers) and it reads the data once.
        probes = int(p_out[4].sum()) if parse_k == "K4" else lz
        c = p_args[1].shape[1]
        data_bytes = total if parse_k == "K4" else 0
        p_bound = bound(data_bytes + 4 * c * probes + 8 * ntok,
                        (c + 4) * probes)
    # K3 reads 16 bytes a token up to K_END and writes the coded bytes,
    # one operation per coded bit.
    per_tape = (k3_args[0] != K_END).sum(dim=1) + 1
    used = int(per_tape.sum())
    # the longest stream's steps, for the per-step table (phase 13)
    per_lz = ((tape[..., 0] & 7) < K_SENT_A).logical_and(live).sum(dim=1)
    longest = dict(positions=max(len(d) for d in datas),
                   lz_tokens=int(per_lz.max()), tokens=int(tok_cnt.max()),
                   tape_entries=int(per_tape.max()))
    if parse_k == "K5":
        longest["micro_ops"] = int(p_out[4].max())
    stats = k3_out[5].cpu().numpy().astype(np.int64)
    coded_bytes = int(stats[0].sum() + stats[1].sum())
    k3_bound = bound(16 * used + coded_bytes, 8 * coded_bytes)
    longest["modelled_bits"] = int(bits_scan.modelled_bits(
        *k3_args[:4]).max())
    return dict(wall=statistics.median(walls), outs=outs, parse=parse_k,
                parse_ms=p_ms, k3_ms=k3_ms, launches=launches,
                tree_launches=tree_launches,
                layers=stages.ms(), ratio=sum(len(o) for o in outs) / total,
                total=total, parse_bound=p_bound, k3_bound=k3_bound,
                lz=lz, probes=probes, ntok=ntok, longest=longest,
                parse_args=p_args, parse_out=p_out, k3_args=k3_args,
                k3_out=k3_out)


def drop_inputs(cell):
    """Free a cell's kernel inputs and outputs once its jobs are made."""
    for key in ("parse_args", "parse_out", "k3_args", "k3_out"):
        del cell[key]


# ---------------------------------------------------------- phase 10 parts
def encode_parity(props, plans, idxs, dev, tag, k3_jobs=None):
    """One preset group of the parity batch through encode_group, its
    stages held to their counterparts on the same inputs: the candidates
    (of K2 and K4) and the stitch on the CPU, the parse kernel (K2, K4
    or, for exact plans, K5 or K6) against its plain version on the
    card's inputs, and K3 against its plain version there too, or, given
    a list k3_jobs, in a job appended to it (`tag`) that phase 12's
    workers run on the host CPU.  Returns (streams, the parse kernel,
    fields compared, max abs difference, plain seconds of the parse kernel
    and of K3 on the card, 0 for a job)."""
    p0 = props[idxs[0]]
    stages = Stages()
    outs = pipeline.encode_group(props, plans, idxs, dev, on_stage=stages)
    v = stages.values
    kernel, p_args, p_out = parse_stage(v)
    err = 0
    fast = kernel not in ("K5", "K6")
    if fast:
        data, _, run_ends = p_args[:3]
        width = (p0.hash_width or 8) if kernel == "K4" else p0.hash_width
        cand_cpu = parse_pre.precompute_candidates(
            data.cpu(), run_ends.cpu(), p0.hash_bits, width)
        err = max_diff(v["cand"], cand_cpu)
        check(err == 0, "encode parity: candidates differ from the CPU's")
    t0 = sync_time()
    want = PLAIN[kernel](*p_args)
    parse_plain_s = sync_time() - t0
    err = max(err, compare("encode parity", kernel, p_out, want))
    tape, data, run_tables = v["stitch_args"]
    ref = stitch.stitch_tapes(tape.cpu(), data.cpu(), run_tables)
    for name, g, w in zip("kabc", v["k3_args"][:4], ref[:4]):
        d = max_diff(g, w)
        check(d == 0, f"encode parity: stitched tape {name} differs")
    k3_plain_s = 0.0
    if k3_jobs is None:
        t0 = sync_time()
        want = bits_scan.bits_plain(*v["k3_args"])
        k3_plain_s = sync_time() - t0
        err = max(err, compare("encode parity", "K3", v["k3_out"], want))
    else:
        k3_jobs.append(dict(tag=f"parity {tag}", kernel="K3",
                            streams=len(idxs), args=to_cpu(v["k3_args"]),
                            kernel_out=to_cpu(v["k3_out"]), kernel_ms=None))
    nfields = fast + len(FIELDS[kernel]) + 4 + len(FIELDS["K3"])
    return outs, kernel, nfields, err, parse_plain_s, k3_plain_s


def k3_edge_jobs(dev):
    """K3 on the card on each batch of its edge tapes, and the jobs that
    hold it to its plain version (on the host CPU) in phase 12."""
    jobs = []
    for name, tapes, args, _ in torch_edge_cases.k3_cases():
        cpu = tuple(torch.from_numpy(t) for t in tapes) + args
        card = tuple(t.to(dev) for t in cpu[:4]) + args
        ms, out = event_ms(lambda: bits_kernel.code_k3(*card), 1)
        jobs.append(dict(tag=f"k3_edges {name}", kernel="K3",
                         streams=tapes[0].shape[0], args=cpu,
                         kernel_out=to_cpu(out), kernel_ms=ms))
    return jobs


def ring_plain_job(dev):
    """K5 on the card on torch_edge_cases.ring48 (48 KB at m1 under a 36
    KB dictionary: a ring off the 8 KB grid, a BAD run across its end),
    the inputs encode_batch gives it, the full step budget: its time and
    outputs, and the job that holds every field to its plain version (on
    the host CPU) in phase 12."""
    _, p, data = torch_edge_cases.ring48(1)
    stages = Stages()
    pipeline.encode_batch([p], [data], device=dev, parse="exact",
                          on_stage=stages)
    args = stages.values["k5_args"]
    ms, out = event_ms(lambda: exact_kernel.parse_k5(*args), 3)
    check(bool(out[2].all()) and not bool(out[3].any()),
          "ring48: K5 did not finish the stream")
    return dict(tag="ring48", kernel="K5", streams=1, args=to_cpu(args),
                kernel_out=to_cpu(out), kernel_ms=ms)


# ---------------------------------------------------------- phase 12 parts
def start_plain(jobs, sdir, first=0):
    """One worker process a job, all started together, on the CPU (the
    jobs' files numbered from `first`)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, job in enumerate(jobs, first):
        path = os.path.join(sdir, f"plain_{i}.pt")
        torch.save({"kernel": job["kernel"], "args": job["args"]}, path)
        with open(path + ".log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--plain", path],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        job["path"] = path
    return procs


def finish_plain(jobs, procs):
    """Wait for the workers; hold each kernel's outputs to its plain
    version's.  Returns the largest difference (0, or it fails)."""
    deadline = time.time() + PLAIN_WAIT_S
    err = 0
    for job, proc in zip(jobs, procs):
        try:
            rc = proc.wait(timeout=max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"chip_smoke: the plain {job['kernel']} of "
                               f"{job['tag']} ran past {PLAIN_WAIT_S} s")
        with open(job["path"] + ".log") as f:
            log = f.read()
        check(rc == 0, f"plain {job['kernel']} of {job['tag']} failed:\n"
              f"{log[-2000:]}")
        res = torch.load(job["path"] + ".out")
        job["plain_s"] = res["seconds"]
        d = compare(f"{job['tag']} (first {job['streams']} streams)",
                    job["kernel"], job["kernel_out"], res["out"])
        err = max(err, d)
        phase("plain", kernel=job["kernel"], on=job["tag"],
              streams=job["streams"], fields_compared=len(FIELDS[job[
                  "kernel"]]), max_abs_err=d,
              plain_cpu_s=f"{res['seconds']:.3f}",
              **({} if job["kernel_ms"] is None else
                 {"kernel_ms": f"{job['kernel_ms']:.3f}"}))
    return err


def plain_worker(path):
    """`chip_smoke.py --plain FILE`: the plain version of the job in FILE
    on its CPU inputs, one thread; writes its outputs and seconds to
    FILE.out."""
    torch.set_num_threads(1)
    # below the main process, whose plain versions on the card (phases 10
    # and 11) are bound by its one core's kernel launches
    os.nice(10)
    job = torch.load(path, weights_only=False)
    t0 = time.time()
    out = PLAIN[job["kernel"]](*job["args"])
    torch.save({"out": out, "seconds": time.time() - t0}, path + ".out")


# ---------------------------------------------------------- phase 9a parts
def big_file(text, exe):
    """Phase 9a's file past the 1 MB cap (about 4.5 MB, over two 2 MB raw
    chunks), corpus.big_file: torch text, a libc10.so slice, random
    bytes, a DLT ramp, a random 8 KB block, text, the same block again
    (the duplicate-block probe re-types it DT_NORMAL) and text."""
    return corpus.big_file(text, exe, SEED + 9)


def cli_big_phase(dev, data, sdir, k5_lib):
    """Phase 9a: `c -m1` (routed past the cap) and `c -m1 --parse exact`
    of `data`, `d` of each; K5 on the stream's inputs timed and held to
    its g++ build.  Returns ({run: K5 launches}, K5's ms, its bound, the
    longest stream's numbers for the kernels line)."""
    from csc_tpu_torch import cli
    src = os.path.join(sdir, "big.bin")
    with open(src, "wb") as f:
        f.write(data)
    check(len(data) > 4 * MB, "cli_big: the file is not past 4 MB")
    blobs, launches, walls = {}, {}, {}
    for tag, extra in (("default", []), ("exact", ["--parse", "exact"])):
        enc, dst = (os.path.join(sdir, f"big_{tag}.{x}")
                    for x in ("csc", "out"))
        exact_kernel.LAUNCHES = parse_kernel.LAUNCHES = 0
        bits_kernel.LAUNCHES = 0
        t0 = time.time()
        check(cli.main(["c", "-m", "1", *extra, "--backend", "cuda", src,
                        enc]) == 0, f"cli_big {tag}: c failed")
        t1 = time.time()
        launches[f"cli_c_big {tag}"] = exact_kernel.LAUNCHES
        check(exact_kernel.LAUNCHES >= 1 and bits_kernel.LAUNCHES >= 1
              and parse_kernel.LAUNCHES == 0, f"cli_big {tag}: c did not "
              f"launch K5 and K3 alone")
        decode_kernel.LAUNCHES = 0
        check(cli.main(["d", "--backend", "cuda", enc, dst]) == 0,
              f"cli_big {tag}: d failed")
        t2 = time.time()
        check(decode_kernel.LAUNCHES >= 1, f"cli_big {tag}: d did not "
              f"launch K1")
        with open(dst, "rb") as f:
            check(f.read() == data, f"cli_big {tag}: d restored other "
                  f"bytes")
        with open(enc, "rb") as f:
            blobs[tag] = f.read()
        walls[tag] = (t1 - t0, t2 - t1)
    check(blobs["default"] == blobs["exact"], "cli_big: the default parse "
          "past the cap wrote other bytes than --parse exact")
    # the same encode staged: K5's inputs, timed and held to the g++ build
    props = props_init(len(data), 1)
    stages = Stages()
    outs = pipeline.encode_batch([props], [data], device=dev,
                                 on_stage=stages)
    check(write_properties(props) + outs[0] == blobs["default"],
          "cli_big: the staged encode differs from the CLI's")
    v = stages.values
    args, out = v["k5_args"], v["k5_out"]
    k5_ms, again = event_ms(lambda: exact_kernel.parse_k5(*args), 1)
    compare("cli_big relaunch", "K5", again, out)
    t0 = time.time()
    host = k5_host(k5_lib, to_cpu(args))
    gxx_s = time.time() - t0
    err = compare("cli_big against K5's g++ build", "K5", out,
                  [torch.from_numpy(h) for h in host])
    plan = v["plans"][0]
    btypes = out[5][0].cpu().numpy()
    # the blocks the plan types BAD / ENTROPY / DLT (a skipped one by the
    # type it takes after such a block), and those K5 typed DT_NORMAL
    nolz = (plan.blocks[:, 1] & encode_host.BLK_TYPE) >= DT_NO_LZ
    nolz_blocks = int(nolz.sum())
    retyped = int((btypes[nolz] == DT_NORMAL).sum())
    check(retyped >= 1, "cli_big: the probe re-typed no block")
    ntok = int(out[1].sum())
    bnd = bound(len(data) + 8 * ntok, int(out[4].long().sum()))
    runs = encode_host.exact_run_table(plan, btypes)
    phase("cli_big", bytes=len(data), compressed=len(blobs["default"]),
          ratio=f"{len(blobs['default']) / len(data):.6f}",
          c_s=f"{walls['default'][0]:.3f}", d_s=f"{walls['default'][1]:.3f}",
          exact_c_s=f"{walls['exact'][0]:.3f}",
          exact_d_s=f"{walls['exact'][1]:.3f}",
          c_mbps=f"{len(data) / walls['default'][0] / 1e6:.2f}",
          k5_ms=f"{k5_ms:.3f}", k5_bound_ms=f"{bnd[0]:.6f}",
          micro_ops=int(out[4][0]), tokens=ntok, blocks=len(plan.blocks),
          runs=len(runs), run_types=",".join(sorted(
              {str(r[0]) for r in runs})), no_lz_blocks=nolz_blocks,
          retyped_normal=retyped,
          gxx_s=f"{gxx_s:.2f}", gxx_max_abs_err=err,
          round_trip="K1 byte-exact",
          launches_k5=launches["cli_c_big default"],
          launches_k5_exact=launches["cli_c_big exact"])
    phase("cli_big_layers", **stages.ms())
    return launches, k5_ms, bnd, err


def cli_big_ap_phase(dev, data, sdir, k6_lib, level):
    """Phases 9a3 / 9a4: `c -m3` or `c -m5` of `data` (past the cap,
    routed to the exact parse: one K6 chain; at m5 K6's binary-tree
    kernel) and `d`; K6 on the stream's inputs timed and held to its g++
    build on every field.  Returns ({run: K6 launches}, K6's ms, its
    bound, the g++ comparison's max abs difference)."""
    from csc_tpu_torch import cli
    tag = f"cli_big_m{level}"
    src = os.path.join(sdir, "big.bin")
    enc, dst = (os.path.join(sdir, f"big_m{level}.{x}")
                for x in ("csc", "out"))
    exact_ap_kernel.LAUNCHES = parse_ap_kernel.LAUNCHES = 0
    exact_ap_kernel.TREE_LAUNCHES = bits_kernel.LAUNCHES = 0
    t0 = time.time()
    check(cli.main(["c", "-m", str(level), "--backend", "cuda", src,
                    enc]) == 0, f"{tag}: c failed")
    t1 = time.time()
    launches = {f"cli_c_big m{level}": exact_ap_kernel.LAUNCHES}
    check(exact_ap_kernel.LAUNCHES >= 1 and bits_kernel.LAUNCHES >= 1
          and parse_ap_kernel.LAUNCHES == 0,
          f"{tag}: c did not launch K6 and K3 alone")
    check(exact_ap_kernel.TREE_LAUNCHES == (exact_ap_kernel.LAUNCHES
                                            if level == 5 else 0),
          f"{tag}: c launched K6's binary-tree kernel "
          f"{exact_ap_kernel.TREE_LAUNCHES} times")
    decode_kernel.LAUNCHES = 0
    check(cli.main(["d", "--backend", "cuda", enc, dst]) == 0,
          f"{tag}: d failed")
    t2 = time.time()
    check(decode_kernel.LAUNCHES >= 1, f"{tag}: d did not launch K1")
    with open(dst, "rb") as f:
        check(f.read() == data, f"{tag}: d restored other bytes")
    with open(enc, "rb") as f:
        blob = f.read()
    props = props_init(len(data), level)
    stages = Stages()
    outs = pipeline.encode_batch([props], [data], device=dev,
                                 on_stage=stages)
    check(write_properties(props) + outs[0] == blob,
          f"{tag}: the staged encode differs from the CLI's")
    v = stages.values
    args, out = v["k6_args"], v["k6_out"]
    with ThreadPoolExecutor(1) as pool:
        # the g++ build on the host's CPU while the card relaunches K6
        job = pool.submit(lambda a=to_cpu(args): (
            time.time(), k6_host(k6_lib, a), time.time()))
        k6_ms, again = event_ms(lambda: exact_ap_kernel.parse_k6(*args), 1)
        compare(f"{tag} relaunch", "K6", again, out)
        t3, host, t4 = job.result()
    gxx_s = t4 - t3
    err = compare(f"{tag} against K6's g++ build", "K6", out,
                  [torch.from_numpy(h) for h in host])
    plan = v["plans"][0]
    btypes = out[4][0].cpu().numpy()
    runs = encode_host.exact_run_table(plan, btypes)
    ntok = int(out[1].sum())
    bnd = bound(len(data) + 8 * ntok, len(data))
    extra = {}
    if level == 5:
        extra["tree_bytes"] = exact_ap_kernel.tree_bytes(
            1, len(data), args[8], args[9])
    phase(tag, bytes=len(data), compressed=len(blob),
          ratio=f"{len(blob) / len(data):.6f}", c_s=f"{t1 - t0:.3f}",
          d_s=f"{t2 - t1:.3f}", c_mbps=f"{len(data) / (t1 - t0) / 1e6:.2f}",
          k6_ms=f"{k6_ms:.3f}", k6_bound_ms=f"{bnd[0]:.6f}",
          ns_per_position=f"{k6_ms * 1e6 / len(data):.1f}", tokens=ntok,
          blocks=len(plan.blocks), runs=len(runs), run_types=",".join(
              sorted({str(r[0]) for r in runs})), gxx_s=f"{gxx_s:.2f}",
          gxx_max_abs_err=err, round_trip="K1 byte-exact",
          launches_k6=launches[f"cli_c_big m{level}"], **extra)
    phase(f"{tag}_layers", **stages.ms())
    return launches, k6_ms, bnd, err


def cli_ring_ap_phase(dev, data, sdir, k6_lib):
    """Phase 9a5: `c -m3 -d 1m` and `c -m5 -d 1m` of `data` (phase 9a's
    file, at sdir/big.bin: a 1 MB + 10 KB dictionary, the ring wrapping
    four times), `d` of each file written; K6's ring kernel (at m5 its
    tree's) on each stream's inputs held to its g++ build on every field,
    the m3 one on the host's CPU while the m5 run goes on.  At m5
    bt_size is the dictionary, and golden's binary tree raises IndexError
    wherever a lap ends in a match, so `c -m5` either writes a file that
    decodes or raises EncodeError naming the stream (err ERR_BT); either
    way the g++ build agrees on every field.  Returns ({run: K6 ring
    launches}, {run: K6 tree ring launches}, K6's ms on the m3 stream, its
    bound, the max abs difference against g++)."""
    from csc_tpu_torch import cli
    from csc_tpu_torch.constants import ERR_BT
    src = os.path.join(sdir, "big.bin")
    ring, tree_ring, res, host, jobs = {}, {}, {}, {}, []
    with ThreadPoolExecutor(1) as pool:
        for level in (3, 5):
            tag = f"cli_ring_ap m{level}"
            enc, dst = (os.path.join(sdir, f"ring_m{level}.{x}")
                        for x in ("csc", "out"))
            exact_ap_kernel.LAUNCHES = parse_ap_kernel.LAUNCHES = 0
            exact_ap_kernel.RING_LAUNCHES = 0
            exact_ap_kernel.TREE_RING_LAUNCHES = 0
            bits_kernel.LAUNCHES = 0
            refused = ""
            t0 = time.time()
            try:
                check(cli.main(["c", "-m", str(level), "-d", RING_D,
                                "--backend", "cuda", src, enc]) == 0,
                      f"{tag}: c failed")
            except pipeline.EncodeError as e:
                check(level == 5 and e.streams == [0]
                      and "IndexError" in str(e),
                      f"{tag}: c raised {e}")
                refused = str(e)
            t1 = time.time()
            # the m3 / m4 ring kernel's launches, and the tree's
            ring[f"cli_c_ring m{level}"] = (
                exact_ap_kernel.RING_LAUNCHES
                - exact_ap_kernel.TREE_RING_LAUNCHES)
            tree_ring[f"cli_c_ring m{level}"] = \
                exact_ap_kernel.TREE_RING_LAUNCHES
            check(exact_ap_kernel.RING_LAUNCHES >= 1
                  and parse_ap_kernel.LAUNCHES == 0
                  and (refused or bits_kernel.LAUNCHES >= 1),
                  f"{tag}: c did not launch K6's ring kernel (and K3)")
            check(exact_ap_kernel.TREE_RING_LAUNCHES
                  == (exact_ap_kernel.RING_LAUNCHES if level == 5 else 0),
                  f"{tag}: c launched K6's tree ring kernel "
                  f"{exact_ap_kernel.TREE_RING_LAUNCHES} times")
            d_s = 0.0
            if not refused:
                decode_kernel.LAUNCHES = 0
                check(cli.main(["d", "--backend", "cuda", enc, dst]) == 0,
                      f"{tag}: d failed")
                d_s = time.time() - t1
                check(decode_kernel.LAUNCHES >= 1,
                      f"{tag}: d did not launch K1")
                with open(dst, "rb") as f:
                    check(f.read() == data, f"{tag}: d restored other "
                          f"bytes")
            props = props_init(cli._parse_size(RING_D), level)
            check(len(data) > 4 * props.dict_size,
                  f"{tag}: the dictionary does not wrap four times")
            stages = Stages()
            try:
                pipeline.encode_batch([props], [data], device=dev,
                                      on_stage=stages)
                check(not refused, f"{tag}: the staged encode finished "
                      f"where c was refused")
            except pipeline.EncodeError:
                check(bool(refused), f"{tag}: the staged encode was "
                      f"refused where c finished")
            args, out = stages.values["k6_args"], stages.values["k6_out"]
            check(int(out[3][0]) == (ERR_BT if refused else 0),
                  f"{tag}: K6's err is {int(out[3][0])}")
            host[level] = pool.submit(lambda a=to_cpu(args): (
                time.time(), k6_host(k6_lib, a), time.time()))
            k6_ms, again = event_ms(
                lambda: exact_ap_kernel.parse_k6(*args), 1)
            compare(f"{tag} relaunch", "K6", again, out)
            ntok = int(out[1].sum())
            res[level] = dict(
                c_s=t1 - t0, d_s=d_s, refused=bool(refused), ms=k6_ms,
                bound=bound(len(data) + 8 * ntok, len(data)), out=out,
                tok=ntok, dict_size=props.dict_size,
                compressed=0 if refused else os.path.getsize(enc))
            jobs.append(ring_prefix_job(args, level, out, bool(refused)))
        err = 0
        for level in (3, 5):
            t0, h, t1 = host[level].result()
            r = res[level]
            e = compare(f"cli_ring_ap m{level} against K6's g++ build",
                        "K6", r["out"], [torch.from_numpy(x) for x in h])
            err = max(err, e)
            phase("cli_ring_ap", level=f"m{level}", bytes=len(data),
                  dict_size=r["dict_size"], wraps=len(data) // r["dict_size"],
                  c_s=f"{r['c_s']:.3f}", d_s=f"{r['d_s']:.3f}",
                  outcome="refused: golden's IndexError (ERR_BT)"
                  if r["refused"] else "written, K1 byte-exact",
                  compressed=r["compressed"], k6_ms=f"{r['ms']:.3f}",
                  k6_bound_ms=f"{r['bound'][0]:.6f}",
                  ns_per_position=f"{r['ms'] * 1e6 / len(data):.1f}",
                  tokens=r["tok"], err=int(r["out"][3][0]),
                  gxx_s=f"{t1 - t0:.2f}", gxx_max_abs_err=e,
                  launches_k6_ring=ring[f"cli_c_ring m{level}"],
                  launches_k6_tree_ring=tree_ring[f"cli_c_ring m{level}"],
                  plain_prefix_bytes=jobs[(level - 3) // 2]["bytes"])
    check(sum(ring.values()) >= 1 and sum(tree_ring.values()) >= 1,
          "cli_ring_ap: a K6 ring kernel was not launched")
    return ring, tree_ring, res[3]["ms"], res[3]["bound"], err, jobs


def tape_bytes(tape):
    """The input bytes that a K6 tape's literals, matches and reps cover
    (tape [T, 2] of (kind | wire_len << 3, dist_code))."""
    kind, wire = tape[:, 0] & 7, tape[:, 0] >> 3
    one = (kind == K_LIT) | (kind == K_REP0L1)
    long = (kind == K_MATCH) | (kind == K_REP)
    return int(one.sum()) + int((wire[long] + 2).sum())


def ring_prefix_job(args, level, full, refused):
    """K6 on the card on a prefix of the inputs that phase 9a5's encode
    handed it (args, its one stream under a 1 MB ring; full, its outputs):
    the LZ input and block table up to the first block end RING_PAST bytes
    past the ring's first wrap (at m5, where golden's tree raised on the
    whole stream, past the bytes its tape covers, so that the prefix ends
    past the fault).  Its time and outputs, and the job that holds every
    field to its plain version (on the host CPU) in phase 12.  At m5 the
    prefix reaches golden's IndexError at the whole stream's token, its
    tokens up to there the whole stream's; at m3 it parses the prefix
    through."""
    from csc_tpu_torch.constants import ERR_BT
    tag = f"cli_ring_ap m{level} prefix"
    data, blocks, sizes, dicts = args[:4]
    dict_size, tok = int(dicts[0]), int(full[1][0])
    least = dict_size + RING_PAST
    if refused:
        least = max(least, tape_bytes(full[0][0, :tok].cpu()) + RING_PAST)
    ends = blocks[0, :, 0].contiguous()
    k = min(int(torch.searchsorted(ends, least)), ends.shape[0] - 1)
    n = int(ends[k])
    check(n > dict_size, f"{tag}: the stream does not wrap")
    check(exact_ap_kernel.smem_bytes(n) < n, f"{tag}: the prefix is staged")
    pre = (data[:, :n].contiguous(), blocks[:, :k + 1].contiguous(),
           torch.full_like(sizes, n), dicts) + tuple(args[4:7]) + (
        parse_scan.tape_capacity(n, k + 1),) + tuple(args[8:])
    ms, out = event_ms(lambda: exact_ap_kernel.parse_k6(*pre), 1)
    if refused:
        check(int(out[3][0]) == ERR_BT and int(out[1][0]) == tok
              and torch.equal(out[0][0, :tok], full[0][0, :tok]),
              f"{tag}: the prefix did not fault at the whole stream's "
              f"token {tok} (err {int(out[3][0])}, {int(out[1][0])} "
              f"tokens)")
    else:
        check(int(out[2][0]) == 1 and int(out[3][0]) == 0,
              f"{tag}: K6 did not parse the prefix through")
    ntok = int(out[1][0])
    return dict(tag=tag, kernel="K6", streams=1, args=to_cpu(pre),
                kernel_out=to_cpu(out), kernel_ms=ms, bytes=n, tok=ntok,
                parsed=tape_bytes(out[0][0, :ntok].cpu()),
                dict_size=dict_size)


def ring_ap_plain_job(dev, level, staged=False):
    """K6 on the card on the ring's edge streams (torch_edge_cases
    `exact_ap_ring_cases(3)`, or at m5 `exact_bt_ring_cases()`, golden's
    IndexError stream among them; staged: those of at most 64 KB alone, a
    batch K6 stages in shared memory): its time and outputs, and the job
    that holds every field to its plain version (on the host CPU) in
    phase 12."""
    cases = (torch_edge_cases.exact_bt_ring_cases() if level == 5
             else torch_edge_cases.exact_ap_ring_cases(level))
    if staged:
        cases = [c for c in cases if len(c[2]) <= 64 * KB]
    args = tuple(a.to(dev) if torch.is_tensor(a) else a
                 for a in k6_args(cases))
    n = args[0].shape[1]
    check((exact_ap_kernel.smem_bytes(n) >= n) == staged,
          f"ring_ap m{level}: the batch of {n} bytes is "
          f"{'not ' * staged}staged")
    ms, out = event_ms(lambda: exact_ap_kernel.parse_k6(*args), 3)
    return dict(tag=f"ring_ap m{level}" + " staged" * staged, kernel="K6",
                streams=len(cases), args=to_cpu(args), kernel_out=to_cpu(out),
                kernel_ms=ms, bytes=sum(len(c[2]) for c in cases),
                tok=int(out[1].sum()))


def cli_ring_phase(dev, data, sdir, k5_lib, meanwhile):
    """Phase 9a2: `c -m1 -d 1m` and `c -m2 -d 1m` of `data` (phase 9a's
    file, already at sdir/big.bin), `d` of each; K5 on the m1 stream's
    inputs timed and held to its g++ build, which runs on the host's CPU
    while `meanwhile()` runs.  Returns (K5 launches of each `c`, K5's ms,
    its bound, the g++ comparison's max abs error, meanwhile's result)."""
    from csc_tpu_torch import cli
    src = os.path.join(sdir, "big.bin")
    blobs, launches, walls = {}, {}, {}
    for level in (1, 2):
        enc, dst = (os.path.join(sdir, f"ring_m{level}.{x}")
                    for x in ("csc", "out"))
        exact_kernel.LAUNCHES = parse_kernel.LAUNCHES = 0
        bits_kernel.LAUNCHES = 0
        t0 = time.time()
        check(cli.main(["c", "-m", str(level), "-d", RING_D, "--backend",
                        "cuda", src, enc]) == 0, f"cli_ring m{level}: c "
              f"failed")
        t1 = time.time()
        launches[level] = exact_kernel.LAUNCHES
        check(exact_kernel.LAUNCHES >= 1 and bits_kernel.LAUNCHES >= 1
              and parse_kernel.LAUNCHES == 0, f"cli_ring m{level}: c did "
              f"not launch K5 and K3 alone")
        decode_kernel.LAUNCHES = 0
        check(cli.main(["d", "--backend", "cuda", enc, dst]) == 0,
              f"cli_ring m{level}: d failed")
        t2 = time.time()
        check(decode_kernel.LAUNCHES >= 1, f"cli_ring m{level}: d did not "
              f"launch K1")
        with open(dst, "rb") as f:
            check(f.read() == data, f"cli_ring m{level}: d restored other "
                  f"bytes")
        with open(enc, "rb") as f:
            blobs[level] = f.read()
        walls[level] = (t1 - t0, t2 - t1)
    props = props_init(cli._parse_size(RING_D), 1)
    check(props.dict_size % (8 * KB) and len(data) > 4 * props.dict_size,
          "cli_ring: the dictionary does not wrap four times off the 8 KB "
          "grid")
    stages = Stages()
    outs = pipeline.encode_batch([props], [data], device=dev,
                                 on_stage=stages)
    check(write_properties(props) + outs[0] == blobs[1],
          "cli_ring: the staged encode differs from the CLI's")
    v = stages.values
    args, out = v["k5_args"], v["k5_out"]
    with ThreadPoolExecutor(1) as pool:
        def gxx():
            t0 = time.time()
            return k5_host(k5_lib, to_cpu(args)), time.time() - t0
        job = pool.submit(gxx)
        k5_ms, again = event_ms(lambda: exact_kernel.parse_k5(*args), 1)
        compare("cli_ring relaunch", "K5", again, out)
        other = meanwhile()
        host, gxx_s = job.result()
    err = compare("cli_ring against K5's g++ build", "K5", out,
                  [torch.from_numpy(h) for h in host])
    phase("k5_host", cell="ring", streams=1, bytes=len(data),
          dict_size=props.dict_size, fields_compared=len(FIELDS["K5"]),
          max_abs_err=err, gxx_seconds=f"{gxx_s:.2f}",
          build="csrc/encode_k5_host.cpp with g++, the full step budget")
    plan = v["plans"][0]
    btypes = out[5][0].cpu().numpy()
    nolz = (plan.blocks[:, 1] & encode_host.BLK_TYPE) >= DT_NO_LZ
    retyped = int((btypes[nolz] == DT_NORMAL).sum())
    check(retyped >= 1, "cli_ring: the probe re-typed no block")
    runs = encode_host.exact_run_table(plan, btypes)
    ntok = int(out[1].sum())
    bnd = bound(len(data) + 8 * ntok, int(out[4].long().sum()))
    phase("cli_ring", bytes=len(data), dict_size=props.dict_size,
          wraps=len(data) // props.dict_size,
          compressed_m1=len(blobs[1]), compressed_m2=len(blobs[2]),
          c_m1_s=f"{walls[1][0]:.3f}", d_m1_s=f"{walls[1][1]:.3f}",
          c_m2_s=f"{walls[2][0]:.3f}", d_m2_s=f"{walls[2][1]:.3f}",
          k5_ms=f"{k5_ms:.3f}", k5_bound_ms=f"{bnd[0]:.6f}",
          bound_by=bnd[1], micro_ops=int(out[4][0]), tokens=ntok,
          runs=len(runs), run_types=",".join(sorted(
              {str(r[0]) for r in runs})), retyped_normal=retyped,
          round_trip="K1 byte-exact", launches_k5_m1=launches[1],
          launches_k5_m2=launches[2])
    phase("cli_ring_layers", **stages.ms())
    return launches, k5_ms, bnd, err, other


# ---------------------------------------------------------- phase 9b parts
KERNEL_MODULES = {"K1": decode_kernel, "K2": parse_kernel,
                  "K3": bits_kernel, "K4": parse_ap_kernel,
                  "K5": exact_kernel, "K6": exact_ap_kernel}


def arc_tree(root):
    """Write the archiver tree under root: the first ARC_PY_FILES .py
    sources of the installed torch package under torch/ with their
    relative paths (the subtree the exact parse takes whole),
    lib/libc10.so, ARC_RANDOM seeded random bytes, an ARC_RAMP DLT ramp
    and an empty file.  Returns {path: bytes}."""
    files = {os.path.join("torch", k): v for k, v in
             corpus.torch_python_files(ARC_PY_FILES).items()}
    files["lib/libc10.so"] = corpus.torch_library_exe()
    files["random.bin"] = np.random.default_rng(SEED).integers(
        0, 256, ARC_RANDOM, dtype=np.uint8).tobytes()
    files["ramp.dlt"] = corpus.dlt_ramp(ARC_RAMP)
    files["empty"] = b""
    for name, data in files.items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
    return files


# the archiver's layers: the csarc module's names each one calls
ARC_LAYERS = {"a": ("_read_task", "encode_batch", "write_trailer"),
              "x": ("read_trailer", "decode_batch", "_route_output")}


def csarc_run(cwd, argv, dev):
    """csarc's entry point, main(argv), in cwd, its launch counts set to 0
    just before: (rc, stdout, wall seconds, {kernel: launches}, {layer:
    ms}).  The layers of `a` and `x` (ARC_LAYERS) are timed by wrapping
    the csarc module's names; "rest" is the wall less them (a: the scan,
    task build, block layout and file writes; x: the extract tasks, the
    stream reads and the attributes)."""
    for m in KERNEL_MODULES.values():
        m.LAUNCHES = 0
    exact_ap_kernel.TREE_LAUNCHES = 0
    spent = {name: 0.0 for name in ARC_LAYERS.get(argv[0], ())}
    saved = {name: getattr(csarc, name) for name in spent}

    def timed(name, fn):
        def wrap(*args, **kw):
            t = time.time()
            try:
                return fn(*args, **kw)
            finally:
                spent[name] += time.time() - t
        return wrap
    for name, fn in saved.items():
        setattr(csarc, name, timed(name, fn))
    t0 = time.time()
    try:
        rc, out = run_in(cwd, csarc.main, argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(csarc, name, fn)
    wall = time.time() - t0
    layers = {name.strip("_"): round(v * 1e3, 1) for name, v in
              spent.items()}
    layers["rest"] = round((wall - sum(spent.values())) * 1e3, 1)
    counts = {k: m.LAUNCHES for k, m in KERNEL_MODULES.items()}
    counts["K6 tree"] = exact_ap_kernel.TREE_LAUNCHES
    return rc, out, wall, counts, layers


def arc_layout(path, dev):
    """An archive's trailer raw size, tasks and decode groups."""
    arc = csarc.CSArc()
    arc.device = dev
    with open(path, "rb") as f:
        f.seek(8)
        _, _, raw_size = struct.unpack("<QII", f.read(16))
        arc.index, arc.abindex = index.read_trailer(f, dev)
    tasks = arc._build_extract_tasks(dummy=True)
    return raw_size, len(arc.abindex), len(arc._decode_groups(tasks))


def two_process_archive(root, argv, backend):
    """`a` in two processes joined by CSC_DIST_* (Gloo on localhost), both
    on the same device; stops both on any failure.  Returns the wall
    seconds."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, CSC_DIST_COORD=f"127.0.0.1:{port}",
               CSC_DIST_NPROCS="2", PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    cmd = [sys.executable, "-m", "csc_tpu_torch.archiver.csarc", argv[0],
           f"--backend={backend}"] + argv[1:]
    procs = [subprocess.Popen(cmd, cwd=root, env=dict(
        env, CSC_DIST_PID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(
                ARC_WAIT_S - (time.time() - t0), 1))
            check(p.returncode == 0, f"archiver rank {r} failed "
                  f"({p.returncode}):\n{err[-2000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return time.time() - t0


def archiver_phase(dev, backend, datas):
    """Phase 9b: csarc's a / x / t / l on the archiver tree, the
    two-process `a`, and the batch split on `datas` (MESH_STREAMS
    streams).  Returns {run: {kernel: launches}}."""
    root = os.path.join(_build.BUILD_DIR, "smoke", "arc")
    shutil.rmtree(root, ignore_errors=True)
    files = arc_tree(os.path.join(root, "tree"))
    want = {os.path.normpath(os.path.join("tree", k)): v
            for k, v in files.items()}
    phase("archiver_tree", files=len(files),
          bytes=sum(map(len, want.values())))
    bk = f"--backend={backend}"
    launches = {}
    for tag, opts, sub, restored in (
            ("default", [], "tree", want),
            ("m1", ["-m1"], "tree", want),
            ("exact", ["-m2", "--parse=exact"], "tree", want),
            ("exact_m3", ["-m3", "--parse=exact"], "tree", want),
            ("exact_m5", ["-m5", "--parse=exact"], "tree", want)):
        arc = os.path.join(root, f"{tag}.csa")
        nbytes = sum(map(len, restored.values()))
        rc, _, a_wall, a_n, a_layers = csarc_run(
            root, ["a", "-r", bk] + opts + [arc, sub], dev)
        check(rc == 0, f"archiver {tag}: a returned {rc}")
        parse_k = {"exact": "K5", "exact_m3": "K6",
                   "exact_m5": "K6"}.get(tag, "K2")
        check(a_n[parse_k] >= 1 and a_n["K3"] >= 1 and a_n["K1"] == 0
              and a_n["K4"] == 0, f"archiver {tag}: a did not launch "
              f"{parse_k} and K3 ({a_n})")
        check((a_n["K6 tree"] >= 1) == (tag == "exact_m5"),
              f"archiver {tag}: a launched K6's binary-tree kernel "
              f"{a_n['K6 tree']} times")
        # the trailer's parse, always the exact one of m2 (K5): an exact
        # `a` launches no K2, a fast one (and the exact m3 one) K5 for the
        # trailer alone
        trailer = ("fast" if (a_n["K2"] if tag == "exact" else
                              not a_n["K5"]) else "exact")
        check(trailer == "exact", f"archiver {tag}: the trailer did not "
              f"take the exact parse ({a_n})")
        xdir = os.path.join(root, f"x_{tag}")
        os.makedirs(xdir)
        rc, _, x_wall, x_n, x_layers = csarc_run(xdir, ["x", bk, arc], dev)
        check(rc == 0 and x_n["K1"] >= 1, f"archiver {tag}: x returned "
              f"{rc} ({x_n})")
        check(tree_bytes(xdir) == restored,
              f"archiver {tag}: the restored tree differs")
        rc, _, t_wall, t_n, _ = csarc_run(root, ["t", bk, arc], dev)
        check(rc == 0 and t_n["K1"] >= 1, f"archiver {tag}: t returned "
              f"{rc}")
        rc, out, _, _, _ = csarc_run(root, ["l", bk, arc], dev)
        got = {os.path.normpath(k): int(v) for k, v in listing(out).items()
               if not k.endswith("/")}
        check(rc == 0 and got == {k: len(v) for k, v in restored.items()},
              f"archiver {tag}: l lists other names or sizes")
        raw_size, tasks, groups = arc_layout(arc, dev)
        launches[f"archiver a {tag}"] = a_n
        launches[f"archiver x {tag}"] = x_n
        phase("archiver", run=tag, options=" ".join(opts) or "(default)",
              files=len(restored), bytes=nbytes,
              compressed=os.path.getsize(arc), tasks=tasks,
              decode_groups=groups, index_bytes=raw_size,
              trailer_parse=trailer, a_s=f"{a_wall:.3f}",
              a_mbps=f"{nbytes / a_wall / 1e6:.2f}", x_s=f"{x_wall:.3f}",
              x_mbps=f"{nbytes / x_wall / 1e6:.2f}", t_s=f"{t_wall:.3f}",
              **{f"a_{k}": a_n[k] for k in ("K2", "K3", "K4", "K5", "K6")},
              a_K6_tree=a_n["K6 tree"],
              x_K1=x_n["K1"], round_trip="byte-exact", t_rc=0)
        phase("archiver_layers", run=tag, **{f"a_{k}_ms": v for k, v in
                                             a_layers.items()},
              **{f"x_{k}_ms": v for k, v in x_layers.items()})
    two = os.path.join(root, "two.csa")
    wall = two_process_archive(root, ["a", "-r", two, "tree"], backend)
    with open(two, "rb") as f, open(os.path.join(root, "default.csa"),
                                    "rb") as g:
        check(f.read() == g.read(), "archiver: the two-process archive "
              "differs from the one-process one")
    phase("archiver_two_process", processes=2, backend=backend,
          seconds=f"{wall:.3f}", equal_to_one_process=True)
    devs = [dev, dev]
    for level, parse in ((1, "fast"), (2, "exact")):
        props = [props_init(len(d), level) for d in datas]
        one = pipeline.encode_batch(props, datas, device=dev, parse=parse)
        split = mesh.encode_batch_sharded(props, datas, devices=devs,
                                          parse=parse)
        check(split == one, f"mesh m{level} {parse}: the split encode "
              f"differs from one device")
        sizes = [len(d) for d in datas]
        back = mesh.decode_batch_sharded(props, one, out_sizes=sizes,
                                         devices=devs)
        check(back == pipeline.decode_batch(props, one, out_sizes=sizes,
                                            device=dev) == datas,
              f"mesh m{level} {parse}: the split decode differs")
        phase("mesh", devices=",".join(map(str, devs)), streams=len(datas),
              level=f"m{level}", parse=parse, equal_to_one_device=True)
    return launches


def arc_many_phase(dev):
    """Phase 9b2: `a` of ARC_MANY_FILES generated files (an index past the
    trailer's dictionary), `x` and `t`; the trailer read back is the
    packed index.  Returns {run: {kernel: launches}}."""
    root = os.path.join(_build.BUILD_DIR, "smoke", "arc_many")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(SEED + 13)
    want = {}
    for k in range(ARC_MANY_FILES):
        name = os.path.join("many", f"pkg_{k // 256:02d}",
                            f"generated_module_{k:05d}.txt")
        want[name] = rng.integers(32, 127, ARC_MANY_BYTES,
                                  dtype=np.uint8).tobytes()
        os.makedirs(os.path.join(root, os.path.dirname(name)),
                    exist_ok=True)
        with open(os.path.join(root, name), "wb") as f:
            f.write(want[name])
    bk, arc = "--backend=cuda", os.path.join(root, "many.csa")
    rc, _, a_wall, a_n, _ = csarc_run(root, ["a", "-r", bk, arc, "many"],
                                      dev)
    check(rc == 0 and a_n["K5"] >= 1 and a_n["K3"] >= 1,
          f"arc_many: a returned {rc} ({a_n})")
    with open(arc, "rb") as f:
        f.seek(8)
        _, _, raw_size = struct.unpack("<QII", f.read(16))
        fi, abi = index.read_trailer(f, dev)
    trailer_dict = props_init(index.INDEX_DICT, index.INDEX_LEVEL).dict_size
    check(raw_size > trailer_dict, f"arc_many: the index ({raw_size} "
          f"bytes) is not past the trailer's {trailer_dict}-byte "
          f"dictionary")
    check(len(index.pack_index(fi, abi)) == raw_size and sorted(
        os.path.normpath(k) for k in fi if not k.endswith("/"))
        == sorted(want), "arc_many: the trailer read back is not the "
        "packed index")
    xdir = os.path.join(root, "x")
    os.makedirs(xdir)
    rc, _, x_wall, x_n, _ = csarc_run(xdir, ["x", bk, arc], dev)
    check(rc == 0 and x_n["K1"] >= 1, f"arc_many: x returned {rc}")
    check(tree_bytes(xdir) == want, "arc_many: the restored tree differs")
    rc, _, t_wall, t_n, _ = csarc_run(root, ["t", bk, arc], dev)
    check(rc == 0 and t_n["K1"] >= 1, f"arc_many: t returned {rc}")
    phase("arc_many", files=len(want), bytes=sum(map(len, want.values())),
          index_bytes=raw_size, trailer_dict=trailer_dict,
          compressed=os.path.getsize(arc), a_s=f"{a_wall:.3f}",
          x_s=f"{x_wall:.3f}", t_s=f"{t_wall:.3f}",
          **{f"a_{k}": a_n[k] for k in ("K2", "K3", "K5")},
          x_K1=x_n["K1"], round_trip="byte-exact", t_rc=0)
    return {"arc_many a": a_n, "arc_many x": x_n}


def main(procs):
    # ------------------------------------------------------------ 1 device
    check(torch.cuda.is_available(), "no CUDA device: this script needs "
          "the card and has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=repr(kind), count=torch.cuda.device_count())
    print(smi, flush=True)

    # ------------------------------------------------------------- 2 build
    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        # K5's and K6's phase-clock builds, their nvcc beside the others
        k5ph = pool.submit(k5_phases.library)
        k6ph = pool.submit(k6_phases.library)
        _build.build_kernels()
        k5ph_lib = k5ph.result()
        k6ph_lib = k6ph.result()
    phase("build", kernels=",".join(_build.KERNELS)
          + ",csc_k5_phases,csc_k6_phases",
          seconds=f"{time.time() - t0:.2f}")
    for name in _build.KERNELS:
        log = _build.build_log(name)
        check("Used" in log and "registers" in log,
              f"the build report of {name} names no register count")
        if name.startswith("csc_"):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    phase("ptxas", kernel=name, line=line.strip())
    # K1-K5's registers, stack frame and local-memory traffic (ptxas
    # -v and cuobjdump -sass; _build.resources raises if either cannot be
    # read), and K1's blocks per SM (the design's two)
    res = {n: _build.resources(n) for n in ("csc_k1", "csc_k2", "csc_k3",
                                            "csc_k4", "csc_k5", "csc_k6")}
    res["csc_k1"]["blocks_per_sm"] = decode_kernel.blocks_per_sm()
    # K4's shared memory a block and blocks an SM: price tables, the
    # stretch's cells and a stream's data (16 KB: the m3-m5 cells), or no
    # data (1 MB: the task); the design keeps several 16 KB streams on
    # an SM (five), as the encode path's groups of up to 4 096 streams
    # need
    # K5's likewise: a stream's staged data (16 KB), or none (1 MB); the
    # design keeps eight or more 16 KB streams on an SM, so that the
    # 1 024-stream group is resident at once; K6's: the staged data and
    # its model's tables (its registers cut it to fewer)
    for tag, n in (("16k", HEAD_BYTES), ("1m", MB)):
        res["csc_k4"]["smem_" + tag] = parse_ap_kernel.smem_bytes(n)
        res["csc_k4"]["blocks_per_sm_" + tag] = \
            parse_ap_kernel.blocks_per_sm(n)
        res["csc_k5"]["smem_" + tag] = exact_kernel.smem_bytes(n)
        res["csc_k5"]["blocks_per_sm_" + tag] = \
            exact_kernel.blocks_per_sm(n)
        res["csc_k6"]["smem_" + tag] = exact_ap_kernel.smem_bytes(n)
        # K6's four kernels: covered and ring, each without and with the
        # tree
        for tree in (False, True):
            for ring in (False, True):
                res["csc_k6"]["blocks_per_sm_" + tag + "_tree" * tree
                              + "_ring" * ring] = \
                    exact_ap_kernel.blocks_per_sm(n, tree=tree, ring=ring)
    # and of K5's kernel for streams longer than their dictionary
    res["csc_k5"]["blocks_per_sm_1m_ring"] = exact_kernel.blocks_per_sm(
        MB, ring=True)
    check(all(f"registers_k6_parse_kernel<{t},{r}>" in res["csc_k6"]
              for t in (0, 1) for r in (0, 1)),
          "K6's build report does not name its four kernels")
    for name, r in res.items():
        phase("resources", kernel=name, **r)
    check(res["csc_k1"]["blocks_per_sm"] == 2,
          f"K1 holds {res['csc_k1']['blocks_per_sm']} blocks per SM, not 2")
    check(res["csc_k4"]["blocks_per_sm_16k"] >= 4,
          f"K4 holds {res['csc_k4']['blocks_per_sm_16k']} blocks of 16 KB "
          f"streams per SM, not 4 or more")
    check(res["csc_k5"]["blocks_per_sm_16k"] >= 8,
          f"K5 holds {res['csc_k5']['blocks_per_sm_16k']} blocks of 16 KB "
          f"streams per SM, not 8 or more")
    for key in ("blocks_per_sm_16k", "blocks_per_sm_16k_tree",
                "blocks_per_sm_16k_ring", "blocks_per_sm_16k_tree_ring"):
        check(res["csc_k6"][key] >= 4,
              f"K6 holds {res['csc_k6'][key]} blocks of 16 KB streams per "
              f"SM ({key}), not 4 or more")
    for name, r in res.items():
        check(r["stack_frame"] == 0 and r["ldl"] == 0 and r["stl"] == 0,
              f"{name} has a {r['stack_frame']}-byte stack frame, "
              f"{r['ldl']} LDL and {r['stl']} STL, not 0")
    sdir = os.path.join(_build.BUILD_DIR, "smoke")
    os.makedirs(sdir, exist_ok=True)

    # ------------------------------------------------------------ 3 corpus
    t0 = time.time()
    text = corpus.torch_python_text(64 * MB)
    exe = corpus.torch_library_exe()
    check(len(text) >= 8 * MB, f"text corpus only {len(text)} bytes")
    rng = np.random.default_rng(SEED)
    par = corpus.parity_cases(text, exe, PARITY_BYTES, SEED, chunk=1 * KB,
                              big=40 * KB)
    offs = sorted(int(o) for o in rng.choice(
        len(text) // GROUP_BYTES - 2, GROUP_SLICES + 1, replace=False))
    group = [text[o * GROUP_BYTES:(o + 1) * GROUP_BYTES]
             for o in offs[:GROUP_SLICES]]
    cli_data = text[offs[-1] * GROUP_BYTES:offs[-1] * GROUP_BYTES
                    + CLI_BYTES]
    phase("corpus", text_bytes=len(text), exe_bytes=len(exe),
          seconds=f"{time.time() - t0:.1f}")
    jobs = []

    # ---------------------------------------------------------- 4 headline
    head = [("m1_head", props_init(HEAD_BYTES, 1),
             text[i * HEAD_BYTES:(i + 1) * HEAD_BYTES])
            for i in range(HEAD_STREAMS)]
    hp = [c[1] for c in head]
    hd = [c[2] for c in head]
    t0 = time.time()
    head_blobs = corpus.encode(head, dev)
    phase("headline_corpus", streams=HEAD_STREAMS, encoder="encode_batch",
          seconds=f"{time.time() - t0:.3f}")
    sizes = [len(d) for d in hd]
    decode_kernel.LAUNCHES = 0
    outs = pipeline.decode_batch(hp, head_blobs, out_sizes=sizes, device=dev)
    k1_launches = {"headline": decode_kernel.LAUNCHES}
    check(k1_launches["headline"] >= 1, "the decode main path did not "
          "launch K1")
    check(outs == hd, "headline: decoded bytes differ from input")
    walls = []
    for _ in range(5):
        t0 = time.time()
        outs = pipeline.decode_batch(hp, head_blobs, out_sizes=sizes,
                                     device=dev)
        walls.append(time.time() - t0)
    check(outs == hd, "headline: decoded bytes differ (timed run)")
    wall = statistics.median(walls)
    hargs = (*demux_upload(hp, head_blobs, dev), pipeline._bucket(HEAD_BYTES),
             NO_STEP_CAP)
    k1_ms, kout = event_ms(lambda: decode_kernel.decode_k1(*hargs), 5)
    jobs.append(plain_job("headline", "K1", hargs, 5))
    same_rows("headline", "K1", kout, jobs[-1]["kernel_out"],
              PLAIN_STREAMS["K1"])
    layers = layer_ms(hp, head_blobs, sizes, dev)
    total = sum(sizes)
    # bytes K1 must move: the coded rc and bc bytes in, the window out;
    # operations: one per coded rc bit and one per decoded byte
    rc_used, bc_used = (coded_length(t) for t in hargs[2:4])
    k1_bound = bound(rc_used + bc_used + total, 8 * rc_used + total)
    k1_longest = dict(bytes=max(sizes), coded_bits=int(8 * (
        coded_lengths(hargs[2]) + coded_lengths(hargs[3])).max()))
    phase("headline_layers", **layers)
    phase("headline", streams=HEAD_STREAMS, bytes=total,
          launches=k1_launches["headline"], wall_median_s=f"{wall:.4f}",
          wall_mbps=f"{total / wall / 1e6:.2f}",
          kernel_ms=f"{k1_ms:.3f}", kernel_mbps=f"{total / k1_ms / 1e3:.2f}",
          bound_ms=f"{k1_bound[0]:.5f}")

    # --------------------------------------------------- 5 encode_headline
    ed = hd[:ENC_STREAMS]
    cells = {}
    for level in (1, 2):
        tag = f"encode_headline m{level}"
        ep = [props_init(HEAD_BYTES, level) for _ in range(ENC_STREAMS)]
        cell = encode_cell(tag, ep, ed, dev, 5)
        cells[tag] = cell
        for kernel, args, out in (("K2", cell["parse_args"],
                                   cell["parse_out"]),
                                  ("K3", cell["k3_args"], cell["k3_out"])):
            jobs.append(plain_job(tag, kernel, args, 5))
            same_rows(tag, kernel, out, jobs[-1]["kernel_out"],
                      PLAIN_STREAMS[kernel])
        phase("encode_headline_layers", level=f"m{level}", **cell["layers"])
        phase("encode_headline", level=f"m{level}", streams=ENC_STREAMS,
              bytes=cell["total"], wall_median_s=f"{cell['wall']:.4f}",
              wall_mbps=f"{cell['total'] / cell['wall'] / 1e6:.2f}",
              k2_ms=f"{cell['parse_ms']:.3f}", k3_ms=f"{cell['k3_ms']:.3f}",
              k2_bound_ms=f"{cell['parse_bound'][0]:.6f}",
              k3_bound_ms=f"{cell['k3_bound'][0]:.6f}",
              tokens=cell["ntok"], lz_tokens=cell["lz"],
              ratio=f"{cell['ratio']:.4f}", round_trip="K1 byte-exact",
              launches_k2=cell["launches"]["K2"],
              launches_k3=cell["launches"]["K3"])
        drop_inputs(cell)

    # --------------------------------------------------------- 6 encode_ap
    # the optimal parse (m3-m5) at bench.py's m3 / m5 shape, 32 x 16 KB
    # text, filters on (bench.py:241-290), and at m4
    ad = hd[:AP_STREAMS]
    for level in (3, 4, 5):
        tag = f"encode_ap m{level}"
        ap = [props_init(HEAD_BYTES, level) for _ in range(AP_STREAMS)]
        cell = encode_cell(tag, ap, ad, dev, 3)
        cells[tag] = cell
        if level in (3, 5):
            jobs.append(plain_job(tag, "K4", cell["parse_args"], 3))
            same_rows(tag, "K4", cell["parse_out"], jobs[-1]["kernel_out"],
                      PLAIN_STREAMS["K4"])
        phase("encode_ap_layers", level=f"m{level}", **cell["layers"])
        phase("encode_ap", level=f"m{level}", streams=AP_STREAMS,
              bytes=cell["total"], wall_median_s=f"{cell['wall']:.4f}",
              wall_mbps=f"{cell['total'] / cell['wall'] / 1e6:.2f}",
              k4_ms=f"{cell['parse_ms']:.3f}", k3_ms=f"{cell['k3_ms']:.3f}",
              k4_bound_ms=f"{cell['parse_bound'][0]:.6f}",
              tokens=cell["ntok"], lz_tokens=cell["lz"],
              find_positions=cell["probes"],
              ratio=f"{cell['ratio']:.4f}", round_trip="K1 byte-exact",
              launches_k4=cell["launches"]["K4"],
              launches_k3=cell["launches"]["K3"])
        drop_inputs(cell)

    # ---------------------------------------------------- 7 encode_extract
    gp = [props_init(GROUP_BYTES, 1) for _ in group]
    ext = encode_cell("encode_extract", gp, group, dev, 1)
    cells["encode_extract"] = ext
    group_blobs = ext["outs"]
    phase("encode_extract", streams=len(group), bytes=ext["total"],
          wall_s=f"{ext['wall']:.3f}",
          wall_mbps=f"{ext['total'] / ext['wall'] / 1e6:.2f}",
          k2_ms=f"{ext['parse_ms']:.1f}", k3_ms=f"{ext['k3_ms']:.1f}",
          ratio=f"{ext['ratio']:.4f}", round_trip="K1 byte-exact",
          launches_k2=ext["launches"]["K2"],
          launches_k3=ext["launches"]["K3"])
    drop_inputs(ext)
    # the same streams at m3 (K4 reads data past its 64 KB staging from
    # device memory), and K4's g++ build (csrc/encode_k4_host.cpp, the
    # CPU tests' harness) on the first whole 1 MB stream: the stream
    # size `a -m3` gives at the archiver's autosplit cap
    st = Stages()
    pipeline.encode_batch([props_init(GROUP_BYTES, 3) for _ in group], group,
                          device=dev, on_stage=st)
    k4a, k4o = st.values["k4_args"], st.values["k4_out"]
    k4_lib = build_k4_host(pathlib.Path(sdir))
    t0 = time.time()
    k4h, _ = k4_host(k4_lib, to_cpu(first_args(k4a[:7], 1, "K4")),
                     *k4a[7:], cells=False)
    k4_host_s = time.time() - t0
    k4_host_err = compare("encode m3 task (the first whole 1 MB stream) "
                          "against K4's g++ build", "K4",
                          [t[:1] for t in k4o],
                          [torch.from_numpy(h) for h in k4h])
    phase("k4_host", cell="m3 task", streams=1, bytes=int(k4a[4][0]),
          fields_compared=len(FIELDS["K4"]), max_abs_err=k4_host_err,
          gxx_seconds=f"{k4_host_s:.2f}", build="csrc/encode_k4_host.cpp "
          "with g++, the full step budget")
    del st, k4a, k4o

    # ----------------------------------------------------- 7b encode_exact
    # the exact parse (K5) at the encode shape, 96 x 16 KB text, filters
    # on, m1 and m2, and on the 4 x 1 MB m1 task: the fast parse's
    # streams of the same inputs beside it (phases 5 and 7)
    exact_cells = (("m1", [props_init(HEAD_BYTES, 1) for _ in ed], ed,
                    "encode_headline m1", 5),
                   ("m2", [props_init(HEAD_BYTES, 2) for _ in ed], ed,
                    "encode_headline m2", 5),
                   ("task", gp, group, "encode_extract", 1))
    for name, ep, datas, fast_tag, reps in exact_cells:
        tag = f"encode_exact {name}"
        cell = encode_cell(tag, ep, datas, dev, reps, parse="exact")
        cells[tag] = cell
        if name == "m1":
            jobs.append(plain_job(tag, "K5", cell["parse_args"], 3))
            # K5's g++ build (csrc/encode_k5_host.cpp, the CPU tests'
            # harness) on the first streams, whole
            k5_lib = build_k5_host(pathlib.Path(sdir))
            host = k5_host(k5_lib, to_cpu(
                first_args(cell["parse_args"], K5_HOST_STREAMS, "K5")))
            k5_host_err = compare(f"{tag} (first {K5_HOST_STREAMS} "
                                  f"streams) against K5's g++ build", "K5",
                                  [t[:K5_HOST_STREAMS]
                                   for t in cell["parse_out"]],
                                  [torch.from_numpy(h) for h in host])
            # the phase-clock build (-DK5_PHASES) parses alike; its
            # launch counts in no main path
            ph_out, ph = k5_phases.run(k5ph_lib, cell["parse_args"])
            k5_phases_err = compare(f"{tag} against K5's phase-clock "
                                    f"build", "K5", ph_out,
                                    cell["parse_out"])
            ph_cyc = dict(zip(k5_phases.PHASES, ph))
            ph_total = sum(ph_cyc.values())
            phase("k5_phases", cell=name, max_abs_err=k5_phases_err,
                  block0_cycles=ph_total,
                  **dict(zip(k5_phases.COUNTS, ph[len(ph_cyc):])),
                  **{k: f"{c / ph_total:.4f}" for k, c in ph_cyc.items()})
            del ph_out
        if name == "task":
            # K5's g++ build on the first whole 1 MB stream: the stream
            # size `a --parse=exact` gives at the autosplit cap
            t0 = time.time()
            host = k5_host(k5_lib, to_cpu(first_args(cell["parse_args"], 1,
                                                     "K5")))
            k5_task_s = time.time() - t0
            k5_task_err = compare(f"{tag} (the first whole 1 MB stream) "
                                  f"against K5's g++ build", "K5",
                                  [t[:1] for t in cell["parse_out"]],
                                  [torch.from_numpy(h) for h in host])
        fast = cells[fast_tag]
        phase("encode_exact_layers", cell=name, **cell["layers"])
        phase("encode_exact", cell=name, streams=len(datas),
              bytes=cell["total"], wall_median_s=f"{cell['wall']:.4f}",
              wall_mbps=f"{cell['total'] / cell['wall'] / 1e6:.2f}",
              k5_ms=f"{cell['parse_ms']:.3f}", k3_ms=f"{cell['k3_ms']:.3f}",
              k5_bound_ms=f"{cell['parse_bound'][0]:.6f}",
              tokens=cell["ntok"], lz_tokens=cell["lz"],
              micro_ops_longest=cell["longest"]["micro_ops"],
              ratio=f"{cell['ratio']:.6f}",
              fast_ratio=f"{fast['ratio']:.6f}",
              bytes_equal_fast=cell["outs"] == fast["outs"],
              round_trip="K1 byte-exact",
              launches_k5=cell["launches"]["K5"],
              launches_k3=cell["launches"]["K3"])
        drop_inputs(cell)
    phase("k5_host", cell="m1", streams=K5_HOST_STREAMS, fields_compared=len(
        FIELDS["K5"]), max_abs_err=k5_host_err, build="csrc/"
        "encode_k5_host.cpp with g++, the full step budget")
    phase("k5_host", cell="task", streams=1, bytes=GROUP_BYTES,
          fields_compared=len(FIELDS["K5"]), max_abs_err=k5_task_err,
          gxx_seconds=f"{k5_task_s:.2f}", build="csrc/encode_k5_host.cpp "
          "with g++, the full step budget")

    # -------------------------------------------------- 7c encode_exact_ap
    # the exact optimal parse (K6) at the encode shape, 96 x 16 KB text,
    # filters on, at m3, m4 and m5 (K6's binary-tree kernel), and on the 4
    # x 1 MB task at m3 and m5 (K6 reads data past its 64 KB staging from
    # device memory), beside the fast parse's (K4) streams of the same
    # inputs; K6's g++ build on the m3 task's first whole 1 MB stream
    k6_lib = build_k6_host(pathlib.Path(sdir))
    k6_phases_err = 0
    for name, level, datas, reps in (("m3", 3, ed, 3), ("m4", 4, ed, 3),
                                     ("m5", 5, ed, 3), ("task", 3, group, 1),
                                     ("task m5", 5, group, 1)):
        tag = f"encode_exact_ap {name}"
        ep = [props_init(len(datas[0]), level) for _ in datas]
        cell = encode_cell(tag, ep, datas, dev, reps, parse="exact")
        cells[tag] = cell
        check((cell["tree_launches"] >= 1) == (level == 5),
              f"{tag}: K6's binary-tree kernel launched "
              f"{cell['tree_launches']} times")
        fast = pipeline.encode_batch(ep, datas, device=dev)
        fast_ratio = sum(map(len, fast)) / cell["total"]
        if name in ("m3", "m5"):
            jobs.append(plain_job(tag, "K6", cell["parse_args"], 3))
            same_rows(tag, "K6", cell["parse_out"], jobs[-1]["kernel_out"],
                      PLAIN_STREAMS["K6"])
        if name in ("m3", "m5", "task m5"):
            # K6's phase-clock build (-DK6_PHASES) parses alike; its
            # launch counts in no main path
            ph_out, ph = k6_phases.run(k6ph_lib, cell["parse_args"])
            k6_phases_err = max(k6_phases_err, compare(
                f"{tag} against K6's phase-clock build", "K6", ph_out,
                cell["parse_out"]))
            split = k6_phases.summary(cell["parse_args"], ph_out, ph)
            phase("k6_phases", cell=name, max_abs_err=k6_phases_err,
                  block0_cycles=split["cycles"],
                  cycles_per_position=split["cycles_per_position"],
                  **split["counts"],
                  **{k: f"{c:.4f}" for k, c in split["share"].items()})
            del ph_out
        if name == "task":
            t0 = time.time()
            host = k6_host(k6_lib, to_cpu(first_args(cell["parse_args"], 1,
                                                     "K6")))
            k6_task_s = time.time() - t0
            k6_task_err = compare(f"{tag} (the first whole 1 MB stream) "
                                  f"against K6's g++ build", "K6",
                                  [t[:1] for t in cell["parse_out"]],
                                  [torch.from_numpy(h) for h in host])
        phase("encode_exact_ap_layers", cell=name, **cell["layers"])
        phase("encode_exact_ap", cell=name, level=f"m{level}",
              streams=len(datas), bytes=cell["total"],
              wall_median_s=f"{cell['wall']:.4f}",
              wall_mbps=f"{cell['total'] / cell['wall'] / 1e6:.2f}",
              k6_ms=f"{cell['parse_ms']:.3f}", k3_ms=f"{cell['k3_ms']:.3f}",
              k6_bound_ms=f"{cell['parse_bound'][0]:.6f}",
              ns_per_position=f"{cell['parse_ms'] * 1e6 / len(datas[0]):.1f}",
              tokens=cell["ntok"], lz_tokens=cell["lz"],
              ratio=f"{cell['ratio']:.6f}", fast_ratio=f"{fast_ratio:.6f}",
              round_trip="K1 byte-exact",
              launches_k6=cell["launches"]["K6"],
              launches_k6_tree=cell["tree_launches"],
              launches_k3=cell["launches"]["K3"],
              tree_bytes=exact_ap_kernel.tree_bytes(
                  len(datas), len(datas[0]), exact_ap_scan.BT.of(ep[0]),
                  torch.tensor([p.bt_size for p in ep])))
        drop_inputs(cell)
    phase("k6_host", cell="task", streams=1, bytes=GROUP_BYTES,
          fields_compared=len(FIELDS["K6"]), max_abs_err=k6_task_err,
          gxx_seconds=f"{k6_task_s:.2f}", build="csrc/encode_k6_host.cpp "
          "with g++")
    # the phase-clock build on kernel_ab.py's ring cell (96 x 48 KB m3
    # text past a 36 KB dictionary: the ring kernel), held to the normal
    # build's raw launch on the same inputs (neither counts as a launch)
    _, ring_args = next(k6_phases.cells_inputs(dev, ["ring_m3"], text))
    ph_out, ph = k6_phases.run(k6ph_lib, ring_args)
    k6_phases_err = max(k6_phases_err, compare(
        "ring_m3 against K6's phase-clock build", "K6", ph_out,
        k6_phases.launch(_build.kernel_library("csc_k6"), ring_args)))
    split = k6_phases.summary(ring_args, ph_out, ph)
    phase("k6_phases", cell="ring_m3", max_abs_err=k6_phases_err,
          block0_cycles=split["cycles"],
          cycles_per_position=split["cycles_per_position"],
          **split["counts"],
          **{k: f"{c:.4f}" for k, c in split["share"].items()})
    del ph_out, ring_args
    # phase 12's workers on the plain versions of phases 4-7c start here,
    # beside phases 8-9
    procs.extend(start_plain(jobs, sdir))
    phase("plain_start", workers=len(procs),
          jobs=",".join(f"{j['kernel']}:{j['tag'].replace(' ', '_')}"
                        for j in jobs))

    # ----------------------------------------------------------- 8 extract
    gps = gp * GROUP_REPEAT
    gb = group_blobs * GROUP_REPEAT
    gd = group * GROUP_REPEAT
    gbytes = sum(len(d) for d in gd)
    decode_kernel.LAUNCHES = 0
    t0 = time.time()
    outs = pipeline.decode_batch(gps, gb, out_sizes=[len(d) for d in gd],
                                 device=dev)
    g_wall = time.time() - t0
    k1_launches["extract"] = decode_kernel.LAUNCHES
    check(k1_launches["extract"] >= 1, "extract group: K1 not launched")
    check(outs == gd, "extract group: decoded bytes differ from input")
    del outs
    gargs = demux_upload(gps, gb, dev)
    g_ms, _ = event_ms(lambda: decode_kernel.decode_k1(
        *gargs, pipeline._bucket(GROUP_BYTES), NO_STEP_CAP), 1)
    del gargs
    glayers = layer_ms(gps, gb, [len(d) for d in gd], dev)
    phase("extract_layers", **glayers)
    phase("extract", streams=len(gb), bytes=gbytes, wall_s=f"{g_wall:.3f}",
          wall_mbps=f"{gbytes / g_wall / 1e6:.2f}", kernel_ms=f"{g_ms:.1f}",
          kernel_mbps=f"{gbytes / g_ms / 1e3:.2f}",
          launches=k1_launches["extract"])

    # ---------------------------------------------------------------- 9 cli
    from csc_tpu_torch import cli
    src, enc, dst, reg = (os.path.join(sdir, n) for n in (
        "cli.bin", "cli.csc", "cli.out", "cli_regrow.csc"))
    with open(src, "wb") as f:
        f.write(cli_data)
    parse_kernel.LAUNCHES = bits_kernel.LAUNCHES = 0
    t0 = time.time()
    check(cli.main(["c", "-m", "1", "--backend", "cuda", src, enc]) == 0,
          "cli c failed")
    t1 = time.time()
    check(parse_kernel.LAUNCHES >= 1 and bits_kernel.LAUNCHES >= 1,
          "cli c did not launch K2 and K3")
    decode_kernel.LAUNCHES = 0
    check(cli.main(["d", "--backend", "cuda", enc, dst]) == 0, "cli d failed")
    t2 = time.time()
    k1_launches["cli_d"] = decode_kernel.LAUNCHES
    check(k1_launches["cli_d"] >= 1, "cli d did not launch K1")
    with open(dst, "rb") as f:
        check(f.read() == cli_data, "cli: decoded bytes differ")
    with open(enc, "rb") as f:
        blob = f.read()
    # the exact parse through the CLI: K5 and K3, then K1
    exact_kernel.LAUNCHES = parse_kernel.LAUNCHES = bits_kernel.LAUNCHES = 0
    enc_x = os.path.join(sdir, "cli_exact.csc")
    t5 = time.time()
    check(cli.main(["c", "-m", "1", "--parse", "exact", "--backend", "cuda",
                    src, enc_x]) == 0, "cli c --parse exact failed")
    t6 = time.time()
    k5_cli_launches = exact_kernel.LAUNCHES
    check(k5_cli_launches >= 1 and bits_kernel.LAUNCHES >= 1
          and parse_kernel.LAUNCHES == 0,
          "cli c --parse exact did not launch K5 and K3 alone")
    decode_kernel.LAUNCHES = 0
    check(cli.main(["d", "--backend", "cuda", enc_x, dst]) == 0,
          "cli d of the exact stream failed")
    t7 = time.time()
    k1_launches["cli_d_exact"] = decode_kernel.LAUNCHES
    check(k1_launches["cli_d_exact"] >= 1, "cli d did not launch K1")
    with open(dst, "rb") as f:
        check(f.read() == cli_data, "cli: the exact stream decodes wrong")
    with open(enc_x, "rb") as f:
        blob_x = f.read()
    p_enc = props_init(len(cli_data), 1)
    check(blob[:10] == write_properties(p_enc) and blob_x[:10] == blob[:10],
          "cli: unexpected property header")
    # the same stream under a 266 KB dictionary header (csc_blocksize and
    # raw_blocksize unchanged): K1's window starts at the dictionary, the
    # 1 MB output outgrows it, and decode_batch regrows the window and
    # decodes again; the linear window holds every distance of the stream
    p_reg = props_init(CLI_DICT, 1)
    check((p_reg.csc_blocksize, p_reg.raw_blocksize) ==
          (p_enc.csc_blocksize, p_enc.raw_blocksize) and
          p_reg.dict_size < len(cli_data), "cli: regrow header")
    with open(reg, "wb") as f:
        f.write(write_properties(p_reg) + blob[10:])
    decode_kernel.LAUNCHES = 0
    t3 = time.time()
    check(cli.main(["d", "--backend", "cuda", reg, dst]) == 0,
          "cli d (regrow) failed")
    t4 = time.time()
    k1_launches["cli_regrow"] = decode_kernel.LAUNCHES
    check(k1_launches["cli_regrow"] >= 2, "cli d under a 266 KB dictionary "
          "did not regrow its window")
    with open(dst, "rb") as f:
        check(f.read() == cli_data, "cli: regrow decoded bytes differ")
    phase("cli", bytes=len(cli_data), c_seconds=f"{t1 - t0:.2f}",
          d_seconds=f"{t2 - t1:.2f}", compressed=len(blob),
          regrow=f"dict {p_reg.dict_size} -> {len(cli_data)} bytes, "
          f"{k1_launches['cli_regrow']} K1 launches",
          regrow_d_seconds=f"{t4 - t3:.2f}",
          exact_c_seconds=f"{t6 - t5:.2f}", exact_d_seconds=f"{t7 - t6:.2f}",
          exact_compressed=len(blob_x))

    # ----------------------------------------------------------- 9a cli_big
    t0 = time.time()
    big = big_file(text, exe)
    big_launches, big_k5_ms, big_bound, big_err = cli_big_phase(
        dev, big, sdir, k5_lib)
    phase("cli_big_done", seconds=f"{time.time() - t0:.1f}")

    # ------------------------------------- 9a2 cli_ring beside 9b2 arc_many
    t0 = time.time()
    ring_launches, ring_k5_ms, ring_bound, ring_err, many_launches = \
        cli_ring_phase(dev, big, sdir, k5_lib, lambda: arc_many_phase(dev))
    phase("cli_ring_done", seconds=f"{time.time() - t0:.1f}")

    # ----------------------------------------- 9a3 cli_big_m3, 9a4 cli_big_m5
    t0 = time.time()
    big_m3_launches, big_k6_ms, big_k6_bound, big_m3_err = cli_big_ap_phase(
        dev, big, sdir, k6_lib, 3)
    phase("cli_big_m3_done", seconds=f"{time.time() - t0:.1f}")
    t0 = time.time()
    big_m5_launches, big_m5_ms, big_m5_bound, big_m5_err = cli_big_ap_phase(
        dev, big, sdir, k6_lib, 5)
    phase("cli_big_m5_done", seconds=f"{time.time() - t0:.1f}")

    # ------------------------------------------------------ 9a5 cli_ring_ap
    t0 = time.time()
    ring_ap_launches, tree_ring_launches, ring_ap_ms, ring_ap_bound, \
        ring_ap_err, ring_ap_jobs = cli_ring_ap_phase(dev, big, sdir, k6_lib)
    phase("cli_ring_ap_done", seconds=f"{time.time() - t0:.1f}")

    # ---------------------------------------------------------- 9b archiver
    t0 = time.time()
    arc_launches = archiver_phase(dev, "cuda", hd[:MESH_STREAMS])
    phase("archiver_done", seconds=f"{time.time() - t0:.1f}")

    # ---------------------- 12 plain (workers on the CPU): the rest start
    new = k3_edge_jobs(dev) + [ring_plain_job(dev)]
    new += [ring_ap_plain_job(dev, level, staged) for level in (3, 5)
            for staged in (False, True)]
    new += ring_ap_jobs
    procs.extend(start_plain(new, sdir, len(jobs)))
    jobs += new
    phase("plain_start", workers=len(procs),
          jobs=",".join(f"{j['kernel']}:{j['tag'].replace(' ', '_')}"
                        for j in new))

    # ---------------------------------------------------- 10 encode_parity
    props = [c[1] for c in par]
    plans = [encode_host.plan_stream(p, d) for _, p, d in par]
    check(len({p.hash_bits for p in props if p.hash_width == 1}) == 1
          and len({p.hash_bits for p in props if p.hash_width == 8}) == 1,
          "parity: one preset per level")
    par_blobs = [None] * len(par)
    max_err = 0
    plain_card_s = {"K2": 0.0, "K3": 0.0, "K4": 0.0}

    def to_workers(new):
        """Start phase 12's workers on the jobs of a parity group (K3
        against its plain version on the host CPU, beside the card's plain
        versions here)."""
        procs.extend(start_plain(new, sdir, len(jobs)))
        jobs.extend(new)
        phase("plain_start", workers=len(procs), jobs=",".join(
            f"{j['kernel']}:{j['tag'].replace(' ', '_')}" for j in new))

    for level in (1, 2):
        idxs = [i for i, p in enumerate(props)
                if (p.hash_width == 1) == (level == 1)]
        k3_jobs = []
        outs, parse, nf, err, p_plain_s, _ = encode_parity(
            props, plans, idxs, dev, f"m{level}", k3_jobs)
        to_workers(k3_jobs)
        for i, out in zip(idxs, outs):
            par_blobs[i] = out
        max_err = max(max_err, err)
        plain_card_s[parse] += p_plain_s
        phase("encode_parity", level=f"m{level}", streams=len(idxs),
              fields_compared=nf, max_abs_err=err,
              k2_plain_s=f"{p_plain_s:.3f}", k3_plain="phase 12 (host CPU)")
    # the batch's text and EXE streams at m3: K4 against its plain version
    ap_props = []
    for _, p, _ in par[:3]:
        q = props_init(PARITY_BYTES, 3)
        q.DLTFilter, q.EXEFilter, q.TXTFilter = (p.DLTFilter, p.EXEFilter,
                                                 p.TXTFilter)
        ap_props.append(q)
    ap_plans = [encode_host.plan_stream(q, d)
                for q, (_, _, d) in zip(ap_props, par[:3])]
    outs, parse, nf, err, p_plain_s, k3_plain_s = encode_parity(
        ap_props, ap_plans, [0, 1, 2], dev, "m3")
    check(parse == "K4", "parity m3: the group did not run K4")
    back = pipeline.decode_batch(ap_props, outs, device=dev)
    check(back == [c[2] for c in par[:3]], "parity m3: the round trip "
          "through K1 differs")
    max_err = max(max_err, err)
    plain_card_s["K4"] += p_plain_s
    plain_card_s["K3"] += k3_plain_s
    phase("encode_parity", level="m3", streams=3, fields_compared=nf,
          max_abs_err=err, k4_plain_s=f"{p_plain_s:.3f}",
          k3_plain_s=f"{k3_plain_s:.3f}")
    # the same streams under the exact parse at m1, m2 (K5) and m3 and m5
    # (K6) against its plain version, then a round trip through K1; at m1
    # and m2 the two text streams alone (the plain K5 on the card takes
    # most of a minute a stream; the EXE stream's exact parse runs in
    # phases 7b, 9a and 9b)
    plain_card_s["K5"] = plain_card_s["K6"] = plain_card_s["K6 tree"] = 0.0
    for level in (1, 2, 3, 5):
        xs = par[:2] if level <= 2 else par[:3]
        x_props = []
        for _, p, _ in xs:
            q = props_init(PARITY_BYTES, level)
            q.DLTFilter, q.EXEFilter, q.TXTFilter = (p.DLTFilter, p.EXEFilter,
                                                     p.TXTFilter)
            x_props.append(q)
        x_plans = pipeline.plan_streams(x_props, [c[2] for c in xs],
                                        "exact")
        k3_jobs = []
        outs, parse, nf, err, p_plain_s, _ = encode_parity(
            x_props, x_plans, list(range(len(xs))), dev, f"m{level} exact",
            k3_jobs)
        to_workers(k3_jobs)
        want_k = "K6" if level >= 3 else "K5"
        check(parse == want_k, f"parity exact m{level}: the group did not "
              f"run {want_k}")
        back = pipeline.decode_batch(x_props, outs, device=dev)
        check(back == [c[2] for c in xs], f"parity exact m{level}: "
              f"the round trip through K1 differs")
        max_err = max(max_err, err)
        plain_card_s["K6 tree" if level == 5 else want_k] += p_plain_s
        phase("encode_parity", level=f"m{level} exact", streams=len(xs),
              fields_compared=nf, max_abs_err=err,
              **{f"{want_k.lower()}_plain_s": f"{p_plain_s:.3f}"},
              k3_plain="phase 12 (host CPU)")

    # ----------------------------------------------------------- 11 parity
    par_blobs[-1] = corpus.flip(par_blobs[-1])
    args = demux_upload(props, par_blobs, dev)
    wnd_size = pipeline._bucket(max(len(c[2]) for c in par))
    got = decode_kernel.decode_k1(*args, wnd_size, NO_STEP_CAP)
    t0 = sync_time()
    want = decode_scan.decode_plain(*args, wnd_size, NO_STEP_CAP)
    plain_card_s["K1"] = sync_time() - t0
    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    wnd_k, log_k, pos_k, done_k, err_k, cnt_k = got
    wnd_p, log_p, pos_p, done_p, err_p, cnt_p = want
    for i, (name, _, data) in enumerate(par[:-1]):
        for fname, k, p in zip(FIELDS["K1"], got, want):
            diff = np.abs(k[i].astype(np.int64) - p[i].astype(np.int64))
            max_err = max(max_err, int(diff.max()))
            check(diff.max() == 0, f"parity {name}: {fname} differs")
        check(done_k[i] == 1 and err_k[i] == 0 and pos_k[i] == len(data),
              f"parity {name}: not decoded")
    i = len(par) - 1
    flagged_k = err_k[i] != 0 or done_k[i] == 0
    flagged_p = err_p[i] != 0 or done_p[i] == 0
    same_bytes = (pos_k[i] == pos_p[i] and
                  (wnd_k[i, :pos_k[i]] == wnd_p[i, :pos_p[i]]).all())
    check((flagged_k and flagged_p) or (not flagged_k and not flagged_p
                                        and same_bytes),
          "parity flipped: kernel and plain disagree")
    flipped_identical = all((k[i] == p[i]).all() for k, p in zip(got, want))
    datas = [c[2] for c in par[:-1]]
    outs = pipeline.decode_batch(props[:-1], par_blobs[:-1],
                                 out_sizes=[len(d) for d in datas],
                                 device=dev)
    check(outs == datas, "parity: decode_batch bytes differ from input")
    if flagged_k:
        try:
            pipeline.decode_batch([props[-1]], [par_blobs[-1]],
                                  out_sizes=[len(par[-1][2])], device=dev)
            raise RuntimeError("chip_smoke: flipped stream decoded "
                               "without DecodeError")
        except pipeline.DecodeError:
            pass
    types = sorted({int(t) for j in range(len(par) - 1)
                    for t in log_k[j, :cnt_k[j], 0]})
    phase("parity", streams=len(par), fields_equal=True, max_abs_err=max_err,
          flipped_flagged=bool(flagged_k), flipped_identical=flipped_identical,
          block_types=types, plain_seconds=f"{plain_card_s['K1']:.3f}")

    # ------------------------------------------------------------ 12 plain
    max_err = max(max_err, finish_plain(jobs, procs), k5_host_err,
                  k5_phases_err, k5_task_err, k4_host_err, big_err,
                  ring_err, k6_task_err, big_m3_err, big_m5_err,
                  k6_phases_err, ring_ap_err)
    m1, m3 = cells["encode_headline m1"], cells["encode_ap m3"]
    x1 = cells["encode_exact m1"]
    xa3, xa4 = cells["encode_exact_ap m3"], cells["encode_exact_ap m4"]
    xat = cells["encode_exact_ap task"]
    xa5, xat5 = cells["encode_exact_ap m5"], cells["encode_exact_ap task m5"]
    plain = {(j["kernel"], j["tag"]): j for j in jobs}
    launches = {"K1": k1_launches}
    for kernel in ("K2", "K3", "K4", "K5", "K6"):
        launches[kernel] = {tag: c["launches"][kernel]
                            for tag, c in cells.items()
                            if kernel in c["launches"]}
    launches["K6"].update(big_m3_launches)
    launches["K6"].update(big_m5_launches)
    # K6's binary-tree kernel (m5): its own count
    launches["K6 tree"] = {tag: c["tree_launches"] for tag, c in
                           cells.items() if c.get("tree_launches")}
    launches["K6 tree"].update(big_m5_launches)
    launches["K5"]["cli_c_exact"] = k5_cli_launches
    launches["K5"].update(big_launches)
    launches["K5"].update({f"cli_c_ring m{level}": n
                           for level, n in ring_launches.items()})
    for run, counts in list(arc_launches.items()) + list(
            many_launches.items()):
        for kernel, n in counts.items():
            if n:
                launches[kernel][run] = n
    card_on = {"K1": "the parity batch", "K2": "the m1 + m2 parity groups",
               "K3": "the m3 parity group (the other groups' K3 runs "
                     "against its plain version on the host CPU, phase "
                     "12)",
               "K4": "the m3 parity group (the batch's text and EXE "
                     "streams)",
               "K5": "the exact m1 + m2 parity groups (the batch's two "
                     "text streams)",
               "K6": "the exact m3 parity group (the batch's text and EXE "
                     "streams; the plain version runs on the host)",
               "K6 tree": "the exact m5 parity group (the batch's text and "
                          "EXE streams; the plain version runs on the "
                          "host)"}

    def row(kernel, name, source, replaces, ms, on, bnd, tag, key=None):
        """A kernel's row; key (default `kernel`) names its launches,
        card plain time, step table and resources where a kernel of the
        library has its own (K6's binary-tree kernel)."""
        j = plain[(kernel, tag)]
        key = key or kernel
        cut = (f", cut at {K5_PLAIN_STEPS} lockstep steps (K5 launched "
               f"under the same budget)" if kernel == "K5" else "")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key][tag],
                "max_abs_err": max_err, "ms": round(ms, 4),
                "plain_ms": round(j["plain_s"] * 1e3, 2),
                "bound_ms": round(bnd[0], 6), "bound_by": bnd[1],
                "library_ms": None, "ms_on": on,
                "plain_on": f"the first {j['streams']} of those streams"
                            f"{cut}, on one CPU core of the card's host",
                "kernel_ms_on_those_streams": round(j["kernel_ms"], 4),
                "plain_card_ms": round(plain_card_s[key] * 1e3, 2),
                "plain_card_on": card_on[key],
                "launches_by_path": launches[key],
                "ns_per_step": k_steps[key],
                "resources": res.get(f"csc_{kernel.lower()}")}

    # ----------------------------------------------------------- 13 spikes
    t0 = time.time()
    for f in spikes.FILES:
        spikes.LAUNCHES[f] = 0
    srows = spike_main.main(["--json", os.path.join(sdir, "spikes.json")])
    s_launches = dict(spikes.LAUNCHES)
    check(all(s_launches[f] >= 1 for f in spikes.FILES),
          f"the spikes' main path did not launch every spike file "
          f"({s_launches})")
    t_main = time.time() - t0
    sdetail = {}
    for key, p in spikes.PROBES.items():
        errs = _probe.compare(p, dev)
        for label, e in errs.items():
            check(e == 0, f"spikes: {key} at {label} differs from its plain "
                  f"version (max abs {e})")
        sdetail[key] = dict(err=max(errs.values()), sizes=len(errs),
                            plain_ns=_probe.plain_marginal_ns(p, dev),
                            library_ns=_probe.library_ns(p, dev))
    torch.cuda.synchronize()
    srow = {r["key"]: r for r in srows if r["size"] == "spike"}
    for f in spikes.FILES:
        keys = [k for k in srow if srow[k]["file"] == f]
        phase("spikes", file=f, launches=s_launches[f], max_abs_err=max(
            sdetail[k]["err"] for k in keys), sizes_compared=sum(
            sdetail[k]["sizes"] for k in keys), probes=",".join(
            f"{srow[k]['name']}:a={srow[k]['a_ns']:.1f},"
            f"b={srow[k]['b_ns']:.1f},regs={srow[k]['regs']},"
            f"spill={srow[k]['spill_stores']}" for k in keys))
    k2_ms, k3_ms, k4_ms = m1["parse_ms"], m1["k3_ms"], m3["parse_ms"]
    k_steps = {
        "K1": {"ns_per_decoded_byte": k1_ms * 1e6 / k1_longest["bytes"],
               "ns_per_coded_bit": k1_ms * 1e6 / k1_longest["coded_bits"],
               "longest": k1_longest},
        "K2": {"ns_per_position": k2_ms * 1e6 / m1["longest"]["positions"],
               "ns_per_lz_token": k2_ms * 1e6 / m1["longest"]["lz_tokens"],
               "longest": {k: m1["longest"][k]
                           for k in ("positions", "lz_tokens", "tokens")}},
        "K3": {"ns_per_tape_entry": k3_ms * 1e6
               / m1["longest"]["tape_entries"],
               "ns_per_modelled_bit": k3_ms * 1e6
               / m1["longest"]["modelled_bits"],
               "longest": {k: m1["longest"][k]
                           for k in ("tape_entries", "modelled_bits")}},
        "K4": {"ns_per_position": k4_ms * 1e6 / m3["longest"]["positions"],
               "ns_per_lz_token": k4_ms * 1e6 / m3["longest"]["lz_tokens"],
               "longest": {k: m3["longest"][k]
                           for k in ("positions", "lz_tokens", "tokens")}},
        "K5": {"ns_per_position": x1["parse_ms"] * 1e6
               / x1["longest"]["positions"],
               "ns_per_micro_op": x1["parse_ms"] * 1e6
               / x1["longest"]["micro_ops"],
               "longest": {k: x1["longest"][k]
                           for k in ("positions", "micro_ops", "tokens")}},
        "K6": {"ns_per_position": xa3["parse_ms"] * 1e6
               / xa3["longest"]["positions"],
               "ns_per_lz_token": xa3["parse_ms"] * 1e6
               / xa3["longest"]["lz_tokens"],
               "longest": {k: xa3["longest"][k]
                           for k in ("positions", "lz_tokens", "tokens")}},
        "K6 tree": {"ns_per_position": xa5["parse_ms"] * 1e6
                    / xa5["longest"]["positions"],
                    "ns_per_lz_token": xa5["parse_ms"] * 1e6
                    / xa5["longest"]["lz_tokens"],
                    "longest": {k: xa5["longest"][k]
                                for k in ("positions", "lz_tokens",
                                          "tokens")}}}
    phase("k_steps", **{f"{k.replace(' ', '_')}_{u}": f"{v:.2f}"
                        for k, d in k_steps.items()
                        for u, v in d.items() if u != "longest"})
    phase("spikes_done", probes=len(spikes.PROBES), timings=len(srows),
          main_path_s=f"{t_main:.1f}", seconds=f"{time.time() - t0:.1f}")

    enc_on = f"{ENC_STREAMS} x {HEAD_BYTES // KB} KB m1 text"
    print(json.dumps({"kernels": [
        row("K1", "K1 decode (two streams an SM, coder state "
            "and input words in registers, children's probabilities "
            "prefetched, copies through a shared ring)",
            "csc_tpu_torch/csrc/decode_k1.cu",
            "csc_tpu/ops/pallas_decode.py:272", k1_ms,
            f"{HEAD_STREAMS} x {HEAD_BYTES // KB} KB m1 text", k1_bound,
            "headline"),
        row("K2", "K2 lazy parse (one warp a stream, both lazy "
            "probes' candidate and rep lanes in one round trip, 32-byte "
            "warp extensions, serial fold on shuffled values)",
            "csc_tpu_torch/csrc/encode_k2.cu",
            "csc_tpu/ops/pallas_parse.py:112", m1["parse_ms"], enc_on,
            m1["parse_bound"], "encode_headline m1"),
        row("K3", "K3 phase-B coder (an expanding warp, a walking lane "
            "and a coding lane, passes through a shared ring, coded bits "
            "branch-free)", "csc_tpu_torch/csrc/encode_k3.cu",
            "csc_tpu/ops/pallas_encode.py:107", m1["k3_ms"], enc_on,
            m1["k3_bound"], "encode_headline m1"),
        row("K4", "K4 optimal (AP) parse (one warp a stream: a candidate "
            "pass over 32 positions a lane each, the rep lanes, the fold "
            "and the length grid across the warp; the stretch's back "
            "pointers in a shared window, its prices and nodes in a "
            "64-cell shared ring, the price tables and a stream of up to "
            "64 KB in shared memory, five 16 KB streams an SM)",
            "csc_tpu_torch/csrc/encode_k4.cu",
            "csc_tpu/ops/parse_ap.py:208", m3["parse_ms"],
            f"{AP_STREAMS} x {HEAD_BYTES // KB} KB m3 text", m3["parse_bound"],
            "encode_ap m3"),
        dict(row("K5", "K5 exact m1/m2 parse (one warp a stream: the "
                 "reference's finder and lazy parser over live hash tables "
                 "in device memory, a find's probes, extensions and fold "
                 "across the lanes, a slide 32 insertions a pass, the "
                 "duplicate-block probe one position a lane and a no-LZ "
                 "run's sparse insertion 32 positions a pass, a stream of "
                 "up to 64 KB in shared memory, the lockstep micro-ops "
                 "counted in closed form)",
                 "csc_tpu_torch/csrc/encode_k5.cu",
                 "csc_tpu/ops/encode_scan.py:179", x1["parse_ms"],
                 f"{ENC_STREAMS} x {HEAD_BYTES // KB} KB m1 text, exact "
                 f"parse", x1["parse_bound"], "encode_exact m1"),
             ms_past_cap=round(big_k5_ms, 4),
             bound_ms_past_cap=round(big_bound[0], 6),
             past_cap_on="phase 9a's ~4.5 MB m1 file, one stream (text, "
                         "libc10.so, random, a DLT ramp, a repeated "
                         "block)",
             ms_ring=round(ring_k5_ms, 4),
             bound_ms_ring=round(ring_bound[0], 6),
             launches_ring=ring_launches[1],
             max_abs_err_ring_gxx=ring_err,
             ring_on="phase 9a2: the same file under -d 1m (a 1 MB + 10 "
                     "KB ring, four wraps), m1, one stream"),
        dict(row("K6", "K6 exact optimal parse of m3/m4 priced by the live "
                 "model (one warp a stream: K5's finder, slide, walk and "
                 "probe; the stretch's DP a length a lane, its back-walk's "
                 "tokens and the shadow model's updates by lane 0; the "
                 "model's small trees, its length cache and a stream of up "
                 "to 64 KB in shared memory, p_lit and the cells in device "
                 "memory)", "csc_tpu_torch/csrc/encode_k6.cu",
                 "csc_tpu/ops/pipeline.py:248 (no TPU kernel: csc_tpu "
                 "codes these streams with its golden host encoder)",
                 xa3["parse_ms"], f"{ENC_STREAMS} x {HEAD_BYTES // KB} KB "
                 f"m3 text, exact parse", xa3["parse_bound"],
                 "encode_exact_ap m3"),
             ms_m4=round(xa4["parse_ms"], 4),
             bound_ms_m4=round(xa4["parse_bound"][0], 6),
             ms_task=round(xat["parse_ms"], 4),
             bound_ms_task=round(xat["parse_bound"][0], 6),
             task_on="the 4 x 1 MB m3 task (phase 7c)",
             ms_past_cap=round(big_k6_ms, 4),
             bound_ms_past_cap=round(big_k6_bound[0], 6),
             past_cap_on="phase 9a's ~4.5 MB file at m3, one stream"),
        dict(row("K6", "K6 exact optimal parse of m5 with golden's "
                 "binary-tree finder (k6_parse_kernel<1,0>: K6's parse "
                 "with the tree in the HT6 row's place; a walk step one "
                 "load of the node's two links, started before the byte at "
                 "clen decides it, the warp extending only an equal one, "
                 "the head loaded a find ahead and an insertion pass's "
                 "heads at once; lengths 2-47 two a lane; the head and "
                 "links in device memory)", "csc_tpu_torch/csrc/encode_k6.cu",
                 "csc_tpu/ops/pipeline.py:248 (no TPU kernel: csc_tpu "
                 "codes m5 under the exact parse and past its cap with its "
                 "golden host encoder)", xa5["parse_ms"],
                 f"{ENC_STREAMS} x {HEAD_BYTES // KB} KB m5 text, exact "
                 f"parse", xa5["parse_bound"], "encode_exact_ap m5",
                 key="K6 tree"),
             ms_task=round(xat5["parse_ms"], 4),
             bound_ms_task=round(xat5["parse_bound"][0], 6),
             task_on="the 4 x 1 MB m5 task (phase 7c)",
             ms_past_cap=round(big_m5_ms, 4),
             bound_ms_past_cap=round(big_m5_bound[0], 6),
             past_cap_on="phase 9a's ~4.5 MB file at m5, one stream"),
        ring_row("K6 ring", "K6 exact optimal parse of m3/m4 past the "
                 "dictionary (k6_parse_kernel<0,1>: golden's ring window, "
                 "K5's ring rules and the literal price's context 0 at "
                 "ring position 0; a kernel of its own beside the covered "
                 "streams')", plain, 3, ring_ap_launches, res, max_err,
                 ms_past_d=round(ring_ap_ms, 4),
                 bound_ms_past_d=round(ring_ap_bound[0], 6),
                 past_d_on="phase 9a5: phase 9a's file under -d 1m (a 1 MB "
                           "+ 10 KB ring, four wraps), m3, one stream"),
        ring_row("K6 tree ring", "K6 exact optimal parse of m5 past the "
                 "dictionary (k6_parse_kernel<1,1>: the tree's walks "
                 "stopped at the ring's end; golden's IndexError past "
                 "bt_size refused as ERR_BT)", plain, 5,
                 tree_ring_launches, res, max_err),
    ] + [spike_row(f, srows, sdetail, s_launches[f]) for f in spikes.FILES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def ring_row(name, what, plain, level, launches, res, max_err, **extra):
    """The kernels-line row of one of K6's ring kernels: its time on the
    prefix of phase 9a5's stream at `level` (phase 12's job; at m5 up to
    golden's fault) beside its plain version's on the same inputs, its
    launches on the main path (phase 9a5), and its and the plain
    version's times on the ring's edge streams, unstaged and staged."""
    job = plain[("K6", f"cli_ring_ap m{level} prefix")]
    # the bytes the parse reads: at m5 up to golden's fault
    bnd = bound(job["parsed"] + 8 * job["tok"], job["parsed"])
    edges = {}
    for tag in (f"ring_ap m{level}", f"ring_ap m{level} staged"):
        e = plain[("K6", tag)]
        key = tag.replace(" ", "_")
        edges.update({f"ms_{key}": round(e["kernel_ms"], 4),
                      f"plain_ms_{key}": round(e["plain_s"] * 1e3, 2),
                      f"streams_{key}": e["streams"]})
    return dict({"name": what, "route": "cuda",
                 "source": "csc_tpu_torch/csrc/encode_k6.cu",
                 "replaces": "csc_tpu/ops/pipeline.py:248 (no TPU kernel: "
                             "csc_tpu codes these streams with its golden "
                             "host encoder)",
                 "launches": sum(launches.values()), "max_abs_err": max_err,
                 "ms": round(job["kernel_ms"], 4),
                 "plain_ms": round(job["plain_s"] * 1e3, 2),
                 "bound_ms": round(bnd[0], 6), "bound_by": bnd[1],
                 "library_ms": None,
                 "ms_on": f"the first {job['bytes']} bytes of phase 9a5's "
                          f"m{level} stream (its LZ input and blocks, under "
                          f"a {job['dict_size']}-byte ring: past its first "
                          f"wrap; {job['parsed']} parsed), one launch",
                 "plain_on": "the same inputs, on one CPU core of the "
                             "card's host",
                 "edges_on": "torch_edge_cases' ring cases, one launch "
                             "(staged: those of at most 64 KB)",
                 "launches_by_path": launches, "key": name,
                 "resources": res.get("csc_k6")}, **edges, **extra)


def spike_row(f, srows, detail, launches):
    """The kernels-line row of one spike file: one step of each of its
    probes, summed (ms in layout a, b_ms in layout b), beside the sums of
    their bounds, plain versions (on the card) and library calls."""
    rows = [r for r in srows if r["file"] == f and r["size"] == "spike"]
    probes = [spikes.PROBES[r["key"]] for r in rows]
    tb = sum(p.cost(p.size)[0] for p in probes) / _probe.HBM_BYTES_PER_S
    to = sum(p.cost(p.size)[1] for p in probes) / _probe.OPS_PER_S
    libs = [detail[r["key"]]["library_ns"] for r in rows
            if detail[r["key"]]["library_ns"] is not None]
    lines = sorted({int(x) for p in probes
                    for x in re.findall(r"pallas_call :(\d+)", p.site)})
    return {"name": f"{spikes.ROW[f]} spike_{f} probes", "route": "cuda",
            "source": f"csc_tpu_torch/csrc/spike_{f}.cu",
            "replaces": f"tools/spike_{f}.py:"
                        + ",".join(str(x) for x in lines),
            "launches": launches,
            "max_abs_err": max(detail[r["key"]]["err"] for r in rows),
            "ms": sum(r["a_ns"] for r in rows) / 1e6,
            "plain_ms": sum(detail[r["key"]]["plain_ns"] for r in rows) / 1e6,
            "bound_ms": sum(r["bound_ns"] for r in rows) / 1e6,
            "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": sum(libs) / 1e6 if libs else None,
            "ms_on": f"one step (or call) of each of its {len(rows)} probes "
                     f"at the spike's shapes, layout a (one stream per "
                     f"block); b_ms the same in layout b (128 streams a "
                     f"block); plain_ms and library_ms on the card",
            "b_ms": sum(r["b_ns"] for r in rows) / 1e6,
            "library_on": [r["name"] for r in rows
                           if detail[r["key"]]["library_ns"] is not None],
            "probes": {r["name"]: {
                "a_ns": round(r["a_ns"], 3), "b_ns": round(r["b_ns"], 3),
                "bound_ns": round(r["bound_ns"], 6),
                "plain_ns": round(detail[r["key"]]["plain_ns"], 1),
                "library_ns": detail[r["key"]]["library_ns"],
                "regs": r["regs"], "spill": r["spill_stores"]}
                for r in rows}}


def layer_ms(props, blobs, sizes, dev):
    """One decode_batch pass split by layer, each ended by a synchronize:
    host demux + pad, upload, K1 (with its scratch fills), copy back,
    host post-pass (bytes + inverse filters).  Milliseconds."""
    t = [time.time()]
    rc, bc, rce, bce = pipeline._demux(props, blobs, [0] * len(blobs))
    t.append(time.time())
    args = [torch.from_numpy(a).to(dev) for a in (rc, bc, rce, bce)]
    t.append(sync_time())
    wnd_size = pipeline._bucket(max(sizes))
    wnd, log, pos, _, _, cnt = decode_kernel.decode_k1(
        *args, wnd_size, NO_STEP_CAP)
    t.append(sync_time())
    pos, cnt = pos.cpu().numpy(), cnt.cpu().numpy()
    wnd_np = wnd[:, :int(pos.max())].cpu().numpy()
    log_np = log[:, :int(cnt.max())].cpu().numpy()
    t.append(time.time())
    for i in range(len(blobs)):
        raw = bytearray(wnd_np[i, :pos[i]].tobytes())
        pipeline._inverse_filters(raw, log_np[i], int(cnt[i]), int(pos[i]))
        bytes(raw)
    t.append(time.time())
    names = ("demux", "upload", "k1", "copy_back", "post_pass")
    return {n: round((b - a) * 1e3, 3) for n, a, b in zip(names, t, t[1:])}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plain"]:
        plain_worker(sys.argv[2])
    else:
        workers = []
        try:
            main(workers)
        finally:
            for w in workers:
                if w.poll() is None:
                    w.kill()
                    w.wait()
