#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (csc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; the first failure raises:
  1. device          nvidia-smi name and power limit, torch's device name
  2. build           K1, K2, K3 and the ten spike libraries (csrc/*.cu)
                     with nvcc into build/, one nvcc per source started
                     together, with ptxas's reports of K1-K3
  3. corpus          text = this machine's torch/**/*.py, exe = torch/lib/
                     libc10.so, plus seeded random / DLT data
  4. headline        the decode main path: decode_batch of 128 x 16 KB m1
                     text, encoded on the card by encode_batch
  5. encode_headline the encode main path: encode_batch of 96 x 16 KB text
                     (filters on) at m1 and m2, its stages, K2 / K3 times,
                     a round trip through K1
  6. encode_extract  4 x 1 MB m1 text (the archiver's autosplit cap)
  7. extract         one archiver extract group: 256 x 1 MB m1 text
  8. cli             `c` then `d` with --backend cuda on a 1 MB file, and
                     `d` of the same stream under a 266 KB dictionary
                     header, which makes decode_batch regrow its window
  9. encode_parity   on the parity batch (2 KB streams, m1 and m2): the
                     candidates on the card equal those on the CPU; K2, the
                     stitch and K3 equal their plain versions (on the card)
 10. parity          K1 against its plain version (on the card) on the
                     parity batch, a corrupted stream among them
 11. plain           each kernel against its plain version on the first
                     streams of its headline inputs (phases 4 and 5)
 12. spikes          the spike probes' main path, `python -m
                     csc_tpu_torch.spikes` (every probe of tools/spike_*.py
                     timed in layouts a and b), then every probe in both
                     layouts, at every size the runner times, against its
                     plain version on the card, with
                     K1-K3's own ns per step of their longest stream
Every count of launches is read around a main-path run (phases 4-8, 12).
Phase 11's plain versions run on the host's CPU in worker processes
(`chip_smoke.py --plain FILE`, one thread each), started once phases 4-8
are timed, so they overlap phases 9 and 10; on the card a plain version
takes several ms a lockstep step.  The last two lines are the kernels'
JSON record and the ok line.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from csc_tpu_torch import _build, corpus, spikes  # noqa: E402
from csc_tpu_torch.constants import K_END, K_SENT_A  # noqa: E402
from csc_tpu_torch.ops import (bits_kernel, bits_scan, decode_kernel,  # noqa: E402
                               decode_scan, encode_host, parse_kernel,
                               parse_pre, parse_scan, pipeline, stitch)
from csc_tpu_torch.props import props_init, write_properties  # noqa: E402
from csc_tpu_torch.spikes import __main__ as spike_main  # noqa: E402
from csc_tpu_torch.spikes import _probe  # noqa: E402

SEED = 20261016
KB, MB = 1024, 1024 * 1024
PARITY_BYTES = 2 * KB                 # per parity stream
HEAD_STREAMS, HEAD_BYTES = 128, 16 * KB   # bench.py's decode headline shape
ENC_STREAMS = 96                      # bench.py's encode shape: 96 x 16 KB
# headline streams each kernel's plain version runs on (the first ones)
PLAIN_STREAMS = {"K1": 16, "K2": 8, "K3": 8}
PLAIN_WAIT_S = 600                    # the plain workers' deadline
GROUP_SLICES, GROUP_REPEAT, GROUP_BYTES = 4, 64, MB   # one extract group
CLI_BYTES, CLI_DICT = MB, 256 * KB
NO_STEP_CAP = 1 << 62     # K1 and the plain version run each stream out
FIELDS = {"K1": ("wnd", "blk_log", "wnd_pos", "done", "err", "blk_cnt"),
          "K2": ("tape", "tok_cnt", "done", "err"),
          "K3": ("rc_out", "bc_out", "rc_blkmap", "bc_blkmap", "chunk_log",
                 "stats")}
PLAIN = {"K1": decode_scan.decode_plain, "K2": parse_scan.parse_plain,
         "K3": bits_scan.bits_plain}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
OPS_PER_S = 67e12           # H100 SXM non-tensor fp32 peak; int32 is no faster


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(tag, **kv):
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


def first_args(args, k):
    """A kernel's arguments cut to its first k streams (every tensor
    argument is batch-first)."""
    return tuple(a[:k].contiguous() if torch.is_tensor(a) else a
                 for a in args)


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
    (the inputs a main path gave it): its time and outputs, and the job
    that holds them against the plain version in phase 11."""
    k = PLAIN_STREAMS[kernel]
    sub = first_args(args, k)
    launch = {"K1": decode_kernel.decode_k1, "K2": parse_kernel.parse_k2,
              "K3": bits_kernel.code_k3}[kernel]
    ms, out = event_ms(lambda: launch(*sub), reps)
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
def encode_cell(tag, props, datas, dev, reps):
    """The encode main path on one preset group: encode_batch once with
    the launch counts set to 0 (it must launch K2 and K3), `reps` timed
    calls, one pass split by stage, a round trip through K1, and K2 / K3
    timed on the inputs that pass gave them.  Returns the phase's
    numbers."""
    parse_kernel.LAUNCHES = bits_kernel.LAUNCHES = 0
    outs = pipeline.encode_batch(props, datas, device=dev)
    launches = {"K2": parse_kernel.LAUNCHES, "K3": bits_kernel.LAUNCHES}
    check(min(launches.values()) >= 1, f"{tag}: the encode path did not "
          f"launch K2 and K3 ({launches})")
    walls = []
    for _ in range(reps):
        t0 = time.time()
        again = pipeline.encode_batch(props, datas, device=dev)
        walls.append(time.time() - t0)
        check(again == outs, f"{tag}: encode_batch is not deterministic")
    stages = Stages()
    check(pipeline.encode_batch(props, datas, device=dev,
                                on_stage=stages) == outs,
          f"{tag}: the staged pass differs from encode_batch")
    back = pipeline.decode_batch(props, outs,
                                 out_sizes=[len(d) for d in datas],
                                 device=dev)
    check(back == datas, f"{tag}: the round trip through K1 differs")
    v = stages.values
    k2_args, k3_args = v["k2_args"], v["k3_args"]
    k2_ms, k2_out = event_ms(lambda: parse_kernel.parse_k2(*k2_args), reps)
    k3_ms, k3_out = event_ms(lambda: bits_kernel.code_k3(*k3_args), reps)
    compare(f"{tag} relaunch", "K2", k2_out, v["k2_out"])
    compare(f"{tag} relaunch", "K3", k3_out, v["k3_out"])
    total = sum(len(d) for d in datas)
    # K2 reads all C candidate words at each position it probes and writes
    # 8 bytes a token; each parse step emits one token and probes at most
    # twice, and a step that probes none follows one that probed twice,
    # so the LZ tokens (kinds below K_SENT_A) are a lower bound on the
    # probes.  The data bytes are left out: the parse reads them only
    # where it extends a match.  K3 reads 16 bytes a token up to K_END
    # and writes the coded bytes, one operation per coded bit.
    tape, tok_cnt = k2_out[0], k2_out[1]
    live = (torch.arange(tape.shape[1], device=tape.device)[None, :]
            < tok_cnt[:, None])
    probes = int(((tape[..., 0] & 7) < K_SENT_A).logical_and(live).sum())
    ntok = int(tok_cnt.sum())
    c = k2_args[1].shape[1]
    k2_bound = bound(4 * c * probes + 8 * ntok, (c + 4) * probes)
    per_tape = (k3_args[0] != K_END).sum(dim=1) + 1
    used = int(per_tape.sum())
    # the longest stream's steps, for the per-step table (phase 12)
    per_lz = ((tape[..., 0] & 7) < K_SENT_A).logical_and(live).sum(dim=1)
    longest = dict(positions=max(len(d) for d in datas),
                   lz_tokens=int(per_lz.max()), tokens=int(tok_cnt.max()),
                   tape_entries=int(per_tape.max()))
    stats = k3_out[5].cpu().numpy().astype(np.int64)
    coded_bytes = int(stats[0].sum() + stats[1].sum())
    k3_bound = bound(16 * used + coded_bytes, 8 * coded_bytes)
    return dict(wall=statistics.median(walls), outs=outs, k2_ms=k2_ms,
                k3_ms=k3_ms, launches=launches, layers=stages.ms(),
                ratio=sum(len(o) for o in outs) / total, total=total,
                k2_bound=k2_bound, k3_bound=k3_bound, probes=probes,
                ntok=ntok, longest=longest, k2_args=k2_args, k2_out=k2_out,
                k3_args=k3_args, k3_out=k3_out)


# ----------------------------------------------------------- phase 9 parts
def encode_parity(props, plans, idxs, dev):
    """One preset group of the parity batch through encode_group, its
    stages held to their counterparts on the same inputs: the candidates
    and the stitch on the CPU, K2 and K3 against their plain versions on
    the card.  Returns (streams, fields compared, max abs difference,
    plain seconds of K2 and K3)."""
    p0 = props[idxs[0]]
    stages = Stages()
    outs = pipeline.encode_group(props, plans, idxs, dev, on_stage=stages)
    v = stages.values
    data, _, run_ends = v["k2_args"][:3]
    cand_cpu = parse_pre.precompute_candidates(data.cpu(), run_ends.cpu(),
                                               p0.hash_bits, p0.hash_width)
    err = max_diff(v["cand"], cand_cpu)
    check(err == 0, "encode parity: candidates differ from the CPU's")
    t0 = sync_time()
    want = parse_scan.parse_plain(*v["k2_args"])
    k2_plain_s = sync_time() - t0
    err = max(err, compare("encode parity", "K2", v["k2_out"], want))
    tape, data, run_tables = v["stitch_args"]
    ref = stitch.stitch_tapes(tape.cpu(), data.cpu(), run_tables)
    for name, g, w in zip("kabc", v["k3_args"][:4], ref[:4]):
        d = max_diff(g, w)
        check(d == 0, f"encode parity: stitched tape {name} differs")
    t0 = sync_time()
    want = bits_scan.bits_plain(*v["k3_args"])
    k3_plain_s = sync_time() - t0
    err = max(err, compare("encode parity", "K3", v["k3_out"], want))
    nfields = 1 + len(FIELDS["K2"]) + 4 + len(FIELDS["K3"])
    return outs, nfields, err, k2_plain_s, k3_plain_s


# ---------------------------------------------------------- phase 11 parts
def start_plain(jobs, sdir):
    """One worker process a job, all started together, on the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = []
    for i, job in enumerate(jobs):
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
              kernel_ms=f"{job['kernel_ms']:.3f}")
    return err


def plain_worker(path):
    """`chip_smoke.py --plain FILE`: the plain version of the job in FILE
    on its CPU inputs, one thread; writes its outputs and seconds to
    FILE.out."""
    torch.set_num_threads(1)
    job = torch.load(path)
    t0 = time.time()
    out = PLAIN[job["kernel"]](*job["args"])
    torch.save({"out": out, "seconds": time.time() - t0}, path + ".out")


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
    _build.build_kernels()
    phase("build", kernels=",".join(_build.KERNELS),
          seconds=f"{time.time() - t0:.2f}")
    for name in _build.KERNELS:
        log = _build.build_log(name)
        check("Used" in log and "registers" in log,
              f"the build report of {name} names no register count")
        if name.startswith("csc_"):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    phase("ptxas", kernel=name, line=line.strip())
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
        cells[level] = cell
        for kernel, args, out in (("K2", cell["k2_args"], cell["k2_out"]),
                                  ("K3", cell["k3_args"], cell["k3_out"])):
            jobs.append(plain_job(tag, kernel, args, 5))
            same_rows(tag, kernel, out, jobs[-1]["kernel_out"],
                      PLAIN_STREAMS[kernel])
        phase("encode_headline_layers", level=f"m{level}", **cell["layers"])
        phase("encode_headline", level=f"m{level}", streams=ENC_STREAMS,
              bytes=cell["total"], wall_median_s=f"{cell['wall']:.4f}",
              wall_mbps=f"{cell['total'] / cell['wall'] / 1e6:.2f}",
              k2_ms=f"{cell['k2_ms']:.3f}", k3_ms=f"{cell['k3_ms']:.3f}",
              k2_bound_ms=f"{cell['k2_bound'][0]:.6f}",
              k3_bound_ms=f"{cell['k3_bound'][0]:.6f}",
              tokens=cell["ntok"], lz_tokens=cell["probes"],
              ratio=f"{cell['ratio']:.4f}", round_trip="K1 byte-exact",
              launches_k2=cell["launches"]["K2"],
              launches_k3=cell["launches"]["K3"])
        for key in ("k2_args", "k2_out", "k3_args", "k3_out"):
            del cell[key]

    # ---------------------------------------------------- 6 encode_extract
    gp = [props_init(GROUP_BYTES, 1) for _ in group]
    ext = encode_cell("encode_extract", gp, group, dev, 1)
    group_blobs = ext["outs"]
    phase("encode_extract", streams=len(group), bytes=ext["total"],
          wall_s=f"{ext['wall']:.3f}",
          wall_mbps=f"{ext['total'] / ext['wall'] / 1e6:.2f}",
          k2_ms=f"{ext['k2_ms']:.1f}", k3_ms=f"{ext['k3_ms']:.1f}",
          ratio=f"{ext['ratio']:.4f}", round_trip="K1 byte-exact",
          launches_k2=ext["launches"]["K2"],
          launches_k3=ext["launches"]["K3"])
    del ext["k2_args"], ext["k2_out"], ext["k3_args"], ext["k3_out"]

    # ----------------------------------------------------------- 7 extract
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

    # ---------------------------------------------------------------- 8 cli
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
    p_enc = props_init(len(cli_data), 1)
    check(blob[:10] == write_properties(p_enc), "cli: unexpected property "
          "header")
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
          regrow_d_seconds=f"{t4 - t3:.2f}")

    # --------------------------- 11 plain (workers on the CPU) start here
    procs.extend(start_plain(jobs, sdir))
    phase("plain_start", workers=len(procs),
          jobs=",".join(f"{j['kernel']}:{j['tag'].replace(' ', '_')}"
                        for j in jobs))

    # ----------------------------------------------------- 9 encode_parity
    props = [c[1] for c in par]
    plans = [encode_host.plan_stream(p, d) for _, p, d in par]
    check(len({p.hash_bits for p in props if p.hash_width == 1}) == 1
          and len({p.hash_bits for p in props if p.hash_width == 8}) == 1,
          "parity: one preset per level")
    par_blobs = [None] * len(par)
    max_err = 0
    plain_card_s = {"K2": 0.0, "K3": 0.0}
    for level in (1, 2):
        idxs = [i for i, p in enumerate(props)
                if (p.hash_width == 1) == (level == 1)]
        outs, nf, err, k2_plain_s, k3_plain_s = encode_parity(
            props, plans, idxs, dev)
        for i, out in zip(idxs, outs):
            par_blobs[i] = out
        max_err = max(max_err, err)
        plain_card_s["K2"] += k2_plain_s
        plain_card_s["K3"] += k3_plain_s
        phase("encode_parity", level=f"m{level}", streams=len(idxs),
              fields_compared=nf, max_abs_err=err,
              k2_plain_s=f"{k2_plain_s:.3f}", k3_plain_s=f"{k3_plain_s:.3f}")

    # ----------------------------------------------------------- 10 parity
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

    # ------------------------------------------------------------ 11 plain
    max_err = max(max_err, finish_plain(jobs, procs))
    m1 = cells[1]
    plain = {(j["kernel"], j["tag"]): j for j in jobs}
    launches = {"K1": k1_launches}
    for kernel in ("K2", "K3"):
        launches[kernel] = {"encode_headline m1": cells[1]["launches"][kernel],
                            "encode_headline m2": cells[2]["launches"][kernel],
                            "encode_extract": ext["launches"][kernel]}

    def row(kernel, name, source, replaces, ms, on, bnd, tag):
        j = plain[(kernel, tag)]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[kernel][tag],
                "max_abs_err": max_err, "ms": round(ms, 4),
                "plain_ms": round(j["plain_s"] * 1e3, 2),
                "bound_ms": round(bnd[0], 6), "bound_by": bnd[1],
                "library_ms": None, "ms_on": on,
                "plain_on": f"the first {j['streams']} of those streams, "
                            f"on one CPU core of the card's host",
                "kernel_ms_on_those_streams": round(j["kernel_ms"], 4),
                "plain_card_ms": round(plain_card_s[kernel] * 1e3, 2),
                "plain_card_on": "the parity batch" if kernel == "K1"
                else "the m1 + m2 parity groups",
                "launches_by_path": launches[kernel],
                "ns_per_step": k_steps[kernel]}

    # ----------------------------------------------------------- 12 spikes
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
    k2_ms, k3_ms = m1["k2_ms"], m1["k3_ms"]
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
               "longest": {"tape_entries": m1["longest"]["tape_entries"]}}}
    phase("k_steps", **{f"{k}_{u}": f"{v:.2f}" for k, d in k_steps.items()
                        for u, v in d.items() if u != "longest"})
    phase("spikes_done", probes=len(spikes.PROBES), timings=len(srows),
          main_path_s=f"{t_main:.1f}", seconds=f"{time.time() - t0:.1f}")

    enc_on = f"{ENC_STREAMS} x {HEAD_BYTES // KB} KB m1 text"
    print(json.dumps({"kernels": [
        row("K1", "K1 decode", "csc_tpu_torch/csrc/decode_k1.cu",
            "csc_tpu/ops/pallas_decode.py:272", k1_ms,
            f"{HEAD_STREAMS} x {HEAD_BYTES // KB} KB m1 text", k1_bound,
            "headline"),
        row("K2", "K2 lazy parse", "csc_tpu_torch/csrc/encode_k2.cu",
            "csc_tpu/ops/pallas_parse.py:112", m1["k2_ms"], enc_on,
            m1["k2_bound"], "encode_headline m1"),
        row("K3", "K3 phase-B coder", "csc_tpu_torch/csrc/encode_k3.cu",
            "csc_tpu/ops/pallas_encode.py:107", m1["k3_ms"], enc_on,
            m1["k3_bound"], "encode_headline m1"),
    ] + [spike_row(f, srows, sdetail, s_launches[f]) for f in spikes.FILES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


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
