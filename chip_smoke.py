#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (csc_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; the first failure raises:
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    K1 (csrc/decode_k1.cu) with nvcc into build/, with its
              ptxas resource report
  3. corpus   text = this machine's torch/**/*.py, exe = torch/lib/
              libc10.so, plus seeded random / DLT data; golden encodes,
              cached in build/corpus/
  4. parity   K1 against its plain PyTorch version on the same CUDA
              tensors, every output field, on the parity batch
  5. headline decode_batch of 128 x 16 KB m1 text (the main path), its
              wall and kernel time, and the plain version's time
  6. extract  one archiver extract group: 256 x 1 MB m1 text
  7. cli      `csc_tpu_torch.cli d --backend cuda` on a 256 KB-dict,
              1 MB stream (no declared size: the window regrows)
The last two lines are the kernels' JSON record and the ok line.
"""
import glob
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from csc_tpu.golden.decoder import DecodeError  # noqa: E402
from csc_tpu.props import props_init, read_properties, write_properties  # noqa: E402
from csc_tpu_torch import _build, corpus  # noqa: E402
from csc_tpu_torch.ops import decode_kernel, decode_scan, pipeline  # noqa: E402

SEED = 20261016
KB, MB = 1024, 1024 * 1024
PARITY_BYTES = 4 * KB                 # per parity stream
HEAD_STREAMS, HEAD_BYTES = 128, 16 * KB   # bench.py's headline shape
GROUP_SLICES, GROUP_REPEAT, GROUP_BYTES = 4, 64, MB   # one extract group
CLI_DICT, CLI_BYTES = 256 * KB, MB
CACHE = os.path.join(_build.BUILD_DIR, "corpus")
NO_STEP_CAP = 1 << 62     # K1 and the plain version run each stream out
FIELDS = ("wnd", "blk_log", "wnd_pos", "done", "err", "blk_cnt")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def encode_all(cases, pool):
    """Golden raw streams for (name, props, data) cases, cached on disk by
    a hash of the input and the props."""
    os.makedirs(CACHE, exist_ok=True)
    paths, todo = [], []
    for case in cases:
        h = hashlib.sha256(repr(case[1]).encode() + case[2]).hexdigest()
        paths.append(os.path.join(CACHE, h[:32] + ".csc"))
        if not os.path.exists(paths[-1]):
            todo.append(len(paths) - 1)
    for i, blob in zip(todo, pool.map(corpus.encode_case,
                                      [cases[i] for i in todo])):
        with open(paths[i] + ".tmp", "wb") as f:
            f.write(blob)
        os.replace(paths[i] + ".tmp", paths[i])
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    return out, len(todo)


def upload(props, blobs, positions, dev):
    rc, bc, rce, bce = pipeline._demux(props, blobs, positions)
    return [torch.from_numpy(a).to(dev) for a in (rc, bc, rce, bce)]


def kernel_ms(args, wnd_size, reps):
    """Median device time of K1 over `reps` launches (CUDA events)."""
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        decode_kernel.decode_k1(*args, wnd_size, NO_STEP_CAP)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def layer_ms(props, blobs, sizes, dev):
    """One decode_batch pass split by layer, each ended by a synchronize:
    host demux + pad, upload, K1 (with its scratch fills), copy back,
    host post-pass (bytes + inverse filters).  Milliseconds."""
    t = [time.time()]
    rc, bc, rce, bce = pipeline._demux(props, blobs, [0] * len(blobs))
    t.append(time.time())
    args = [torch.from_numpy(a).to(dev) for a in (rc, bc, rce, bce)]
    torch.cuda.synchronize()
    t.append(time.time())
    wnd_size = pipeline._bucket(max(sizes))
    wnd, log, pos, _, _, cnt = decode_kernel.decode_k1(
        *args, wnd_size, NO_STEP_CAP)
    torch.cuda.synchronize()
    t.append(time.time())
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


def main():
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
    _build.k1_library()
    phase("build", seconds=f"{time.time() - t0:.2f}")
    rep = subprocess.run(
        [_build._nvcc()] + _build.NVCC_FLAGS + [
            "-Xptxas", "-v", "-o", os.path.join(_build.BUILD_DIR,
                                                "ptxas_report.so"),
            os.path.join(_build.CSRC, "decode_k1.cu")],
        capture_output=True, text=True, check=True)
    for line in rep.stderr.splitlines():
        if "registers" in line or "spill" in line:
            phase("ptxas", line=line.strip())

    # ------------------------------------------------------------ 3 corpus
    t0 = time.time()
    tdir = os.path.dirname(torch.__file__)
    parts = []
    for f in sorted(glob.glob(os.path.join(tdir, "**", "*.py"),
                              recursive=True)):
        with open(f, "rb") as fh:
            parts.append(fh.read())
    text = b"".join(parts)
    exe = corpus.torch_library_exe()
    check(len(text) >= 8 * MB, f"text corpus only {len(text)} bytes")
    rng = np.random.default_rng(SEED)

    par = corpus.parity_cases(text, exe, PARITY_BYTES, SEED, chunk=8 * KB,
                              big=64 * KB)
    head = [("m1_head", props_init(HEAD_BYTES, 1),
             text[i * HEAD_BYTES:(i + 1) * HEAD_BYTES])
            for i in range(HEAD_STREAMS)]
    offs = sorted(int(o) for o in rng.choice(
        len(text) // GROUP_BYTES - 2, GROUP_SLICES + 1, replace=False))
    group = [("m1_group", props_init(GROUP_BYTES, 1),
              text[o * GROUP_BYTES:(o + 1) * GROUP_BYTES])
             for o in offs[:GROUP_SLICES]]
    o = offs[-1] * GROUP_BYTES
    cli_case = ("cli", props_init(CLI_DICT, 1), text[o:o + CLI_BYTES])
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=os.cpu_count() or 4,
                             mp_context=ctx) as pool:
        blobs, n_new = encode_all(par + head + group + [cli_case], pool)
    par_blobs = blobs[:len(par)]
    head_blobs = blobs[len(par):len(par) + HEAD_STREAMS]
    group_blobs = blobs[len(par) + HEAD_STREAMS:-1]
    cli_blob = blobs[-1]
    phase("corpus", text_bytes=len(text), exe_bytes=len(exe),
          encoded=n_new, cached=len(blobs) - n_new,
          seconds=f"{time.time() - t0:.1f}")

    # ------------------------------------------------------------ 4 parity
    par_blobs[-1] = corpus.flip(par_blobs[-1])
    props = [c[1] for c in par]
    args = upload(props, par_blobs, [0] * len(par), dev)
    wnd_size = pipeline._bucket(max(len(c[2]) for c in par))
    launches = decode_kernel.LAUNCHES
    got = decode_kernel.decode_k1(*args, wnd_size, NO_STEP_CAP)
    torch.cuda.synchronize()
    check(decode_kernel.LAUNCHES == launches + 1, "K1 did not launch")
    t0 = time.time()
    want = decode_scan.decode_plain(*args, wnd_size, NO_STEP_CAP)
    torch.cuda.synchronize()
    plain_par_s = time.time() - t0
    got = [t.cpu().numpy() for t in got]
    want = [t.cpu().numpy() for t in want]
    wnd_k, log_k, pos_k, done_k, err_k, cnt_k = got
    wnd_p, log_p, pos_p, done_p, err_p, cnt_p = want
    max_err = 0
    for i, (name, _, data) in enumerate(par[:-1]):
        for fname, k, p in zip(FIELDS, got, want):
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
        except DecodeError:
            pass
    types = sorted({int(t) for j in range(len(par) - 1)
                    for t in log_k[j, :cnt_k[j], 0]})
    phase("parity", streams=len(par), fields_equal=True, max_abs_err=max_err,
          flipped_flagged=bool(flagged_k), flipped_identical=flipped_identical,
          block_types=types, plain_seconds=f"{plain_par_s:.3f}")

    # ---------------------------------------------------------- 5 headline
    hp = [read_properties(write_properties(c[1])) for c in head]
    hd = [c[2] for c in head]
    sizes = [len(d) for d in hd]
    decode_kernel.LAUNCHES = 0
    outs = pipeline.decode_batch(hp, head_blobs, out_sizes=sizes, device=dev)
    main_launches = decode_kernel.LAUNCHES
    check(main_launches >= 1, "main path did not launch K1")
    check(outs == hd, "headline: decoded bytes differ from input")
    walls = []
    for _ in range(5):
        t0 = time.time()
        outs = pipeline.decode_batch(hp, head_blobs, out_sizes=sizes,
                                     device=dev)
        walls.append(time.time() - t0)
    check(outs == hd, "headline: decoded bytes differ (timed run)")
    wall = statistics.median(walls)
    # kernel and plain version on the inputs the main path gives K1
    hargs = upload(hp, head_blobs, [0] * HEAD_STREAMS, dev)
    wnd16 = pipeline._bucket(HEAD_BYTES)
    k_ms = kernel_ms(hargs, wnd16, 5)
    kout = [t.cpu().numpy() for t in
            decode_kernel.decode_k1(*hargs, wnd16, NO_STEP_CAP)]
    t0 = time.time()
    pout = decode_scan.decode_plain(*hargs, wnd16, NO_STEP_CAP)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    for fname, k, p in zip(FIELDS, kout, pout):
        diff = int(np.abs(k.astype(np.int64)
                          - p.cpu().numpy().astype(np.int64)).max())
        max_err = max(max_err, diff)
        check(diff == 0, f"headline: kernel and plain differ in {fname}")
    layers = layer_ms(hp, head_blobs, sizes, dev)
    total = sum(sizes)
    phase("headline_layers", **layers)
    phase("headline", streams=HEAD_STREAMS, bytes=total, launches=main_launches,
          wall_median_s=f"{wall:.4f}",
          wall_mbps=f"{total / wall / 1e6:.2f}",
          kernel_ms=f"{k_ms:.3f}", kernel_mbps=f"{total / k_ms / 1e3:.2f}",
          plain_ms=f"{plain_ms:.1f}",
          note="plain: one lockstep step per micro-op of the longest stream")

    # ----------------------------------------------------------- 6 extract
    gp = [c[1] for c in group] * GROUP_REPEAT
    gb = group_blobs * GROUP_REPEAT
    gd = [c[2] for c in group] * GROUP_REPEAT
    gbytes = sum(len(d) for d in gd)
    t0 = time.time()
    outs = pipeline.decode_batch(gp, gb, out_sizes=[len(d) for d in gd],
                                 device=dev)
    g_wall = time.time() - t0
    check(outs == gd, "extract group: decoded bytes differ from input")
    del outs
    gargs = upload(gp, gb, [0] * len(gb), dev)
    g_ms = kernel_ms(gargs, pipeline._bucket(GROUP_BYTES), 1)
    del gargs
    glayers = layer_ms(gp, gb, [len(d) for d in gd], dev)
    phase("extract_layers", **glayers)
    phase("extract", streams=len(gb), bytes=gbytes, wall_s=f"{g_wall:.3f}",
          wall_mbps=f"{gbytes / g_wall / 1e6:.2f}", kernel_ms=f"{g_ms:.1f}",
          kernel_mbps=f"{gbytes / g_ms / 1e3:.2f}")

    # --------------------------------------------------------------- 7 cli
    from csc_tpu_torch import cli
    sdir = os.path.join(_build.BUILD_DIR, "smoke")
    os.makedirs(sdir, exist_ok=True)
    src, dst = os.path.join(sdir, "cli.csc"), os.path.join(sdir, "cli.out")
    with open(src, "wb") as f:
        f.write(write_properties(cli_case[1]) + cli_blob)
    t0 = time.time()
    check(cli.main(["d", "--backend", "cuda", src, dst]) == 0, "cli failed")
    with open(dst, "rb") as f:
        check(f.read() == cli_case[2], "cli: decoded bytes differ")
    phase("cli", dict_size=cli_case[1].dict_size, bytes=len(cli_case[2]),
          seconds=f"{time.time() - t0:.2f}", regrow="dict < output")

    print(json.dumps({"kernels": [{
        "name": "K1 decode",
        "route": "cuda",
        "source": "csc_tpu_torch/csrc/decode_k1.cu",
        "replaces": "csc_tpu/ops/pallas_decode.py:272",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": round(k_ms, 4),
        "plain_ms": round(plain_ms, 2),
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
