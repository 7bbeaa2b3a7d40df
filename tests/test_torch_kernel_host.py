"""K1's per-stream decoder (csc_tpu_torch/csrc/decode_k1.cuh), built with
g++ through the test-only harness decode_k1_host.cpp, against the plain
PyTorch version: the window, block log, wnd_pos, done and err of every
stream must be equal, on the parity batch, under a window too small for
one stream, and under a step cap.  This is the CPU check of the CUDA
kernel's logic.  The edge streams drive each mechanism of the kernel's
design: copies at distances under 16, of 16, at the shared ring's reach
(8192) and beyond it, copies across the ring's wrap, coder words refilled
across block ends and chunk resets, a DLT block longer than the ring,
coder arrays cut inside a buffered word, and step caps that land inside
a copy and inside a literal."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu.golden.encoder import encode_stream
from csc_tpu_torch import corpus
from csc_tpu_torch.ops import decode_scan, pipeline

import torch_edge_cases as edges

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
N = 1536


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    so = str(tmp_path_factory.mktemp("k1host") / "libk1host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", os.path.join(CSRC,
                                                     "decode_k1_host.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.csc_k1_host.restype = ctypes.c_int
    lib.csc_k1_host.argtypes = [p, i64, p, i64, p, i32, p, i32, p, i64, i64,
                                p, p, i32, i64, p, i32]
    return lib


@pytest.fixture(scope="module")
def batch():
    text = corpus.words(8 * N, seed=6)
    cases = corpus.parity_cases(text, corpus.torch_library_exe(), N, seed=7,
                                chunk=1024, big=40 * 1024)
    blobs = [encode_stream(p, d) for _, p, d in cases]
    blobs[-1] = corpus.flip(blobs[-1])
    props = [p for _, p, _ in cases]
    rc, bc, rce, bce = pipeline._demux(props, blobs, [0] * len(blobs))
    return cases, rc, bc, rce, bce


def _host(lib, rc, bc, rce, bce, wnd_size, max_steps, max_blocks=4096):
    b = rc.shape[0]
    wnd = np.zeros((b, wnd_size + 16), np.uint8)
    log = np.zeros((b, max_blocks, 2), np.int32)
    pdelta = np.empty((b, 65536), np.uint16)
    out = np.zeros((4, b), np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)
    assert lib.csc_k1_host(
        ptr(rc), rc.shape[1], ptr(bc), bc.shape[1], ptr(rce), rce.shape[1],
        ptr(bce), bce.shape[1], ptr(wnd), wnd.shape[1], wnd_size,
        ptr(pdelta), ptr(log), max_blocks, max_steps, ptr(out), b) == 0
    return wnd, log, out[0], out[1], out[2], out[3]


def _plain(rc, bc, rce, bce, wnd_size, max_steps, max_blocks=4096):
    res = decode_scan.decode_plain(
        *(torch.from_numpy(a) for a in (rc, bc, rce, bce)), wnd_size,
        max_steps, max_blocks)
    return [r.numpy() for r in res]


def _assert_same(host, plain):
    for name, h, p in zip(("wnd", "blk_log", "wnd_pos", "done", "err",
                           "blk_cnt"), host, plain):
        np.testing.assert_array_equal(h, p, err_msg=name)


def test_parity_batch(host_lib, batch):
    cases, rc, bc, rce, bce = batch
    wnd_size = pipeline._bucket(max(len(d) for _, _, d in cases))
    steps = 10 ** 7
    host = _host(host_lib, rc, bc, rce, bce, wnd_size, steps)
    _assert_same(host, _plain(rc, bc, rce, bce, wnd_size, steps))
    wnd, _, pos, done, err, _ = host
    for i, (name, _, data) in enumerate(cases[:-1]):
        assert done[i] == 1 and err[i] == 0, name
        assert pos[i] == len(data), name
    # EXE bytes stay filtered in the window; the host pass inverts them
    assert wnd[0, :pos[0]].tobytes() == cases[0][2]
    assert err[-1] == 1 or wnd[-1, :pos[-1]].tobytes() != cases[-1][2]


def test_window_overflow_and_step_cap(host_lib, batch):
    cases, rc, bc, rce, bce = batch
    # the 40 KB stream outgrows a 4 KB window and reports where it would
    # have got to; the step cap stops the rest mid-stream
    host = _host(host_lib, rc, bc, rce, bce, 4096, 1500)
    _assert_same(host, _plain(rc, bc, rce, bce, 4096, 1500))
    _, _, pos, done, err, _ = host
    i = [c[0] for c in cases].index("dict_lt_output")
    assert err[i] == 1 and pos[i] > 4096
    assert not done.all()


def test_small_block_log(host_lib, batch):
    cases, rc, bc, rce, bce = batch
    i = [c[0] for c in cases].index("multichunk")
    one = [a[i:i + 1] for a in (rc, bc, rce, bce)]
    host = _host(host_lib, *one, 8192, 10 ** 7, max_blocks=2)
    assert host[5][0] > 2             # 3 typed blocks + EOF in a log of 2
    _assert_same(host, _plain(*one, 8192, 10 ** 7, 2))


@pytest.fixture(scope="module")
def edge():
    cases = edges.k1_cases()
    blobs = [encode_stream(p, d) for _, p, d in cases]
    rc, bc, rce, bce = pipeline._demux([p for _, p, _ in cases], blobs,
                                       [0] * len(blobs))
    wnd_size = pipeline._bucket(max(len(d) for _, _, d in cases))
    return cases, (rc, bc, rce, bce), wnd_size


def test_edge_streams(host_lib, edge):
    cases, arrays, wnd_size = edge
    steps = 10 ** 7
    host = _host(host_lib, *arrays, wnd_size, steps)
    _assert_same(host, _plain(*arrays, wnd_size, steps))
    wnd, log, pos, done, err, cnt = host
    for i, (name, _, data) in enumerate(cases):
        assert done[i] == 1 and err[i] == 0, name
        assert wnd[i, :pos[i]].tobytes() == data, name
    names = [c[0] for c in cases]
    i = names.index("dlt_then_lz")
    types = set(log[i, :cnt[i], 0].tolist())
    assert types & {0x10, 0x11, 0x12, 0x13, 0x14} and 0x01 in types
    assert cnt[names.index("multichunk")] > 5     # chunk resets


@pytest.mark.parametrize("which", ["rc", "bc"])
def test_stream_cut_inside_a_word(host_lib, edge, which):
    cases, (rc, bc, rce, bce), wnd_size = edge
    ends = rce if which == "rc" else bce
    used = np.where(ends < 0x7FFFFFFF, ends, 0).max(axis=1)
    # an odd length that cuts every stream with more coded bytes
    n = int(np.sort(used)[len(used) // 2]) - 3 | 1
    if which == "rc":
        rc = edges.cut(rc, n)
    else:
        bc = edges.cut(bc, n)
    host = _host(host_lib, rc, bc, rce, bce, wnd_size, 10 ** 7)
    _assert_same(host, _plain(rc, bc, rce, bce, wnd_size, 10 ** 7))
    err = host[4]
    assert err[used > n].all() and not err[used + 8 < n].any()


@pytest.mark.parametrize("where", ["copy", "literal"])
def test_step_cap_inside(host_lib, edge, where):
    cases, arrays, wnd_size = edge
    one = [a[:1] for a in arrays]           # short_dist: runs, then text
    cap = edges.caps_inside(one, wnd_size, 0, 4000)[where]
    for steps in (cap, cap + 1):
        host = _host(host_lib, *arrays, wnd_size, steps)
        _assert_same(host, _plain(*arrays, wnd_size, steps))
        assert not host[3].any()


def test_step_cap_at_every_step(host_lib, edge):
    """A step cap at each of the first 2500 micro-ops of the edge streams
    (runs, far copies, a DLT block, text with matches and chunk resets)
    stops the kernel's decoder where it stops the plain version: the
    quick paths that skip per-bit checks count their micro-ops exactly."""
    _, arrays, wnd_size = edge
    for t, want in edges.plain_each_step(arrays, wnd_size, 2500):
        _assert_same(_host(host_lib, *arrays, wnd_size, t), want)
