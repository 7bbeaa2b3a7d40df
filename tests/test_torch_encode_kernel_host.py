"""K2's and K3's per-stream code (csc_tpu_torch/csrc/encode_k2.cuh and
encode_k3.cuh), built with g++ through the test-only harnesses
encode_k2_host.cpp and encode_k3_host.cpp, against the plain PyTorch
versions: the K2 tape, tok_cnt, done and err at m1 and m2, and the K3
rc / bc bytes, crossing maps (a 512-byte block size fills them), chunk
log, counts, done and err, also with the output capacity cut until
ERR_OVERFLOW fires.  This is the CPU check of the CUDA kernels' logic."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import (bits_scan, encode_host, parse_pre, parse_scan,
                               pipeline, stitch)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


def _build(tmp, src, fn, argtypes):
    so = str(tmp / (src + ".so"))
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", os.path.join(CSRC, src), "-o", so],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    getattr(lib, fn).restype = ctypes.c_int
    getattr(lib, fn).argtypes = argtypes
    return getattr(lib, fn)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("enc_host")
    k2 = _build(tmp, "encode_k2_host.cpp", "csc_k2_host",
                [P, P, I64, I32, P, P, I32, P, P, I32, P, I64, P, I32])
    k3 = _build(tmp, "encode_k3_host.cpp", "csc_k3_host",
                [P, P, P, P, I64, P, I64, P, I64, P, P, I32, P, I32, I64, P,
                 P, I32])
    return k2, k3


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _cases(level):
    return corpus.encode_cases(level, n=1536, seed=81)


def _inputs(level):
    cases = _cases(level)
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    p0 = props[0]
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        data, run_ends, p0.hash_bits, p0.hash_width))
    return plans, p0, (data, candp, run_ends, run_skip, sizes, dicts)


def _k2_host(fn, inputs, good_len, tcap):
    data, candp, run_ends, run_skip, sizes, dicts = (
        np.ascontiguousarray(t.numpy()) for t in inputs)
    b, n = data.shape
    tape = np.zeros((b, tcap, 2), np.int32)
    out = np.zeros((3, b), np.int32)
    assert fn(_ptr(data), _ptr(candp), n, candp.shape[1], _ptr(run_ends),
              _ptr(run_skip), run_ends.shape[1], _ptr(sizes), _ptr(dicts),
              good_len, _ptr(tape), tcap, _ptr(out), b) == 0
    return tape, out[0], out[1], out[2]


def _k3_host(fn, tapes, max_rc, max_bc, nmap, nchunk, bsize):
    kk, aa, bb, cc = (np.ascontiguousarray(t.numpy()) for t in tapes)
    b, t = kk.shape
    rc = np.zeros((b, max_rc), np.uint8)
    bc = np.zeros((b, max_bc), np.uint8)
    rmap = np.zeros((b, nmap), np.int32)
    bmap = np.zeros((b, nmap), np.int32)
    clog = np.zeros((b, nchunk, 2), np.int32)
    pdelta = np.empty((b, 65536), np.uint16)
    stats = np.zeros((5, b), np.int32)
    assert fn(_ptr(kk), _ptr(aa), _ptr(bb), _ptr(cc), t, _ptr(rc), max_rc,
              _ptr(bc), max_bc, _ptr(rmap), _ptr(bmap), nmap, _ptr(clog),
              nchunk, bsize, _ptr(pdelta), _ptr(stats), b) == 0
    return rc, bc, rmap, bmap, clog, stats


def _assert_same(names, host, plain):
    for name, h, p in zip(names, host, plain):
        np.testing.assert_array_equal(h, p.numpy(), err_msg=name)


@pytest.mark.parametrize("level", [1, 2])
def test_k2_matches_plain(host, level):
    plans, p0, inputs = _inputs(level)
    tcap = parse_scan.tape_capacity(inputs[0].shape[1], inputs[2].shape[1])
    got = _k2_host(host[0], inputs, p0.good_len, tcap)
    want = parse_scan.parse_plain(*inputs, p0.good_len, tcap)
    _assert_same(("tape", "tok_cnt", "done", "err"), got, want)
    assert got[2].all() and not got[3].any()
    kinds = got[0][..., 0] & 7
    assert (kinds == constants.K_REP).any()
    assert ((got[0][..., 0] >> 3) + 2 > 100).any()   # long live extension


def test_k3_matches_plain(host):
    plans, p0, inputs = _inputs(2)
    tcap = parse_scan.tape_capacity(inputs[0].shape[1], inputs[2].shape[1])
    tape, tok_cnt, _, _ = _k2_host(host[0], inputs, p0.good_len, tcap)
    run_tables = [pl[1] for pl in plans]
    tapes = stitch.stitch_tapes(torch.from_numpy(
        tape[:, :tok_cnt.max()].copy()), inputs[0], run_tables)[:4]
    n = inputs[0].shape[1]
    names = ("rc", "bc", "rc_map", "bc_map", "chunk_log", "stats")
    # full capacity, a 512-byte block size: the crossing maps fill
    args = (2 * n + 4096, n + 4096, (2 * n + 4096) // 512 + 1, 4, 512)
    got = _k3_host(host[1], tapes, *args)
    _assert_same(names, got, bits_scan.bits_plain(*tapes, *args))
    stats = got[5]
    assert stats[3].all() and not stats[4].any()
    assert (got[2] > 0).any() and stats[2].max() == 3
    # capacity cut below the coded size of the text and BAD streams, not
    # of the multichunk one: ERR_OVERFLOW, writes clip at the last byte
    # while the counts run on
    small = (256, 128, 2, 4, 512)
    rows = torch.tensor([0, 2, 5])
    tapes = [t[rows].contiguous() for t in tapes]
    got = _k3_host(host[1], tapes, *small)
    _assert_same(names, got, bits_scan.bits_plain(*tapes, *small))
    over = got[5][4] == constants.ERR_OVERFLOW
    assert over.any() and not over.all()
    np.testing.assert_array_equal(
        over, (got[5][0] >= 256) | (got[5][1] >= 128))
