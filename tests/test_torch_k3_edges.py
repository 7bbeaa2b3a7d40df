"""K3's expansion and coder (csc_tpu_torch/csrc/encode_k3.cuh), built with
g++ through the test-only harness encode_k3_host.cpp, against the plain
PyTorch version on the edge tapes of tests/torch_edge_cases.py: every
token kind, lengths at each slot edge and a long run of P_LONGLEN bits,
distances at each slot boundary and past 2^22, 230 flushes (the chunk
log clips), crossings at 16- and 64-byte blocks (the maps clip), capacity
cuts at each byte near the coded size, a tape without K_END, passes that
overrun the record ring and a seeded random batch of 20 000 tokens.
Every output field must be equal, in the default build (512 records a
pass) and in one of 96 records a pass, where most passes end early; and
the modelled-bit count of bits_scan must equal the coded bits the plain
version's own path takes."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu_torch import constants
from csc_tpu_torch.ops import bits_scan

import torch_edge_cases as edges

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
NAMES = ("rc", "bc", "rc_map", "bc_map", "chunk_log", "stats")
CASES = edges.k3_cases()


def _build(tmp, cap):
    so = str(tmp / f"k3host_{cap}.so")
    flags = [] if cap is None else [f"-DK3_CAP={cap}"]
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror", *flags,
                    "-shared", "-fPIC",
                    os.path.join(CSRC, "encode_k3_host.cpp"), "-o", so],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(so).csc_k3_host
    fn.restype = ctypes.c_int
    fn.argtypes = [P, P, P, P, I64, P, I64, P, I64, P, P, I32, P, I32, I64,
                   P, P, I32]
    return fn


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("k3_host")
    return {cap: _build(tmp, cap) for cap in (None, 96)}


@pytest.fixture(scope="module")
def plain():
    return {name: [t.numpy() for t in bits_scan.bits_plain(
        *(torch.from_numpy(x) for x in tp), *args)]
        for name, tp, args, _ in CASES}


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def k3_host(fn, tapes, max_rc, max_bc, nmap, nchunk, bsize):
    kk, aa, bb, cc = (np.ascontiguousarray(t) for t in tapes)
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


@pytest.mark.parametrize("cap", [None, 96])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_k3_edge_tapes_match_plain(host, plain, case, cap):
    _, tp, args, _ = next(c for c in CASES if c[0] == case)
    got = k3_host(host[cap], tp, *args)
    for name, g, w in zip(NAMES, got, plain[case]):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
    stats = got[5]
    if case == "no_end":
        assert stats[3].tolist() == [0, 1]
    else:
        assert stats[3].all()
    if case != "cuts":
        assert not stats[4].any()


def test_k3_edge_tapes_reach_what_they_are_for(plain):
    """The edge batch clips its maps and chunk log; the cuts straddle both
    capacities byte by byte; the overrun stream needs more records than a
    pass holds."""
    by = {c[0]: c for c in CASES}
    rc, bc, rmap, bmap, clog, stats = plain["edges"]
    assert stats[2].max() > 64                       # chunk log clips
    assert stats[0].max() > 64 * 16 and stats[1].max() > 64 * 16
    _, _, rmap, _, clog, stats = plain["edges_clipped"]
    assert stats[2].max() > 5 and (stats[0] > 3 * 64).any()
    _, _, args, _ = by["cuts"]
    stats = plain["cuts"][5]
    n = stats.shape[1] // 2
    for cnt, cap in ((stats[0, :n], args[0]), (stats[1, n:], args[1])):
        assert {-1, 0, 1} <= set((cnt - cap).tolist())
    over = stats[4] == constants.ERR_OVERFLOW
    np.testing.assert_array_equal(over, (stats[0] >= args[0])
                                  | (stats[1] >= args[1]))
    # a match of length 300 at distance 2^22 + 5 takes 29 records (2
    # flags, 16 for the length, 11 for the distance): 32 of them overrun
    # a pass of 512
    kinds = by["edges"][1][0]
    assert (kinds[5] == constants.K_MATCH).sum() == 64
    assert 32 * 29 > 512


def _coded_bits_of_plain(tp):
    """Bits the plain version codes through a probability, per stream:
    its steps in a bit state, counted along its own path."""
    st = bits_scan.make_bits_state(*(torch.from_numpy(x) for x in tp),
                                   4096, 4096, 64, 64)
    is_bit = bits_scan._consts(torch.device("cpu"))["is_bit"]
    count = torch.zeros(tp[0].shape[0], dtype=torch.int64)
    while not bool(((st["fsm"] == constants.B_DONE)
                    & (st["pending"] == 0)).all()):
        active = (st["done"] == 0) & (st["pending"] == 0)
        fsm_a = torch.where(active, st["fsm"], constants.B_DONE)
        count += is_bit[fsm_a].long()
        st = bits_scan.bits_step(st, 512)
    return count


@pytest.mark.parametrize("case", ["edges", "no_end"])
def test_modelled_bits_counts_the_plain_path(case):
    _, tp, _, _ = next(c for c in CASES if c[0] == case)
    if case == "edges":   # the two long runs alone take 3 500 steps
        tp = tuple(np.delete(t, 2, axis=0) for t in tp)
    want = _coded_bits_of_plain(tp)
    got = bits_scan.modelled_bits(*(torch.from_numpy(x) for x in tp))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
