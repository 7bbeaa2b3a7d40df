"""K4's per-stream code (csc_tpu_torch/csrc/encode_k4.cuh), built with g++
through the test-only harness encode_k4_host.cpp, against the plain
PyTorch version (csc_tpu_torch.ops.parse_ap_scan) at m3, m4 and m5: the
tape, tok_cnt, done, err, the FIND positions at which the lanes ran
(finds) and every DP cell at the end, on the streams
the plain version is held to
csc_tpu with (tests/torch_edge_cases.py `ap_cases`) and on K4's edge
streams (`k4_cases`); the cells through the build's debug copy, which
every cell write of the shared-memory window updates.  Also: a match into the last column is undone at
the group's width and kept one column wider; random price tables; a
tape too short
(ERR_OVERFLOW) and the step budget cut at every step of a short group
(ERR_STEPS, the extension rounds K4 counts in closed form included);
and the match distance price both builds charge at slots 0-2, csc_tpu's
128 * max(slot + 2, 4) rather than golden's.  This is the CPU check of
the CUDA kernel's logic."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import (encode_host, parse_ap_scan, parse_pre,
                               parse_scan, pipeline, prices)
from csc_tpu_torch.ops.parse_ap_kernel import CELL_ROWS

import torch_edge_cases as edges

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
FIELDS = ("tape", "tok_cnt", "done", "err", "finds")
SMEM_DATA = 64 * 1024      # encode_k4.cu's K4_SMEM_DATA


def build_k4_host(tmp):
    """The g++ build of encode_k4_host.cpp (csc_k4_host) in `tmp`."""
    so = str(tmp / "libk4host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", os.path.join(CSRC,
                                                     "encode_k4_host.cpp"),
                    "-o", so], check=True, capture_output=True)
    fn = ctypes.CDLL(so).csc_k4_host
    fn.restype = ctypes.c_int
    fn.argtypes = [P, P, I64, I32, P, P, I32, P, P, I32, P, P, I64, I64, P,
                   P, I32, I64]
    return fn


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_k4_host(tmp_path_factory.mktemp("k4host"))


def inputs(cases, width=None):
    """(K4's tensor arguments, good_len) of a group of cases on the CPU."""
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"), width)
    p0 = props[0]
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        data, run_ends, p0.hash_bits, p0.hash_width or 8))
    pr = torch.from_numpy(prices.pack_prices(prices.snapshot_prices()))
    return (data, candp, run_ends, run_skip, sizes, dicts, pr), p0.good_len


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def k4_host(fn, args, good_len, tcap=None, max_steps=None, cells=True,
            stage_max=SMEM_DATA):
    """The g++ build's (tape, tok_cnt, done, err, finds) and its debug copy of
    the cells [B, 10, N] after the parse (None with cells=False: no copy,
    as on the encode path); streams of at most stage_max bytes read their
    data as staged words, as the kernel's of at most 64 KB do."""
    arrays = [np.ascontiguousarray(t.numpy()) for t in args]
    data, candp, run_ends = arrays[:3]
    b, n = data.shape
    tcap = tcap or parse_scan.tape_capacity(n, run_ends.shape[1])
    max_steps = max_steps or parse_ap_scan.max_steps_for(n)
    tape = np.zeros((b, tcap, 2), np.int32)
    out = np.zeros((4, b), np.int32)
    copy = None
    if cells:
        copy = np.zeros((b, CELL_ROWS, n), np.int32)
        copy[:, 1] = -1
    assert fn(_ptr(data), _ptr(candp), n, candp.shape[1], _ptr(run_ends),
              _ptr(arrays[3]), run_ends.shape[1], _ptr(arrays[4]),
              _ptr(arrays[5]), good_len, _ptr(arrays[6]), _ptr(tape), tcap,
              max_steps, None if copy is None else _ptr(copy), _ptr(out), b,
              stage_max) == 0
    return (tape, out[0], out[1], out[2], out[3]), copy


def plain(args, good_len, tcap=None, max_steps=None):
    n, r = args[0].shape[1], args[2].shape[1]
    return parse_ap_scan.parse_ap_plain(
        *args, good_len, tcap or parse_scan.tape_capacity(n, r),
        max_steps)


def cells_of(st):
    """The plain version's cells of state `st`, in K4's debug layout [B,
    10, N] (rows price, stamp, back, ndist, nstate, nxt, nrep[4])."""
    return torch.cat([torch.stack([st[name] for name in (
        "price", "stamp", "back", "ndist", "nstate", "nxt")], dim=1),
        st["nrep"]], dim=1).to(torch.int32).numpy()


def plain_cells(args, good_len, max_steps=None):
    """The plain version's outputs (finds included) and its DP cells at
    the end, in K4's cell layout [B, 10, N]."""
    n, r = args[0].shape[1], args[2].shape[1]
    st = parse_ap_scan.make_ap_state(*args, parse_scan.tape_capacity(n, r))
    finds = torch.zeros(args[0].shape[0], dtype=torch.int32)
    for _ in range(max_steps or parse_ap_scan.max_steps_for(n)):
        if bool((st["done"] == 1).all()):
            break
        before = st
        st = parse_ap_scan.ap_parse_step(st, good_len)
        finds += parse_ap_scan.found(before, st)
    return parse_ap_scan.tape_of(st) + (finds,), cells_of(st)


def assert_same(got, want, what):
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=f"{what} {name}")


@pytest.mark.parametrize("level", [3, 4, 5])
def test_k4_matches_plain(k4, level):
    seen = set()
    for cases in (edges.ap_cases(level), edges.k4_cases(level)):
        args, good_len = inputs(cases)
        got, cells = k4_host(k4, args, good_len)
        want, want_cells = plain_cells(args, good_len)
        assert_same(got, want, f"m{level}")
        # every DP cell too: the same writes in the same order
        np.testing.assert_array_equal(cells, want_cells)
        assert got[2].all() and not got[3].any()
        kinds = got[0][..., 0] & 7
        lens = (got[0][..., 0] >> 3) + 2
        lz = (kinds == constants.K_MATCH) | (kinds == constants.K_REP)
        assert (lz & (lens >= good_len)).any()
        seen |= set(np.unique(kinds).tolist())
    assert set(range(constants.K_END + 1)) <= seen


def test_last_column_match_is_undone(k4):
    """At the group's width the longest stream's last cell is the last
    column, and a match into it is undone (csc_tpu's scatter writes the
    cell back); one column wider the match stands and the parse
    differs.  The plain version at the group's width is held above."""
    differ = []
    for level in (3, 4, 5):
        for cases in (edges.ap_cases(level), edges.k4_cases(level)):
            args, good_len = inputs(cases)
            n = args[0].shape[1]
            j = int(args[4].argmax())
            assert int(args[4][j]) == n
            tcap = parse_scan.tape_capacity(n, args[2].shape[1])
            at_n, _ = k4_host(k4, args, good_len, tcap)
            wider, _ = k4_host(k4, inputs(cases, n + 1)[0], good_len, tcap)
            rows = [i for i in range(len(cases)) if i != j]
            for a, b in zip(at_n, wider):
                np.testing.assert_array_equal(a[rows], b[rows])
            differ.append(not all(np.array_equal(a[j], b[j])
                                  for a, b in zip(at_n, wider)))
    assert all(differ), differ


@pytest.mark.parametrize("level", [3, 5])
def test_k4_matches_plain_under_other_prices(k4, level):
    """Price tables other than the initial model's, where every state
    prices alike: seeded random tables make the model state matter, so a
    stretch start whose lanes settle in a later step prices with (state
    * 4) & 0x3F in both builds (the long_rep stream at m5)."""
    rng = np.random.default_rng(level)
    args, good_len = inputs(edges.k4_cases(level))
    pr = torch.from_numpy(rng.integers(1, 2000, prices.PACKED_LEN,
                                       dtype=np.int32))
    args = args[:6] + (pr,)
    got, cells = k4_host(k4, args, good_len)
    want, want_cells = plain_cells(args, good_len)
    assert_same(got, want, f"m{level}")
    np.testing.assert_array_equal(cells, want_cells)
    assert got[2].all() and not got[3].any()


@pytest.mark.parametrize("tcap", [1, 7, 40])
def test_k4_tape_overflow(k4, tcap):
    """A tape too short: tokens past its end rewrite its last entry, the
    count runs on, err is ERR_OVERFLOW."""
    args, good_len = inputs(edges.k4_cases(3))
    got, _ = k4_host(k4, args, good_len, tcap)
    assert_same(got, plain(args, good_len, tcap), f"tcap {tcap}")
    over = got[1] > tcap
    assert over.any()
    np.testing.assert_array_equal(got[3] == constants.ERR_OVERFLOW, over)


def test_k4_step_budget_at_every_step(k4):
    """The budget cut after each step of a short group's lockstep run: K4
    counts one step an action and max(1, ceil(R / 8)) a position whose
    longest lane extends R rounds, so its tape, tok_cnt, done and err
    (ERR_STEPS until the stream is done) equal the plain version's at
    every cut; the runs of one byte extend past 8 rounds at stretch
    starts."""
    text = corpus.torch_python_text(4096)
    data = [b"A" * 300 + text[:200] + b"A" * 300, b"xyz" * 6 + b"#",
            edges.four_symbols(400, 3)]
    cases = [(str(i), edges._ap_props(len(d), 3), d)
             for i, d in enumerate(data)]
    args, good_len = inputs(cases)
    n, r = args[0].shape[1], args[2].shape[1]
    tcap = parse_scan.tape_capacity(n, r)
    st = parse_ap_scan.make_ap_state(*args, tcap)
    t = 0
    multi = False
    finds = torch.zeros(len(cases), dtype=torch.int32)
    while not bool((st["done"] == 1).all()):
        before = st
        st = parse_ap_scan.ap_parse_step(st, good_len)
        t += 1
        multi |= bool(((before["armed"] == 1) & (st["armed"] == 1)).any())
        finds += parse_ap_scan.found(before, st)
        got, _ = k4_host(k4, args, good_len, max_steps=t)
        assert_same(got, parse_ap_scan.tape_of(st) + (finds,),
                    f"after {t} steps")
    assert multi and t > 500
    got, _ = k4_host(k4, args, good_len, max_steps=t - 1)
    assert (got[3] == constants.ERR_STEPS).any() and not got[2].all()


def test_match_distance_price_is_csc_tpus(k4):
    """A match at distance 1-3 (slot 0-2) costs 128 * max(slot + 2, 4) =
    512 in both builds (csc_tpu parse_ap.py:460-462), where golden's
    GetMatchDistPrice charges 256: every cell reached by such a match
    holds its origin's price plus the match flags, 512 and the length's
    price, in the g++ build's cells and in the plain version's."""
    args, good_len = inputs([c for c in edges.k4_cases(3)
                             if c[0] == "near"])
    _, cells = k4_host(k4, args, good_len)
    tcap = parse_scan.tape_capacity(args[0].shape[1], args[2].shape[1])
    st, _ = parse_ap_scan.run_ap_parse(
        parse_ap_scan.make_ap_state(*args, tcap), good_len, 10 ** 6)
    tables = prices.snapshot_prices()
    plain_cells = np.stack([st[name][0].numpy() for name in
                            ("price", "stamp", "back", "ndist", "nstate")])
    for who, (price, stamp, back, ndist, nstate) in (
            ("k4", cells[0, :5]), ("plain", plain_cells)):
        seen = 0
        for c in np.flatnonzero((ndist >= 5) & (ndist <= 7)):
            b = back[c]
            if stamp[b] != stamp[c] or b == c:
                continue
            want = (price[b] + tables["matchf"][nstate[b]] + 512
                    + tables["lenp"][min(c - b - 2, 31)])
            assert price[c] == want, (who, c)
            seen += 1
        assert seen >= 3, who
