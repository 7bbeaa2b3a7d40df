"""K6's per-stream code (csc_tpu_torch/csrc/encode_k6.cuh), built with g++
through the test-only harness encode_k6_host.cpp, against its plain
version (csc_tpu_torch.ops.exact_ap_scan, golden's optimal parse) at m3
and m4: the tape, tok_cnt, done, err and the block types, on the edge
streams of tests/torch_edge_cases.py `exact_ap_cases` (every run type,
the probe, raw chunks, a stretch at AP_LIMIT, the length cache rebuilt
many times), the data staged as words and read as bytes; the model each
stream leaves (the harness's `model` output) against the plain version's
shadow model; a tape too short at every kind of token (ERR_OVERFLOW, the
parse cut at the same token); and one stream alone at its width against
the same stream in a wider group; `exact_ap_far_cases` (cells entered
from good_len - 1 behind, by a match and by a rep, at the level's
good_len and at 32; a stretch at AP_LIMIT).  This is the CPU check of
the CUDA kernel's logic.  Tolerance 0."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu_torch.constants import ERR_OVERFLOW, K_END, K_SENT_A
from csc_tpu_torch.ops import (encode_host, exact_ap_scan, exact_scan,
                               parse_scan, pipeline, prices)

import torch_edge_cases as edges

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
CPU = torch.device("cpu")
# the harness's model row: the small trees, p_lit, the length cache,
# then state, ctx and the cache's counter (encode_k6_host.cpp)
MODEL_WORDS = 530 + 65536 + 32 + 3


def build_k6_host(tmp, opt="-O2"):
    """The g++ build of encode_k6_host.cpp (csc_k6_host_staged) in
    `tmp`."""
    so = str(tmp / "libk6host.so")
    subprocess.run(["g++", opt, "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", os.path.join(CSRC,
                                                     "encode_k6_host.cpp"),
                    "-o", so], check=True, capture_output=True)
    fn = ctypes.CDLL(so).csc_k6_host_staged
    fn.restype = ctypes.c_int
    fn.argtypes = [P, I64, P, I32, P, P, I32, I32, I32, P, P, P, P, P, I64,
                   P, P, I32, I64, P, I32, I32, P, P, P, I64]
    return fn


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_k6_host(tmp_path_factory.mktemp("k6host"))


def k6_args(cases, width=None, tcap=None):
    """K6's arguments for a group of (name, props, data) cases of one
    preset, on the CPU, as the encode path gives them (at m5 the binary
    tree's and each stream's bt_size)."""
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2], exact=True) for c in cases]
    data, blocks, sizes, dicts = pipeline.block_inputs(
        props, plans, list(range(len(cases))), CPU, width)
    p0 = props[0]
    bt = exact_ap_scan.BT.of(p0)
    return (data, blocks, sizes, dicts, p0.hash_bits, p0.hash_width,
            p0.good_len,
            tcap or parse_scan.tape_capacity(data.shape[1],
                                             blocks.shape[1]),
            bt if bt.size else None,
            torch.tensor([p.bt_size for p in props], dtype=torch.int32)
            if bt.size else None)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def k6_host(fn, args, stage_max=1 << 16, model=False):
    """The g++ build's (tape, tok_cnt, done, err, btypes) as numpy, and
    with model=True the model rows [B, MODEL_WORDS]; streams of at most
    stage_max bytes staged as words."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, tcap = \
        args[:8]
    bt, bt_sizes = (tuple(args[8:10]) + (None, None))[:2]
    d = np.ascontiguousarray(data.numpy())
    bl = np.ascontiguousarray(blocks.numpy())
    b, n = d.shape
    p2b = np.array(prices.P_2_BITS, np.uint16)
    tables = [np.zeros((b, s), np.int32)
              for s in exact_scan.table_sizes(hash_bits, hash_width)]
    tape = np.zeros((b, tcap, 2), np.int32)
    out = np.zeros((3, b), np.int32)
    btypes = np.zeros(bl.shape[:2], np.int32)
    rows = np.zeros((b, MODEL_WORDS), np.int32)
    tree = (0, 0, None, None, None, 0)
    if bt is not None:
        if bt_sizes is None:
            bt_sizes = torch.full((b,), bt.size, dtype=torch.int32)
        bts = np.ascontiguousarray(bt_sizes.numpy())
        stride = 2 * min(int(bts.max()), n + 1)
        head = np.zeros((b, 1 << bt.bits), np.int32)
        nodes = np.zeros((b, stride), np.int32)
        tree = (bt.bits, bt.cyc, _ptr(bts), _ptr(head), _ptr(nodes), stride)
    rc = fn(_ptr(d), n, _ptr(bl), bl.shape[1],
            _ptr(np.ascontiguousarray(sizes.numpy())),
            _ptr(np.ascontiguousarray(dicts.numpy())), hash_bits,
            hash_width, good_len, _ptr(p2b), *(_ptr(t) for t in tables),
            _ptr(tape), tcap, _ptr(out), _ptr(btypes), b, stage_max,
            _ptr(rows) if model else None, *tree)
    assert rc == 0
    res = (tape, out[0], out[1], out[2], btypes)
    return res + (rows,) if model else res


def assert_same(got, want):
    """Every field of K6's outputs, the tape over tok_cnt tokens."""
    want = [w.numpy() if torch.is_tensor(w) else w for w in want]
    np.testing.assert_array_equal(got[1], want[1])
    for j, c in enumerate(want[1]):
        np.testing.assert_array_equal(got[0][j, :c], want[0][j, :c])
    for k in (2, 3, 4):
        np.testing.assert_array_equal(got[k], want[k])


def model_row(m):
    """A shadow model as the harness's model row."""
    small = (m.p_state + m.p_repdist + m.p_matchlen_slot
             + m.p_matchlen_extra1 + m.p_matchlen_extra2
             + m.p_matchlen_extra3)
    return np.array(small + m.p_lit + m.len_price
                    + [m.state, m.ctx, m.lp_rebuild_int], np.int32)


@pytest.mark.parametrize("level", [3, 4])
def test_host_equals_plain_on_every_field(k6, level):
    cases = edges.exact_ap_cases(level)
    args = k6_args(cases)
    trace = []
    want = exact_ap_scan.exact_ap_plain(*args, trace=trace)
    assert bool((want[2] == 1).all()) and bool((want[3] == 0).all())
    for stage_max in (1 << 16, 0):          # staged words, then bytes
        got = k6_host(k6, args, stage_max, model=True)
        assert_same(got, want)
        for (name, _, _), row, s in zip(cases, got[5], trace):
            np.testing.assert_array_equal(row, model_row(s.model),
                                          err_msg=name)


@pytest.mark.parametrize("level", [3, 4])
def test_host_equals_plain_on_k5s_edge_streams(k6, level):
    """K5's edge streams (`exact_cases`: the sub-block end, HT2's quirk,
    long runs slid four positions a step, the good_len exits, many
    records; `k5_lane_cases`: the lane hazards of the finder K6 shares)
    at m3 / m4: every field."""
    for cases in (edges.exact_cases(level), edges.k5_lane_cases(level)):
        args = k6_args(cases)
        want = exact_ap_scan.exact_ap_plain(*args)
        assert bool((want[2] == 1).all())
        assert_same(k6_host(k6, args), want)


def check_far_cases(k6, level, past, good_len):
    """K6's g++ build against the plain version on `exact_ap_far_cases`,
    staged and unstaged: every field; each case reaches what it is there
    for, by the plain version's records."""
    cases = edges.exact_ap_far_cases(level, past, good_len)
    args = k6_args(cases)
    trace = []
    want = exact_ap_scan.exact_ap_plain(*args, trace=trace)
    assert bool((want[2] == 1).all()) and bool((want[3] == 0).all())
    st = {name: s.stats for (name, _, _), s in zip(cases, trace)}
    good = cases[0][1].good_len
    assert st["reps"]["match_reach"] == st["reps"]["rep_reach"] == good - 1
    assert st["limit"]["at_limit"]
    assert all((s["ring_wraps"] > 0) == past for s in st.values())
    for stage_max in (1 << 16, 0):
        assert_same(k6_host(k6, args, stage_max), want)


@pytest.mark.parametrize("good_len", [None, 32], ids=["preset", "good32"])
@pytest.mark.parametrize("level", [3, 4])
def test_host_equals_plain_on_far_back_cells(k6, level, good_len):
    """Cells entered from a back cell good_len - 1 behind, the farthest a
    relaxed length reaches, by a match and by a rep (at good_len 32,
    MAX_GOOD, from 31 behind); a stretch that runs to AP_LIMIT; streams
    their dictionary covers."""
    check_far_cases(k6, level, False, good_len)


def test_tape_overflow_cuts_at_the_same_token(k6):
    """A tape of capacity c ends the parse at its (c + 1)-th token: done
    0, err ERR_OVERFLOW, tok_cnt c, the first c tokens and the blocks
    typed so far as the plain version has them; caps at a literal, a
    match, a run's end marker and the stream's end."""
    cases = [c for c in edges.exact_ap_cases(3)
             if c[0] in ("dlt", "entropy_lz", "chunks")]
    full = exact_ap_scan.exact_ap_plain(*k6_args(cases))
    tape, cnt = full[0].numpy(), full[1].numpy()
    caps = {1, 2, 17, int(cnt.min()) - 1, int(cnt.max()) - 1}
    for j in range(len(cases)):
        kinds = tape[j, :cnt[j], 0] & 7
        caps.update(int(np.flatnonzero(kinds == k)[0])
                    for k in (K_SENT_A, K_END, 1) if (kinds == k).any())
    for cap in sorted(c for c in caps if c >= 1):
        args = k6_args(cases, tcap=cap)
        want = exact_ap_scan.exact_ap_plain(*args)
        assert_same(k6_host(k6, args), want)
        short = cnt > cap
        assert (want[1].numpy()[short] == cap).all()
        assert (want[2].numpy()[short] == 0).all()
        assert (want[3].numpy()[short] == ERR_OVERFLOW).all()
        np.testing.assert_array_equal(want[0].numpy()[:, :cap],
                                      tape[:, :cap])


def test_one_stream_alone_equals_it_in_a_group(k6):
    """The parse of a stream does not depend on the group's width or its
    neighbours."""
    cases = edges.exact_ap_cases(4)
    group = k6_host(k6, k6_args(cases))
    j = [c[0] for c in cases].index("limit")
    alone = k6_host(k6, k6_args([cases[j]]))
    assert alone[1][0] == group[1][j]
    np.testing.assert_array_equal(alone[0][0, :alone[1][0]],
                                  group[0][j, :alone[1][0]])
    nb = alone[4].shape[1]
    np.testing.assert_array_equal(alone[4][0], group[4][j, :nb])
