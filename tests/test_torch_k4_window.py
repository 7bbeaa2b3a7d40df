"""K4's window of DP cells and its lanes across the warp
(csc_tpu_torch/csrc/encode_k4.cuh), built with g++ through the test-only
harness encode_k4_host.cpp, against the plain PyTorch version
(csc_tpu_torch.ops.parse_ap_scan) on the tape, tok_cnt, done, err, the
FIND positions at which the lanes ran and every DP cell (the harness's
debug copy):

  - a stretch that runs to the top of the window at good_len 48: the
    plain version's stamped cells reach offset AP_LIMIT - 1 and no
    further, and its cap branch never fires (so AP_LIMIT + 1 cells hold
    a stretch);
  - a match whose relaxation lands on the last column (n - 1), at width n
    and n + 1;
  - C = 4 and C = 10 candidate rows with every rep lane and every
    candidate row recording at one position, each pricing its own
    lengths (tests/torch_edge_cases.py `k4_lane_inputs`);
  - every step budget across FIND positions of several 8-round steps;
  - the build with no cell copy, and with its data read as bytes rather
    than staged words, gives the same outputs.
"""
import numpy as np
import pytest
import torch

from csc_tpu_torch import constants
from csc_tpu_torch.ops import parse_ap_scan, parse_scan

import torch_edge_cases as edges
from test_torch_parse_ap_host import (assert_same, cells_of,  # noqa: F401
                                      inputs, k4, k4_host)


def tcap_of(args):
    return parse_scan.tape_capacity(args[0].shape[1], args[2].shape[1])


def plain_run(args, good_len, watch=None):
    """The plain version run to the end, step by step: (outputs, cells
    [B, 10, N]), and watch(before, after, step, outputs) after each
    step."""
    st = parse_ap_scan.make_ap_state(*args, tcap_of(args))
    t = 0
    finds = torch.zeros(args[0].shape[0], dtype=torch.int32)
    while not bool((st["done"] == 1).all()):
        before = st
        st = parse_ap_scan.ap_parse_step(st, good_len)
        t += 1
        finds = finds + parse_ap_scan.found(before, st)
        if watch is not None:
            watch(before, st, t, parse_ap_scan.tape_of(st) + (finds,))
    return parse_ap_scan.tape_of(st) + (finds,), cells_of(st)


def assert_k4_equals(k4, args, good_len, want, want_cells, **kw):
    got, cells = k4_host(k4, args, good_len, **kw)
    assert_same(got, want, "k4")
    np.testing.assert_array_equal(cells, want_cells)
    return got


def test_top_of_the_window(k4):
    """Four-symbol bytes at m5: the first stretch relaxes into offset
    AP_LIMIT - 1, the last one the stretch-end checks let any stretch
    reach, and nothing past it; the cap never ends a stretch."""
    args, good_len = inputs(edges.k4_top_cases())
    assert good_len == 48
    pos = np.arange(args[0].shape[1])
    seen = {"top": 0, "caps": 0}

    def watch(before, st, t, out):
        live = st["stamp"][0].numpy() == int(st["sid"][0])
        if live.any():
            seen["top"] = max(seen["top"], int((pos[live]
                                                - int(st["s0"][0])).max()))
        if (int(before["fsm"][0]) == constants.AP_FIND
                and int(st["fsm"][0]) == constants.AP_MARK
                and int(st["post"][0]) == constants.POST_NONE):
            seen["caps"] += 1
    want, want_cells = plain_run(args, good_len, watch)
    assert seen == {"top": constants.AP_LIMIT - 1, "caps": 0}
    got = assert_k4_equals(k4, args, good_len, want, want_cells)
    assert got[2].all() and not got[3].any()


def test_last_column_in_the_window(k4):
    """An 11-byte match from a stretch start 12 bytes before the end: at
    width n its relaxation into n - 1 is not written, one column wider it
    is, and the path takes it; both builds agree at both widths."""
    tapes = []
    for extra in (0, 1):
        args = edges.k4_lane_inputs(4, width=600 + extra, last=True)
        want, want_cells = plain_run(args, 16)
        got = assert_k4_equals(k4, args, 16, want, want_cells)
        assert got[2].all() and not got[3].any()
        tapes.append(got[0][0, :got[1][0]])
    assert not np.array_equal(tapes[0], tapes[1])
    kinds = tapes[1][:, 0] & 7
    assert ((kinds == constants.K_MATCH) & ((tapes[1][:, 0] >> 3) + 2 == 11)
            ).any()


@pytest.mark.parametrize("ncand,good_len", [(4, 16), (10, 24), (10, 48)])
def test_every_lane_records(k4, ncand, good_len):
    """At LANE_P the four rep lanes match 2-5 bytes and the candidate rows
    6, 7, ... bytes at growing distances: every lane records, and each
    length L is priced by its own lane (cell LANE_P + L: back LANE_P,
    ndist the lane's distance code), in the plain version right after
    that position and in the g++ build cut there; both agree at the
    end."""
    args = edges.k4_lane_inputs(ncand)
    p = edges.LANE_P
    codes = [1, 2, 3, 4] + [edges.LANE_CAND + 19 * c + 4
                            for c in range(ncand)]
    snap = {}

    def watch(before, st, t, out):
        if (int(before["fsm"][0]) == constants.AP_FIND
                and int(before["wpos"][0]) == p
                and int(st["wpos"][0]) == p + 1):
            snap["t"] = t
            snap["out"] = out
            snap["cells"] = cells_of(st)
    want, want_cells = plain_run(args, good_len, watch)
    ls = slice(p + 2, p + 2 + len(codes))
    np.testing.assert_array_equal(snap["cells"][0, 2, ls], p)
    np.testing.assert_array_equal(snap["cells"][0, 3, ls], codes)
    assert_k4_equals(k4, args, good_len, snap["out"], snap["cells"],
                     max_steps=snap["t"])
    got = assert_k4_equals(k4, args, good_len, want, want_cells)
    assert got[2].all() and not got[3].any()


def test_step_budget_across_long_positions(k4):
    """The budget cut at every step from just before the first of the
    LANE_AT positions (a candidate extended over 120 bytes: 29 rounds, 4
    lockstep steps) to just after it, and around the position LANE_P:
    tape, counts, err and every cell equal the plain version's at each
    cut."""
    args = edges.k4_lane_inputs(4)
    x = edges.LANE_AT[0]
    at, cuts = [], {}

    def watch(before, st, t, out):
        if (int(before["fsm"][0]) == constants.AP_FIND
                and int(before["wpos"][0]) in (x, edges.LANE_P)):
            at.append(t)
        cuts[t] = (out, cells_of(st))
    plain_run(args, 16, watch)
    # the position x holds the stream for 4 steps in the plain version
    assert at[:4] == list(range(at[0], at[0] + 4))
    for t in sorted(set(range(at[0] - 2, at[0] + 6))
                    | set(range(at[-1] - 2, at[-1] + 3))):
        out, cells = cuts[t]
        got = assert_k4_equals(k4, args, 16, out, cells, max_steps=t)
        assert not got[2].any() and got[3][0] == constants.ERR_STEPS


@pytest.mark.parametrize("level", [3, 4, 5])
def test_no_cell_copy_and_unstaged_data(k4, level):
    """The g++ build with no cell copy (the encode path's launch) gives
    the same tape, tok_cnt, done and err as with it, and with the data
    read as bytes (a stream past 64 KB in the kernel) the same outputs
    and cells, on the edge streams of ap_cases and k4_cases."""
    for cases in (edges.ap_cases(level), edges.k4_cases(level)):
        args, good_len = inputs(cases)
        got, cells = k4_host(k4, args, good_len)
        bare, none = k4_host(k4, args, good_len, cells=False)
        assert none is None
        for a, b in zip(got, bare):
            np.testing.assert_array_equal(a, b)
        raw, raw_cells = k4_host(k4, args, good_len, stage_max=0)
        for a, b in zip(got, raw):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(cells, raw_cells)
