"""The lane hazards of K5's warp design (csrc/encode_k5.cuh), built with
g++ through encode_k5_host.cpp, against the plain version
(csc_tpu_torch.ops.exact_scan) at m1 and m2 on the hand-made streams of
tests/torch_edge_cases.py `k5_lane_cases`: every field (tape, tok_cnt,
done, err, steps) with the data staged as words and read from its bytes
(at the group's width and at a width of whole words), and the step
budget cut at every step of one find of each kind; and a dictionary
under 8 KB, which takes the slide's other insert path.  A trace of the
plain version's lockstep states shows that each stream reaches what it
was made for: a lazy second find whose HT2 / HT3 slot the first find's
finish wrote (both lazy outcomes), slide passes with repeated HT2 / HT3
hashes and repeated HT6 rows (consecutive or not), a find whose rep
lanes and HT6 slots all record, the good_len exit at a rep and at an
HT slot, and extensions that stop at climit, a multiple of 4, or one
word short of it, inside the lanes' 32-byte batch and past it."""
import collections
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu_torch.constants import (E_DECIDE, E_EXT, E_INS, E_PREP,
                                     E_PROBE, PH_DONE)
from csc_tpu_torch.ops import exact_scan

import torch_edge_cases as edges
from test_torch_exact_host import CSRC, FIELDS, assert_same, exact_args

P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
SOLO_BYTES = 32          # encode_k5.cuh: SOLO words a lane compares alone
WINDOW = 80              # budgets cut inside a find: its set-up - 1 ...


def hashes(data, hash_bits):
    """h2, h3, h6 of every position of one stream of one run under 8 KB
    (its sub-block ends at its end; bytes past it read as zeros, as
    exact_scan._hashes masks them)."""
    end = len(data)
    b = np.zeros(end + 8, np.uint64)
    b[:end] = np.frombuffer(data, np.uint8)
    p = np.arange(end)
    v2 = b[p] | b[p + 1] << 8
    v4 = v2 | b[p + 2] << 16 | b[p + 3] << 24
    v2b = b[p + 4] | b[p + 5] << 8
    h2 = (v2 * 65521) & 0x3FFF
    h3 = ((b[p] << 8) ^ (b[p + 1] << 5) ^ b[p + 2]) & 0xFFFF
    h6 = (((v4 ^ (v2b << 13)) * 2654435761) & 0xFFFFFFFF) >> (32 - hash_bits)
    return h2.astype(np.int64), h3.astype(np.int64), h6.astype(np.int64)


def trace(args, kinds):
    """Step the plain version to the group's end.  Returns, for each
    stream, its finds (set-up step, position, second find?, the records
    its finish leaves), its lazy outcomes, extension ends (length,
    climit) and slides (base, length); and, for the first find that each
    of `kinds` (name -> predicate(stream, find, the find before))
    accepts, the outputs at every budget from its set-up step - 1 on,
    WINDOW of them."""
    st, cfg = exact_scan.make_exact_state(*args[:9])
    b = args[0].shape[0]
    ev = [dict(finds=[], lazy=[], exts=[], slides=[]) for _ in range(b)]
    recent = collections.deque([(0, exact_scan.tape_of(st))], WINDOW)
    open_, windows = {}, {}
    regs = ("fsm", "phase", "wpos", "probe2", "cnt", "ext_climit")
    step = 0
    while not bool((st["done"] == 1).all()):
        new = exact_scan.encode_parse_step(st, cfg)
        step += 1
        f = dict(zip(regs, torch.stack([st[k] for k in regs]).tolist()))
        g = dict(zip(("fsm", "ext_len", "have_u1", "ins_base", "ins_len"),
                     torch.stack([new[k] for k in (
                         "fsm", "ext_len", "have_u1", "ins_base",
                         "ins_len")]).tolist()))
        for i in range(b):
            e = ev[i]
            fsm = f["fsm"][i]
            if fsm == E_PREP:
                e["finds"].append([step, f["wpos"][i] + f["probe2"][i],
                                   f["probe2"][i], None])
            elif fsm == E_PROBE and f["phase"][i] == PH_DONE:
                n = f["cnt"][i]
                find = e["finds"][-1]
                find[3] = list(zip(st["cand_len"][i, :n].tolist(),
                                   st["cand_dist"][i, :n].tolist()))
                before = e["finds"][-2] if len(e["finds"]) > 1 else None
                for name, pred in kinds.items():
                    if name not in windows and pred(i, find, before):
                        start = find[0] - 1
                        windows[name] = {s: o for s, o in recent
                                         if s >= start}
                        open_[name] = start
            elif fsm == E_DECIDE:
                if f["probe2"][i]:
                    e["lazy"].append("literal" if g["have_u1"][i]
                                     else "match")
                if g["fsm"][i] == E_INS:
                    e["slides"].append((g["ins_base"][i], g["ins_len"][i]))
            elif fsm == E_EXT and g["fsm"][i] != E_EXT:
                e["exts"].append((g["ext_len"][i], f["ext_climit"][i]))
        st = new
        out = exact_scan.tape_of(st)
        recent.append((step, out))
        for name, start in list(open_.items()):
            windows[name][step] = out
            if step >= start + WINDOW - 1:
                del open_[name]
    return ev, windows, out


def build_host(tmp):
    """The g++ build of encode_k5_host.cpp: (csc_k5_host,
    csc_k5_host_staged)."""
    so = str(tmp / "libk5lanes.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", os.path.join(CSRC,
                                                     "encode_k5_host.cpp"),
                    "-o", so], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    args = [P, I64, P, I32, P, P, I32, I32, I32, I32, P, P, P, P, I64, I64,
            P, P, I32]
    lib.csc_k5_host.argtypes = args
    lib.csc_k5_host_staged.argtypes = args + [I64]
    lib.csc_k5_host.restype = lib.csc_k5_host_staged.restype = ctypes.c_int
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_host(tmp_path_factory.mktemp("k5lanes"))


def host(lib, args, stage_max=None):
    """The g++ build's (tape, tok_cnt, done, err, steps, btypes) as numpy;
    with stage_max, streams of more bytes are read from their bytes (0:
    all)."""
    data, blocks, sizes, dicts, hash_bits, hash_width, good_len, lazy, \
        tcap, max_steps = args
    data, blocks, sizes, dicts = (np.ascontiguousarray(t.numpy()) for t
                                  in (data, blocks, sizes, dicts))
    b, n = data.shape
    tables = [np.zeros((b, size), np.int32)
              for size in exact_scan.table_sizes(hash_bits, hash_width)]
    tape = np.zeros((b, tcap, 2), np.int32)
    out = np.zeros((4, b), np.int32)
    btypes = np.zeros(blocks.shape[:2], np.int32)
    ptr = [a.ctypes.data_as(ctypes.c_void_p) for a in
           (data, blocks, sizes, dicts, *tables, tape, out, btypes)]
    call = (ptr[0], n, ptr[1], blocks.shape[1], ptr[2], ptr[3],
            hash_bits, hash_width, good_len, 1 if lazy else 0, ptr[4],
            ptr[5], ptr[6], ptr[7], tcap, max_steps, ptr[8], ptr[9], b)
    if stage_max is None:
        assert lib.csc_k5_host(*call) == 0
    else:
        assert lib.csc_k5_host_staged(*call, stage_max) == 0
    return (tape,) + tuple(out) + (btypes,)


def _index(cases, name):
    return [c[0] for c in cases].index(name)


def kinds_of(cases, args):
    """The finds whose every budget step is cut: a lazy second find on
    the HT2 / HT3 slots the first one wrote, the find where every lane
    records, a find the warp extends past the lanes' batch, and finds
    that exit at good_len at a rep and at an HT slot."""
    good, w = args[6], args[5]
    runs = _index(cases, "runs")
    h2, h3, _ = hashes(cases[runs][2], args[4])

    def forwarded(i, find, before):
        return (i == runs and find[2] and before is not None
                and find[1] == before[1] + 1 and not before[2]
                and h2[find[1]] == h2[before[1]]
                and h3[find[1]] == h3[before[1]])

    def every_lane(i, find, before):
        d = [x for _, x in find[3]]
        return sorted(x for x in d if x <= 4) == [1, 1, 2, 3, 4] \
            and sum(x > 4 for x in d) >= w
    return {"forwarded": forwarded, "every_lane": every_lane,
            "extended": lambda i, f, b: any(n > SOLO_BYTES
                                            for n, _ in f[3]),
            "rep_exit": lambda i, f, b: any(n >= good and d <= 4
                                            for n, d in f[3]),
            "ht_exit": lambda i, f, b: any(n >= good and d > 4
                                           for n, d in f[3])}


@pytest.fixture(scope="module", params=[1, 2], ids=["m1", "m2"])
def group(request):
    cases = edges.k5_lane_cases(request.param)
    args = exact_args(cases)
    ev, windows, want = trace(args, kinds_of(cases, args))
    return cases, args, ev, windows, want


def test_lane_cases_reach_each_hazard(group):
    cases, args, ev, windows, want = group
    assert set(windows) == set(kinds_of(cases, args))
    # runs: lazy second finds on the slots the first find's finish
    # wrote, with both outcomes
    j = _index(cases, "runs")
    h2, h3, _ = hashes(cases[j][2], args[4])
    finds = ev[j]["finds"]
    seconds = [f for f in finds if f[2]]
    assert len(seconds) == len(ev[j]["lazy"])
    outcomes = {o for (before, f), o in zip(
        ((finds[finds.index(f) - 1], f) for f in seconds), ev[j]["lazy"])
        if f[1] == before[1] + 1 and h2[f[1]] == h2[before[1]]
        and h3[f[1]] == h3[before[1]]}
    assert outcomes == {"literal", "match"}
    # slide passes (32 insertions, no stride-4 part) with repeated HT2 /
    # HT3 hashes, and HT6 rows repeated next to each other (the lasth6
    # rule keeps the row) and apart (a later run shifts it again)
    rep2 = rep3 = rows_next = rows_apart = 0
    for name in ("runs", "period"):
        j = _index(cases, name)
        h2, h3, h6 = hashes(cases[j][2], args[4])
        for base, n in ev[j]["slides"]:
            for q0 in range(1, n if n <= 129 else 1, 32):
                pos = np.arange(base + q0, base + min(n, q0 + 32))
                rep2 += len(set(h2[pos])) < len(pos)
                rep3 += len(set(h3[pos])) < len(pos)
                r = h6[pos]
                rows_next += bool((r[1:] == r[:-1]).any())
                rows_apart += any(r[k] in r[:k - 1] and r[k] != r[k - 1]
                                  for k in range(2, len(r)))
    assert rep2 and rep3 and rows_next and rows_apart
    # extensions that stop at climit (a multiple of 4) or one word short
    # of it, inside the lanes' batch and past it
    exts = [x for e in ev for x in e["exts"]]
    for inside in (True, False):
        fit = [(n, c) for n, c in exts
               if c % 4 == 0 and (c <= SOLO_BYTES) == inside]
        assert any(n == c for n, c in fit), inside
        assert any(n == c - 4 for n, c in fit), inside


def test_k5_host_matches_plain_on_lane_cases(lib, group):
    """Every field, the data staged and read from its bytes, at the
    group's width and at a width of whole words."""
    cases, args, ev, windows, want = group
    assert want[2].all() and not want[3].any()
    assert_same(host(lib, args), want)
    assert_same(host(lib, args, 0), want)
    n = args[0].shape[1]
    whole = exact_args(cases, width=n + (-n) % 4 + 4)
    for name, g, w in zip(FIELDS, host(lib, whole, 0), want):
        g = g[:, :w.shape[1]] if name == "tape" else g
        np.testing.assert_array_equal(g, w.numpy(), err_msg=name)


def test_k5_host_step_budget_inside_each_kind_of_find(lib, group):
    """The budget cut at every step from the set-up of one find of each
    kind on (`kinds_of`): the g++ build stops where the plain version
    does."""
    cases, args, ev, windows, want = group
    for name, outs in windows.items():
        assert len(outs) == WINDOW, name
        for budget, out in outs.items():
            assert_same(host(lib, args[:9] + (budget,)), out)


@pytest.mark.parametrize("level", [1, 2], ids=["m1", "m2"])
def test_k5_host_matches_plain_with_a_small_dictionary(lib, level):
    """A 4 KB dictionary: vld_rge < 0, so an empty table entry's 0 passes
    the positions (the slide keeps a hash's highest lane by
    __match_any_sync, not atomicMax) and the reps start past position 0
    (their candidates' reads clip at the data's start), staged and read
    from the bytes."""
    cases = [c for c in edges.k5_lane_cases(level)
             if c[0] in ("runs", "period", "good_len", "end_long_full")]
    args = list(exact_args(cases))
    args[3] = torch.full_like(args[3], 4096)
    args = tuple(args)
    want = exact_scan.exact_plain(*args)
    assert want[2].all() and not want[3].any()
    assert_same(host(lib, args), want)
    assert_same(host(lib, args, 0), want)
