"""K5's per-stream code (csc_tpu_torch/csrc/encode_k5.cuh), built with g++
through the test-only harness encode_k5_host.cpp, against the plain
PyTorch version (csc_tpu_torch.ops.exact_scan, the lockstep port of
csc_tpu's encode_scan) at m1, m2 and lz_mode 1: the tape, tok_cnt, done,
err and steps (the lockstep micro-ops K5 counts as it goes) on the edge
streams of tests/torch_edge_cases.py `exact_cases` (masked lookahead at
the sub-block end, HT2's quirk, the distance gates and the good_len
exits, candidate recording, the finish step's insertion, SlidePos's
stride-4 path and its lasth6 rule, both lazy outcomes, run ends, the rep
queue); a tape too short (ERR_OVERFLOW); the step budget cut at every
step of a short group (ERR_STEPS at the same token); and one stream
alone at its width against the same stream in a wider group.  This is
the CPU check of the CUDA kernel's logic.  m2 is in
test_torch_exact_host_m2.py."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from csc_tpu_torch import constants
from csc_tpu_torch.ops import encode_host, exact_scan, parse_scan, pipeline

import torch_edge_cases as edges

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
P, I32, I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
FIELDS = ("tape", "tok_cnt", "done", "err", "steps", "btypes")
CPU = torch.device("cpu")


def build_k5_host(tmp):
    """The g++ build of encode_k5_host.cpp (csc_k5_host) in `tmp`."""
    so = str(tmp / "libk5host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-Werror",
                    "-shared", "-fPIC", os.path.join(CSRC,
                                                     "encode_k5_host.cpp"),
                    "-o", so], check=True, capture_output=True)
    fn = ctypes.CDLL(so).csc_k5_host
    fn.restype = ctypes.c_int
    fn.argtypes = [P, I64, P, I32, P, P, I32, I32, I32, I32, P, P, P, P,
                   I64, I64, P, P, I32]
    return fn


@pytest.fixture(scope="module")
def k5(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_k5_host(tmp_path_factory.mktemp("k5host"))


def exact_args(cases, width=None, tcap=None, max_steps=None):
    """K5's arguments for a group of (name, props, data) cases of one
    preset, on the CPU, as the encode path gives them."""
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2], exact=True) for c in cases]
    data, blocks, sizes, dicts = pipeline.block_inputs(
        props, plans, list(range(len(cases))), CPU, width)
    p0 = props[0]
    n = data.shape[1]
    return (data, blocks, sizes, dicts, p0.hash_bits, p0.hash_width,
            p0.good_len, p0.lz_mode == 2,
            tcap or parse_scan.tape_capacity(n, blocks.shape[1]),
            exact_scan.max_steps_for(n) if max_steps is None else max_steps)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def k5_host(fn, args):
    """The g++ build's (tape, tok_cnt, done, err, steps, btypes) as
    numpy."""
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
    assert fn(_ptr(data), n, _ptr(blocks), blocks.shape[1],
              _ptr(sizes), _ptr(dicts), hash_bits, hash_width, good_len,
              1 if lazy else 0, *(_ptr(t) for t in tables), _ptr(tape),
              tcap, max_steps, _ptr(out), _ptr(btypes), b) == 0
    return (tape,) + tuple(out) + (btypes,)


def assert_same(got, want):
    for name, g, w in zip(FIELDS, got, want, strict=True):
        np.testing.assert_array_equal(np.asarray(g), w.numpy(),
                                      err_msg=name)


GROUPS = {"m1": (1, None), "m2": (2, None), "lz_mode1": (1, 1)}


def exact_group(name):
    """(name, cases, K5's arguments, the plain version's outputs) of one
    group of `exact_cases`."""
    level, lz_mode = GROUPS[name]
    cases = edges.exact_cases(level, lz_mode)
    args = exact_args(cases)
    return name, cases, args, exact_scan.exact_plain(*args)


def check_matches(k5, group):
    name, cases, args, want = group
    assert_same(k5_host(k5, args), want)
    assert want[2].all() and not want[3].any(), name


def check_reach(group):
    """What the cases were chosen to reach, as the tape shows it."""
    name, cases, args, want = group
    tape, tok_cnt = want[0].numpy(), want[1].numpy()
    names = [c[0] for c in cases]
    good_len = args[6]
    kinds, lens = tape[..., 0] & 7, (tape[..., 0] >> 3) + 2
    live = np.arange(tape.shape[1])[None, :] < tok_cnt[:, None]
    wire = ((kinds == constants.K_MATCH) | (kinds == constants.K_REP)) & live
    assert ((kinds == constants.K_REP) & live).any()
    j = names.index("good_len")
    assert (wire[j] & (lens[j] >= good_len)
            & (kinds[j] == constants.K_REP)).any()
    assert (wire[j] & (lens[j] >= good_len)
            & (kinds[j] == constants.K_MATCH)).any()
    # the run of one byte: a literal, HT2's quirk makes the second one a
    # literal too, then one match slides the rest
    j = names.index("byte_run")
    assert list(kinds[j, :4]) == [constants.K_LIT, constants.K_LIT,
                                  constants.K_MATCH, constants.K_SENT_A]
    assert lens[j, 2] == len(cases[j][2]) - 2
    j = names.index("multichunk")
    runs = len(encode_host.plan_stream(cases[j][1], cases[j][2])[1])
    assert runs >= 3
    assert ((kinds[j] == constants.K_SENT_A) & live[j]).sum() == runs
    assert tok_cnt[names.index("one_byte")] == 3
    assert len(cases[names.index("subblock")][2]) > 8192


def check_overflow(k5, level):
    """A tape of 32 tokens: the tokens past it clip onto its last entry,
    the markers past it are dropped, err is ERR_OVERFLOW."""
    args = exact_args(edges.exact_small_cases(level), tcap=32)
    want = exact_scan.exact_plain(*args)
    assert_same(k5_host(k5, args), want)
    assert want[2].all()
    over = want[1] > 32
    assert over.any()
    assert ((want[3] == constants.ERR_OVERFLOW) == over).all()


def check_budget(k5, level):
    """The budget cut at every step of a short group: K5 stops at the
    token where the lockstep version stops (ERR_STEPS, steps = the
    budget) and, past the group's end, finishes as it does."""
    args = exact_args(edges.exact_small_cases(level))
    st, cfg = exact_scan.make_exact_state(*args[:9])
    total = 0
    while not bool((st["done"] == 1).all()):
        st = exact_scan.encode_parse_step(st, cfg)
        total += 1
        got = k5_host(k5, args[:9] + (total,))
        assert_same(got, exact_scan.tape_of(st))
    assert total > 1000
    assert (got[3] == 0).all() and int(got[4].max()) == total
    cut = k5_host(k5, args[:9] + (total // 2,))
    assert (cut[3] == constants.ERR_STEPS).any()


def check_width(k5, group):
    """A stream alone at its own width and inside the wider group of its
    cases (its gathers clip at N - 1 of a wider row; its reads past its
    end are masked or limited) gives the same tape, in both builds."""
    name, cases, wide, got = group
    text = [c for c in cases if c[0] == "text"]
    j = cases.index(text[0])
    alone = exact_args(text, width=len(text[0][2]))
    assert wide[0].shape[1] > alone[0].shape[1]
    want = exact_scan.exact_plain(*alone)
    assert_same(k5_host(k5, alone), want)
    for field, a, g in zip(FIELDS, want, got):
        a, g = a.numpy(), g.numpy()[j:j + 1]
        if field in ("tape", "btypes"):
            # the group's longer tape and its padded block table
            assert not g[:, a.shape[1]:].any()
            g = g[:, :a.shape[1]]
        np.testing.assert_array_equal(g, a, err_msg=f"{name} {field}")


# m1 and lz_mode 1 here; m2 in test_torch_exact_host_m2.py, so that test
# workers spread them
@pytest.fixture(scope="module", params=["m1", "lz_mode1"])
def group(request):
    return exact_group(request.param)


def test_k5_host_matches_plain_on_exact_cases(k5, group):
    check_matches(k5, group)


def test_exact_cases_reach_each_mechanism(group):
    check_reach(group)


def test_k5_output_does_not_depend_on_the_width(k5, group):
    check_width(k5, group)


def test_k5_host_tape_overflow_matches_plain(k5):
    check_overflow(k5, 1)


def test_k5_host_step_budget_at_every_step(k5):
    check_budget(k5, 1)
