"""K6's binary-tree instantiation (m5: csrc/encode_k5.cuh `BT`,
encode_k6.cuh), built with g++ through encode_k6_host.cpp, against its
plain version (ops/exact_ap_scan.py) on tests/torch_edge_cases.py
`exact_bt_cases` and `bt_fault_case`: the tape, tok_cnt, done, err and
the block types, the data staged as words and read as bytes, and the
model each stream leaves; the parse cut by a short tape at the same
token; a stream alone against the same stream in a group whose streams
have other bt_sizes.  Tolerance 0."""
import shutil

import numpy as np
import pytest

from csc_tpu_torch.constants import ERR_BT, ERR_OVERFLOW
from csc_tpu_torch.ops import exact_ap_scan

import torch_edge_cases as edges
from test_torch_exact_ap_host import (assert_same, build_k6_host, k6_args,
                                      k6_host, model_row)


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build_k6_host(tmp_path_factory.mktemp("k6bt"), "-O0")


@pytest.fixture(scope="module")
def plain():
    cases = edges.exact_bt_cases() + [edges.bt_fault_case()]
    args = k6_args(cases)
    trace = []
    return cases, args, exact_ap_scan.exact_ap_plain(*args, trace=trace), \
        trace


@pytest.mark.parametrize("stage_max", [1 << 16, 0])
def test_host_equals_plain_on_every_field(k6, plain, stage_max):
    """Staged as words (stage_max 64 KB), then read as bytes."""
    cases, args, want, trace = plain
    assert [int(e) for e in want[3]] == [0] * (len(cases) - 1) + [ERR_BT]
    got = k6_host(k6, args, stage_max, model=True)
    assert_same(got, want)
    for (name, _, _), row, s, err in zip(cases, got[5], trace, want[3]):
        if not err:
            np.testing.assert_array_equal(row, model_row(s.model),
                                          err_msg=name)


def test_tape_overflow_cuts_at_the_same_token(k6, plain):
    """A tape of capacity c ends both at their (c + 1)-th token."""
    cases, _, full, _ = plain
    sub = [c for c in cases if c[0] in ("repeat", "cap", "dup_skip")]
    cnt = exact_ap_scan.exact_ap_plain(*k6_args(sub))[1].numpy()
    for cap in (1, 700, int(cnt.min()) - 1):
        args = k6_args(sub, tcap=cap)
        want = exact_ap_scan.exact_ap_plain(*args)
        assert_same(k6_host(k6, args), want)
        short = cnt > cap
        assert (want[3].numpy()[short] == ERR_OVERFLOW).all()


def test_one_stream_alone_equals_it_in_a_group(k6, plain):
    """The wrap case (bt_size 4 096) beside streams of bt_size 74 KB:
    each stream's own bt_size, its parse not the group's."""
    cases, args, want, _ = plain
    j = [c[0] for c in cases].index("wrap")
    alone = k6_host(k6, k6_args([cases[j]]))
    assert int(args[9][j]) == edges.BT_SMALL < int(args[9][0])
    assert alone[1][0] == int(want[1][j]) and alone[2][0] == 1
    np.testing.assert_array_equal(alone[0][0, :alone[1][0]],
                                  want[0][j, :want[1][j]].numpy())
