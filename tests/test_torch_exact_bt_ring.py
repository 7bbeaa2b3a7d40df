"""The exact optimal parse of m5 past the dictionary on the CPU: golden's
ring window with its binary tree (K6's tree in its ring kernel: csrc/
encode_k5.cuh `BT` with `RING`, encode_k6.cuh; the plain version ops/
exact_ap_scan.py).  At a dictionary of 16 MB or less bt_size is the
dictionary, so such a stream is past bt_size too, where golden's tree
raises IndexError whenever a slide leaves bt_pos at bt_size before a find
(a lap that ends in a match).  On tests/torch_edge_cases.py
`exact_bt_ring_cases`: where golden completes (`cut`, whose first lap
ends in a literal and whose tree walks stop at the ring's end; `ring48`,
a DT_BAD run across the ring's end) the port's bytes under parse="exact"
and "fast" are golden's and csc_tpu's under CSC_ENCODE_PARSE=exact
(digests in tests/fixtures/exact_bt_ring_m5.npz, made live again by the
slow-marked test) and decode back; where golden raises (`fault`), the
plain version and K6's g++ build stop at the same token with ERR_BT and
encode_batch raises EncodeError naming the stream.  The g++ build equals
the plain version on every field, staged and unstaged.  Tolerance 0."""
import pytest
import torch

from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch.constants import ERR_BT
from csc_tpu_torch.ops import exact_ap_scan, pipeline

import torch_edge_cases as edges
import torch_fixtures as fixture
from test_torch_exact_ap_host import (assert_same, build_k6_host, k6_args,
                                      k6_host)
from test_torch_exact_ap_ring import check_bytes, check_gxx, ring_run

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ring_run(5, tmp_path_factory.mktemp("bt_ring"))


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    return build_k6_host(tmp_path_factory.mktemp("k6btring"), "-O0")


def test_ring_bytes_are_goldens_and_csc_tpus(run):
    check_bytes(run)
    assert [c[0] for c in run["ok"]] == ["cut", "ring48"]


def test_ring_reaches_each_rule(run):
    st = {name: s.stats for name, s in run["trace"].items()}
    cut = st["cut"]
    assert cut["ring_wraps"] == 1 and cut["bt_wraps"] == 1
    assert cut["ring_cut"] > 1000 and cut["bt_steps"] > cut["bt_finds"]
    r48 = st["ring48"]
    assert r48["ring_wraps"] == 1 and r48["bt_sparse"] > 100


def test_ring_gxx_equals_plain_on_every_field(run, k6):
    check_gxx(run, k6)


def test_goldens_index_error_past_the_ring_is_refused_by_name(run, k6):
    """golden (and csc_tpu, which hands the stream to it) raise
    IndexError on `fault`; the plain version and the g++ build stop at
    the same token with ERR_BT, and encode_batch, under either parse,
    raises EncodeError naming the stream beside one it encodes."""
    name, p, data = run["cases"][-1]
    assert name == "fault"
    for who in ("golden", "csc_tpu"):
        assert int(run["want"][f"{who} raises fault"]) == 1
    args = k6_args([run["cases"][-1]])
    want = exact_ap_scan.exact_ap_plain(*args)
    assert int(want[2][0]) == 0 and int(want[3][0]) == ERR_BT
    for stage_max in (1 << 16, 0):
        assert_same(k6_host(k6, args, stage_max), want)
    ok = edges.exact_bt_cases()[2]
    for parse in pipeline.PARSES:
        with pytest.raises(pipeline.EncodeError,
                           match=r"stream\(s\) \[1\]: longer than bt_size.*"
                                 "IndexError") as e:
            pipeline.encode_batch([ok[1], p], [ok[2], data], device=CPU,
                                  parse=parse)
        assert e.value.streams == [1]


@pytest.mark.slow
def test_stored_references_are_live():
    fixture.check_live("exact_bt_ring_m5")
    name, p, data = edges.exact_bt_ring_cases()[-1]
    with pytest.raises(IndexError):
        golden_encode(p, data)
