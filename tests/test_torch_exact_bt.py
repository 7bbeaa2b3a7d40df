"""The exact optimal parse at m5, with golden's binary-tree finder, on the
CPU: `encode_batch(..., parse="exact", device="cpu")` (K6's plain
version, ops/exact_ap_scan.py) on tests/torch_edge_cases.py
`exact_bt_cases` (tree walks, the good_len exit, lengths priced past the
length cache, more records than find_match keeps, the head candidate
beyond the tree's range, a stream past bt_size that golden completes,
BAD / ENTROPY / DLT runs and a probe hit at the tree's head) must give
the bytes of the golden encoder and of csc_tpu's encode_batch under
CSC_ENCODE_PARSE=exact (which hands every m5 stream to golden), and
decode back through the golden decoder and the port's decode_batch; the
plain version's counters show each case reaches its mechanism; its
shadow model ends each stream as golden's Model does.  Where golden's
tree raises IndexError (`bt_fault_case`), the port raises EncodeError
naming the stream.  K3 and K1 run through their g++ builds, as in
test_torch_exact_ap_m3.py.  Tolerance 0."""
import pytest
import torch

from csc_tpu_torch.constants import DT_BAD, DT_ENTROPY, ERR_BT
from csc_tpu_torch.ops import exact_ap_scan, pipeline

import torch_edge_cases as edges
from test_torch_exact_ap_host import k6_args
from test_torch_exact_ap_m3 import (ap_run, check_bytes, check_models,
                                    golden_run)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ap_run(5, tmp_path_factory.mktemp("bt"), edges.exact_bt_cases())


def test_bytes_are_goldens_and_csc_tpus(run):
    check_bytes(run)


def test_reaches_each_mechanism(run):
    """Each case reaches the tree's mechanism it is there for, by the
    plain version's counters (exact_ap_scan.STATS) and block types."""
    st = {name: tr.stats for name, tr in run["trace"].items()}
    text = st["text"]
    assert text["bt_steps"] > text["bt_finds"] > 7000
    assert text["bt_records"] and text["gated"] and text["long_lengths"]
    rep = st["repeat"]
    assert rep["bt_good_exits"] and rep["good_exit"]
    assert rep["bt_inserts"] > 128      # a slide past its stride-4 part
    assert st["cap"]["cand_cap"] >= 1
    wrap = st["wrap"]
    assert wrap["bt_head_hits"] == 1 and wrap["bt_wraps"] >= 2
    wb = st["wrap_bad"]
    assert wb["bt_sparse"] and wb["bt_wraps"] and wb["bt_head_hits"]
    for name in ("bad", "entropy", "dlt", "dup_skip", "chunks"):
        assert st[name]["bt_sparse"], name
    dup = st["dup_skip"]
    assert dup["dup_hits"] == dup["bt_probe_hits"] == 1
    bt = run["btypes"]
    assert bt["bad"][0] == DT_BAD and bt["entropy"][0] == DT_ENTROPY
    assert all(sum(s.values()) for s in st.values())


def test_shadow_model_ends_as_goldens_model(run):
    check_models(run)


def test_goldens_index_error_is_refused_by_name():
    """golden's tree indexes past its links on this stream (IndexError);
    the plain version stops there with ERR_BT, and encode_batch raises
    EncodeError naming the stream and the cause, beside a stream it
    encodes."""
    name, p, data = edges.bt_fault_case()
    with pytest.raises(IndexError):
        golden_run(p, data)
    out = exact_ap_scan.exact_ap_plain(*k6_args([(name, p, data)]))
    assert int(out[2][0]) == 0 and int(out[3][0]) == ERR_BT
    ok = edges.exact_bt_cases()[2]
    with pytest.raises(pipeline.EncodeError,
                       match=r"stream\(s\) \[1\]: longer than bt_size.*"
                             "IndexError") as e:
        pipeline.encode_batch([ok[1], p], [ok[2], data], device=CPU,
                              parse="exact")
    assert e.value.streams == [1]
