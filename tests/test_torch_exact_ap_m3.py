"""The exact optimal parse at m3 on the CPU: `encode_batch(...,
parse="exact", device="cpu")` (K6's plain version,
ops/exact_ap_scan.py) on tests/torch_edge_cases.py `exact_ap_cases`
(text, DT_ENGTXT, DT_EXE, a stretch at AP_LIMIT, length-cache rebuilds
inside a find, a DT_ENTROPY run before text, DT_BAD, DT_ENTROPY and
DT_DLT runs, a duplicate-block probe hit, raw chunks) must give the
bytes of the golden encoder (csc_tpu.golden.encoder) and of csc_tpu's
encode_batch under
CSC_ENCODE_PARSE=exact (which hands every m3 stream to golden), and
decode back through the golden decoder and the port's decode_batch; the
plain version's counters show each case reaches its mechanism; its
shadow model ends each stream as golden's Model does.  K3 and K1 run
through their g++ builds (their plain versions take minutes on these
tapes; tests/test_torch_k3_edges.py and test_torch_kernel_host.py hold
the builds to them).  Tolerance 0.  m4 is in test_torch_exact_ap_m4.py,
so that test workers spread the levels."""
import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import CSCEncoder
from csc_tpu_torch.constants import (DT_BAD, DT_DLT, DT_ENGTXT, DT_ENTROPY,
                                     DT_EXE)
from csc_tpu_torch.ops import encode_host, exact_ap_scan, pipeline

import torch_edge_cases as edges
import torch_ring_cases as ring

CPU = torch.device("cpu")
MODEL_FIELDS = ("p_state", "p_lit", "p_repdist", "p_matchlen_slot",
                "p_matchlen_extra1", "p_matchlen_extra2",
                "p_matchlen_extra3", "state", "ctx", "lp_rebuild_int",
                "len_price")


def golden_run(props, data):
    """golden's encode_stream, and the Model it leaves."""
    enc = CSCEncoder(props)
    pos = 0
    while pos < len(data):
        size = min(props.raw_blocksize, len(data) - pos)
        enc.compress(data, pos, size)
        pos += size
    enc.write_eof()
    enc.flush()
    return enc.io.getvalue(), enc.model


def ap_run(level, tmp, cases=None):
    """The cases (exact_ap_cases(level) by default), the port's streams,
    the plain version's trace (by case) and K6's block types, golden's
    streams and models, csc_tpu's streams and the port's decode."""
    from csc_tpu.ops import pipeline as j_pipeline
    cases = cases or edges.exact_ap_cases(level)
    props, datas = [c[1] for c in cases], [c[2] for c in cases]
    k1, k3 = ring.host_builds(tmp, ("k1", "k3"))
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        ring.use_host_builds(mp, (k1, k3, None), ("k1", "k3"))

        def k6(*args, ring=None):
            trace = []
            out = exact_ap_scan.exact_ap_plain(*args, trace=trace)
            calls.append((args, out, trace))
            return out
        mp.setattr(pipeline, "parse_k6", k6)
        ours = pipeline.encode_batch(props, datas, device=CPU,
                                     parse="exact")
        back = pipeline.decode_batch(props, ours, device=CPU)
        mp.setenv("CSC_ENCODE_PARSE", "exact")
        ref = []
        for p, data in zip(props, datas):
            ref += j_pipeline.encode_batch([p], [data])
            assert j_pipeline.LAST_ENCODE_FALLBACKS == 1
    gold = [golden_run(p, d) for p, d in zip(props, datas)]
    # K6's rows of each case: the groups in encode_batch's order
    groups = pipeline._groups(props, pipeline.plan_streams(props, datas,
                                                           "exact"))
    assert len(groups) == len(calls)
    trace, btypes = {}, {}
    for (idxs, _), (_, out, tr) in zip(groups, calls):
        for j, i in enumerate(idxs):
            trace[cases[i][0]] = tr[j]
            btypes[cases[i][0]] = out[4][j].tolist()
    return dict(cases=cases, ours=ours, back=back, ref=ref, gold=gold,
                trace=trace, btypes=btypes)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ap_run(3, tmp_path_factory.mktemp("ap_m3"))


def check_bytes(run):
    for (name, p, data), o, r, (g, _) in zip(run["cases"], run["ours"],
                                             run["ref"], run["gold"]):
        assert o == g, name
        assert o == r, name
        assert decompress_stream(p, o, 0) == data, name
    assert run["back"] == [c[2] for c in run["cases"]]


def check_mechanisms(run):
    """Each case reaches the mechanism it is there for, by the plain
    version's counters (exact_ap_scan.STATS, the model's lp_calls /
    lp_rebuilds) and the block types."""
    st = {name: dict(tr.stats, lp_calls=tr.model.lp_calls,
                     lp_rebuilds=tr.model.lp_rebuilds)
          for name, tr in run["trace"].items()}
    bt = run["btypes"]
    text = st["text"]
    assert text["lit_tail"] and text["good_exit"] and text["imm_lit"]
    assert text["gated"] and text["at_end"]
    assert text["lp_calls"] > 2 * 4097 and text["lp_rebuilds"] >= 3
    assert sum(s["rep0len1"] for s in st.values()) >= 3
    assert st["limit"]["at_limit"] >= 1
    assert st["split"]["split_rebuilds"] >= 1
    assert DT_ENGTXT in bt["engtxt"] and DT_EXE in bt["exe"]
    assert bt["bad"][0] == DT_BAD and bt["entropy"][0] == DT_ENTROPY
    assert st["entropy"]["entropy_bytes"] == len(dict(
        (c[0], c[2]) for c in run["cases"])["entropy"])
    lz = st["entropy_lz"]
    assert lz["entropy_bytes"] == 8192 and lz["stretches"]
    assert bt["dlt"][0] >= DT_DLT and st["dlt"]["rle_runs"] >= 2
    assert st["dlt"]["stretches"] and st["dlt"]["lp_calls"]
    assert st["dup_skip"]["dup_hits"] == 1 and st["dup_skip"]["probes"] >= 2
    assert st["chunks"]["chunks"] == 2 and st["dup_skip"]["chunks"] == 2
    assert st["bad"]["sparse"] and st["chunks"]["sparse"] == 2
    plans = {c[0]: encode_host.plan_stream(c[1], c[2], exact=True)
             for c in run["cases"]}
    runs = encode_host.exact_run_table(plans["engtxt"], bt["engtxt"])
    assert [r[0] for r in runs] == [DT_ENGTXT]


def check_models(run):
    for (name, _, _), (_, g) in zip(run["cases"], run["gold"]):
        m = run["trace"][name].model
        for field in MODEL_FIELDS:
            assert getattr(m, field) == getattr(g, field), (name, field)


def test_bytes_are_goldens_and_csc_tpus(run):
    check_bytes(run)


def test_reaches_each_mechanism(run):
    check_mechanisms(run)


def test_shadow_model_ends_as_goldens_model(run):
    check_models(run)
