"""The exact optimal parse of m3 / m4 past the dictionary (golden's ring
window, golden/lz.py:28, 51-75, 269) on the CPU: `encode_batch(...,
device="cpu")` (K6's plain version, ops/exact_ap_scan.py, with K3 and K1
through their g++ builds, torch_ring_cases.use_host_builds) on
tests/torch_edge_cases.py `exact_ap_ring_cases` (ring ends off the 8 KB
grid, the literal priced at ring position 0, sources stopped at the
ring's end, BAD / ENTROPY / DLT runs and a duplicate-probe hit across a
wrap, raw chunks) under parse="exact" and under parse="fast" (which
routes a stream longer than its dictionary to the exact parse) must give
the golden encoder's bytes and csc_tpu's under CSC_ENCODE_PARSE=exact
(which hands every m3-m5 stream to golden; both kept as digests in
tests/fixtures/exact_ap_ring_m3.npz / _m4.npz, made live again by the
slow-marked test), decode back through the golden decoder and the port's
decode_batch, and reach each ring rule by the plain version's counters;
K6's g++ build (encode_k6_host.cpp, its ring instantiation) equals the
plain version on every field, its data staged as words and read as
bytes, here and on `exact_ap_far_cases` past the dictionary.  `c -m3
-d 1k` of a file past its 32 KB dictionary writes csc_tpu's CLI file
and `csarc a -m4 -d1k` csc_tpu's archive.
Tolerance 0."""
import numpy as np
import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli
from csc_tpu_torch.ops import exact_ap_scan, pipeline
from csc_tpu_torch.props import props_init, write_properties

import torch_edge_cases as edges
import torch_fixtures as fixture
import torch_ring_cases as ring
from test_torch_exact_ap_host import (assert_same, build_k6_host,
                                      check_far_cases, k6_host)
from torch_archiver_trees import archive_both

CPU = torch.device("cpu")


def _bytes(b):
    return np.frombuffer(b, np.uint8)


def reference(level):
    """The golden encoder's streams of exact_ap_ring_cases(level) and
    csc_tpu's under CSC_ENCODE_PARSE=exact (torch_fixtures), each case
    its own key; a case golden faults on (m5) keeps a 1 under "<who>
    raises <name>"."""
    from csc_tpu.ops import pipeline as j_pipeline
    cases = (edges.exact_bt_ring_cases() if level == 5
             else edges.exact_ap_ring_cases(level))
    values = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CSC_ENCODE_PARSE", "exact")
        for name, p, data in cases:
            for who, enc in (("golden", lambda: golden_encode(p, data)),
                             ("csc_tpu", lambda: j_pipeline.encode_batch(
                                 [p], [data])[0])):
                try:
                    values[f"{who} {name}"] = _bytes(enc())
                except IndexError:
                    values[f"{who} raises {name}"] = np.array(1, np.int8)
            assert j_pipeline.LAST_ENCODE_FALLBACKS == 1
    return cases, values, ()


def ring_run(level, tmp):
    """The cases, the port's streams under parse="exact" and "fast" (one
    plain K6 and K3 call for both), their decode, the plain version's
    calls (arguments, outputs, trace) and the stored references."""
    cases = (edges.exact_bt_ring_cases() if level == 5
             else edges.exact_ap_ring_cases(level))
    ok = [c for c in cases if c[0] != "fault"]
    props, datas = [c[1] for c in ok], [c[2] for c in ok]
    assert all(len(d) > p.dict_size for p, d in zip(props, datas))
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
        ran = ring.memo_kernels(mp, ("parse_k6", "code_k3"))
        assert [pl.parse for pl in pipeline.plan_streams(props, datas)] \
            == ["exact"] * len(ok)
        exact = pipeline.encode_batch(props, datas, device=CPU,
                                      parse="exact")
        fast = pipeline.encode_batch(props, datas, device=CPU)
        assert sorted(set(ran)) == ["code_k3", "parse_k6"]
        assert len(ran) == 2 * len(calls)
        back = pipeline.decode_batch(props, exact, device=CPU)
    # the plain version's trace of each case: the groups in encode_batch's
    # order
    groups = pipeline._groups(props, pipeline.plan_streams(props, datas,
                                                           "exact"))
    assert len(groups) == len(calls)
    trace = {ok[i][0]: tr[j] for (idxs, _), (_, _, tr) in zip(groups, calls)
             for j, i in enumerate(idxs)}
    return dict(cases=cases, ok=ok, exact=exact, fast=fast, back=back,
                calls=calls, trace=trace,
                want=fixture.load(f"exact_{'bt' if level == 5 else 'ap'}"
                                  f"_ring_m{level}", cases))


def check_bytes(run):
    for (name, p, data), e, f in zip(run["ok"], run["exact"], run["fast"]):
        assert f == e, name
        for who in ("golden", "csc_tpu"):
            key = f"{who} {name}"
            fixture.assert_values({key: run["want"][key]}, {key: _bytes(e)},
                                  name)
        assert decompress_stream(p, e, 0) == data, name
    assert run["back"] == [c[2] for c in run["ok"]]


def check_gxx(run, k6):
    """K6's g++ build on the plain version's calls, staged and unstaged:
    every field."""
    for args, want, _ in run["calls"]:
        for stage_max in (1 << 16, 0):
            assert_same(k6_host(k6, args, stage_max), want)


@pytest.fixture(scope="module", params=[3, 4], ids=["m3", "m4"])
def run(request, tmp_path_factory):
    return ring_run(request.param, tmp_path_factory.mktemp("ring"))


@pytest.fixture(scope="module")
def k6(tmp_path_factory):
    return build_k6_host(tmp_path_factory.mktemp("k6ring"), "-O0")


def test_ring_bytes_are_goldens_and_csc_tpus(run):
    check_bytes(run)


def test_ring_reaches_each_rule(run):
    """Each case reaches the rule it is there for, by the plain version's
    counters (exact_ap_scan.STATS)."""
    st = {name: s.stats for name, s in run["trace"].items()}
    assert st["text"]["ring_wraps"] == 2 and st["text"]["ring_lit0"]
    assert st["lit0"]["ring_wraps"] == 1 and st["lit0"]["ring_lit0"]
    assert st["cut"]["ring_cut"] > 1000
    runs = st["runs"]
    assert runs["ring_wraps"] == 2 and runs["dup_hits"] == 1
    assert runs["entropy_bytes"] == 8192 and runs["rle_runs"]
    assert runs["sparse"] >= 3
    assert st["chunks"]["chunks"] == 2 and st["chunks"]["ring_wraps"] == 2


def test_ring_gxx_equals_plain_on_every_field(run, k6):
    check_gxx(run, k6)


@pytest.mark.parametrize("good_len", [None, 32], ids=["preset", "good32"])
@pytest.mark.parametrize("level", [3, 4])
def test_gxx_equals_plain_on_far_back_cells(k6, level, good_len):
    """The ring kernel's parse on `exact_ap_far_cases` past a 32 KB
    dictionary: cells entered from good_len - 1 behind by a match and by
    a rep (31 behind at good_len 32), after the dictionary's ring has
    wrapped; a stretch at AP_LIMIT; staged and unstaged, every field."""
    check_far_cases(k6, level, True, good_len)


@pytest.mark.slow
@pytest.mark.parametrize("level", [3, 4])
def test_stored_references_are_live(level):
    fixture.check_live(f"exact_ap_ring_m{level}")


def test_cli_c_m3_past_d_writes_csc_tpus_file(tmp_path, monkeypatch):
    """`c -m3 -d 1k` of a 40 KB file (a 32 KB dictionary: the ring
    wraps) under the default parse, against csc_tpu's CLI under
    CSC_ENCODE_PARSE=exact (golden's bytes), and `d` back."""
    from csc_tpu import cli as j_cli
    ring.gxx_k1_k3(monkeypatch, tmp_path)
    name, p, data = ring.dict_lt_input(3)
    src = str(tmp_path / "in.bin")
    with open(src, "wb") as f:
        f.write(data)
    ours, ref = str(tmp_path / "ours.csc"), str(tmp_path / "ref.csc")
    assert cli.main(["c", "-m", "3", "-d", "1k", "--backend", "cpu", src,
                     ours]) == 0
    monkeypatch.setenv("CSC_ENCODE_PARSE", "exact")
    assert j_cli.main(["c", "-m", "3", "-d", "1k", "--backend", "tpu", src,
                       ref]) == 0
    with open(ours, "rb") as f:
        got = f.read()
    with open(ref, "rb") as f:
        assert got == f.read()
    q = props_init(1024, 3)
    assert q.dict_size < len(data)
    assert got == write_properties(q) + golden_encode(q, data)
    back = str(tmp_path / "back.bin")
    assert cli.main(["d", "--backend", "cpu", ours, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data


def test_csarc_a_m4_past_d_writes_csc_tpus_archive(tmp_path, monkeypatch):
    """One solid 40 KB task at m4 under -d1k (a 32 KB dictionary): the
    port's `a` routes it to the exact parse's ring, csc_tpu's `a` under
    CSC_ENCODE_PARSE=exact hands it to golden; the archives are equal."""
    _, _, data = ring.dict_lt_input(4)
    _, got, want = archive_both(tmp_path, monkeypatch, {"big.txt": data},
                                ["-m4", "-d1k"],
                                {"CSC_ENCODE_PARSE": "exact"}, fallbacks=1)
    assert got == want
