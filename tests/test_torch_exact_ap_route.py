"""Where the exact optimal parse (K6, its plain version here) is taken:
under parse="fast" an m3 stream over encode_host.MAX_ENCODE takes it, as
csc_tpu hands such a stream to its golden encoder, so its bytes are
golden's and equal parse="exact"'s, while a stream under the cap in the
same batch keeps the fast parse (K4); golden's binary-tree IndexError
stream over the cap still raises EncodeError naming the stream and the
reason, and m3-m5 past the dictionary take the exact parse (its ring
window, test_torch_exact_ap_ring.py) under either parse; `c -m3 --parse
exact` writes csc_tpu's file and
`csarc a -m4 --parse=exact --backend=cpu` csc_tpu's archive.  The cap is
lowered to 2 KB with monkeypatch and the inputs are short and
repetitive, so that the plain versions run in seconds; the real sizes
run on the card (chip_smoke.py's encode_exact_ap, k6_host, cli_big_m3
and the exact m3 archive)."""
import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli, corpus
from csc_tpu_torch.ops import encode_host, pipeline
from csc_tpu_torch.props import props_init, write_properties

import torch_edge_cases as edges
from torch_archiver_trees import TEXT_FILES, archive_both

CPU = torch.device("cpu")
CAP = 2048


@pytest.fixture
def small_cap(monkeypatch):
    monkeypatch.setattr(encode_host, "MAX_ENCODE", CAP)
    return corpus.repetitive(700, 5), corpus.repetitive(CAP + 900, 6)


def test_fast_parse_past_the_cap_takes_k6(small_cap):
    small, big = small_cap
    props = [props_init(len(d), 3) for d in (small, big)]
    kernels = []

    def on_stage(name, **values):
        if name in ("k4", "k6"):
            kernels.append(name)
    outs = pipeline.encode_batch(props, [small, big], device=CPU,
                                 on_stage=on_stage)
    assert sorted(kernels) == ["k4", "k6"]
    assert outs[1] == golden_encode(props[1], big)
    assert outs[1] == pipeline.encode_batch([props[1]], [big], device=CPU,
                                            parse="exact")[0]
    assert outs[0] == pipeline.encode_batch([props[0]], [small],
                                            device=CPU)[0]
    assert decompress_stream(props[1], outs[1], 0) == big
    assert pipeline.decode_batch(props, outs, device=CPU) == [small, big]


def test_m5_and_the_ring_are_refused(small_cap):
    """m5 past the cap or under the exact parse takes K6's tree
    (test_torch_exact_bt_route.py); still refused: golden's IndexError
    stream past the cap.  m3-m5 past the dictionary are no longer
    refused: they take the exact parse (its ring window) whatever the
    parse asked for (the name is kept from when they were refused)."""
    small, _ = small_cap
    _, m5, fault = edges.bt_fault_case()
    with pytest.raises(pipeline.EncodeError,
                       match=r"stream\(s\) \[1\]: longer than bt_size.*"
                             "IndexError") as e:
        pipeline.encode_batch([props_init(len(small), 3), m5],
                              [small, fault], device=CPU)
    assert e.value.streams == [1]
    longer = corpus.repetitive(40 * 1024, 2)
    for level in (3, 4, 5):
        p = props_init(1024, level)
        assert p.dict_size == 32768 < len(longer)
        for parse in pipeline.PARSES:
            plan = pipeline.plan_streams([p], [longer], parse)[0]
            assert plan.parse == "exact", (level, parse)


def test_cli_c_m3_parse_exact_writes_csc_tpus_file(tmp_path, monkeypatch):
    from csc_tpu import cli as j_cli
    data = corpus.repetitive(3000, 8)
    src = str(tmp_path / "in.bin")
    with open(src, "wb") as f:
        f.write(data)
    ours, ref = str(tmp_path / "ours.csc"), str(tmp_path / "ref.csc")
    assert cli.main(["c", "-m", "3", "--parse", "exact", "--backend",
                     "cpu", src, ours]) == 0
    monkeypatch.setenv("CSC_ENCODE_PARSE", "exact")
    assert j_cli.main(["c", "-m", "3", "--backend", "tpu", src, ref]) == 0
    with open(ours, "rb") as f:
        got = f.read()
    with open(ref, "rb") as f:
        assert got == f.read()
    p = props_init(len(data), 3)
    assert got == write_properties(p) + golden_encode(p, data)
    back = str(tmp_path / "back.bin")
    assert cli.main(["d", "--backend", "cpu", ours, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data


def test_csarc_a_m4_parse_exact_writes_csc_tpus_archive(tmp_path,
                                                       monkeypatch):
    """One solid task of text at m4: csc_tpu hands it to its golden
    encoder, the port codes it with K6's plain version, the archives are
    equal."""
    _, got, want = archive_both(tmp_path, monkeypatch, TEXT_FILES,
                                ["-m4", "--parse=exact"],
                                {"CSC_ENCODE_PARSE": "exact"}, fallbacks=1)
    assert got == want
