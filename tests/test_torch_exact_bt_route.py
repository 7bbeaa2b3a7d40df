"""Where m5's exact optimal parse (K6 with the binary tree, its plain
version here) is taken: under parse="fast" an m5 stream over
encode_host.MAX_ENCODE takes it, as csc_tpu hands such a stream to its
golden encoder, so its bytes are golden's and equal parse="exact"'s,
while an m5 stream under the cap in the same batch keeps the fast parse
(K4; test_torch_encode_m5.py holds it to csc_tpu's fast path); `c -m5
--parse exact` writes csc_tpu's file and `csarc a -m5 --parse=exact
--backend=cpu` csc_tpu's archive. The cap is lowered to 2 KB with
monkeypatch and the inputs are short and repetitive, so that the plain
versions run in seconds; the real sizes run on the card (chip_smoke.py's
encode_exact_ap m5 cells, cli_big_m5 and the exact m5 archive)."""
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli, corpus
from csc_tpu_torch.ops import encode_host, pipeline
from csc_tpu_torch.props import props_init, write_properties

from torch_archiver_trees import TEXT_FILES, archive_both

CPU = torch.device("cpu")
CAP = 2048


def test_fast_parse_past_the_cap_takes_k6s_tree(monkeypatch):
    small, big = corpus.repetitive(700, 5), corpus.repetitive(CAP + 900, 6)
    props = [props_init(len(d), 5) for d in (small, big)]
    fast_small = pipeline.encode_batch([props[0]], [small], device=CPU)[0]
    monkeypatch.setattr(encode_host, "MAX_ENCODE", CAP)
    kernels = []

    def on_stage(name, **values):
        if name in ("k4", "k6"):
            kernels.append(name)
            if name == "k6":
                assert values["k6_args"][8].size == props[1].bt_size
    outs = pipeline.encode_batch(props, [small, big], device=CPU,
                                 on_stage=on_stage)
    assert sorted(kernels) == ["k4", "k6"]
    assert outs[1] == golden_encode(props[1], big)
    assert outs[1] == pipeline.encode_batch([props[1]], [big], device=CPU,
                                            parse="exact")[0]
    assert outs[0] == fast_small
    assert decompress_stream(props[1], outs[1], 0) == big
    assert pipeline.decode_batch(props, outs, device=CPU) == [small, big]


def test_cli_c_m5_parse_exact_writes_csc_tpus_file(tmp_path, monkeypatch):
    from csc_tpu import cli as j_cli
    data = corpus.repetitive(3000, 8)
    src = str(tmp_path / "in.bin")
    with open(src, "wb") as f:
        f.write(data)
    ours, ref = str(tmp_path / "ours.csc"), str(tmp_path / "ref.csc")
    assert cli.main(["c", "-m", "5", "--parse", "exact", "--backend",
                     "cpu", src, ours]) == 0
    monkeypatch.setenv("CSC_ENCODE_PARSE", "exact")
    assert j_cli.main(["c", "-m", "5", "--backend", "tpu", src, ref]) == 0
    with open(ours, "rb") as f:
        got = f.read()
    with open(ref, "rb") as f:
        assert got == f.read()
    p = props_init(len(data), 5)
    assert got == write_properties(p) + golden_encode(p, data)
    back = str(tmp_path / "back.bin")
    assert cli.main(["d", "--backend", "cpu", ours, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data


def test_csarc_a_m5_parse_exact_writes_csc_tpus_archive(tmp_path,
                                                       monkeypatch):
    """One solid task of text at m5: csc_tpu hands it to its golden
    encoder, the port codes it with K6's plain version and the tree, the
    archives are equal."""
    _, got, want = archive_both(tmp_path, monkeypatch, TEXT_FILES,
                                ["-m5", "--parse=exact"],
                                {"CSC_ENCODE_PARSE": "exact"}, fallbacks=1)
    assert got == want
