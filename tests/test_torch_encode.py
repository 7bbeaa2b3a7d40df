"""The port's encode_batch (csc_tpu_torch.ops.pipeline) at m1 on the CPU,
where K2's and K3's wrappers run their plain versions, against
csc_tpu.ops.pipeline.encode_batch on its fast path (CSC_ENCODE_PARSE=fast
CSC_ENCODE_BITS=scan, as the JAX package's own CPU tests run it): the
streams must be byte-identical on the text, EXE, BAD, ENTROPY, DLT and
multichunk cases, decode with the port's decode_batch and with
csc_tpu.golden, and the m1 text stream equals the golden encoder's.

A dictionary smaller than the input is outside the fast parse's
envelope (one window, no wrap: csc_tpu parse_pre.py:6).  There csc_tpu
emits a stream that the golden decoder, which keeps the reference's
ring window, rejects; the port's group encode, run on it directly with
the fast parse, is still byte-identical to csc_tpu's, and encode_batch
routes such a stream at m1 / m2 to the exact parse, whose ring window
gives golden's bytes (test_torch_exact_ring_m1.py / _m2.py), and refuses
it at m3-m5.  Also: what encode_batch refuses, and the CLI round trip."""
import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli, corpus
from csc_tpu_torch.ops import (bits_kernel, encode_host, parse_ap_kernel,
                               parse_kernel, parse_pre)
from csc_tpu_torch.ops import pipeline
from csc_tpu_torch.props import props_init

CPU = torch.device("cpu")


def encode_cases(level, n=2048):
    """The case set of the byte-identity tests at one level (text and EXE
    streams of n bytes)."""
    return corpus.encode_cases(level, n=n, seed=71)


def encode_both(level, monkeypatch, n=2048):
    """(cases, the port's streams, csc_tpu's streams); the last case,
    dict < input, through the port's group encode."""
    from csc_tpu.ops import pipeline as j_pipeline
    cases = encode_cases(level, n)
    props = [c[1] for c in cases]
    datas = [c[2] for c in cases]
    launches = (parse_kernel.LAUNCHES, parse_ap_kernel.LAUNCHES,
                bits_kernel.LAUNCHES)
    ours = pipeline.encode_batch(props[:-1], datas[:-1], device=CPU)
    plans = [encode_host.plan_stream(props[-1], datas[-1])]
    ours += pipeline.encode_group(props[-1:], plans, [0], CPU)
    assert (parse_kernel.LAUNCHES, parse_ap_kernel.LAUNCHES,
            bits_kernel.LAUNCHES) == launches
    monkeypatch.setenv("CSC_ENCODE_PARSE", "fast")
    monkeypatch.setenv("CSC_ENCODE_BITS", "scan")
    ref = j_pipeline.encode_batch(props, datas)
    assert j_pipeline.LAST_ENCODE_FALLBACKS == 0
    return cases, ours, ref


def check_streams(cases, ours, ref):
    from csc_tpu.golden.decoder import DecodeError
    for (name, p, data), o, r in zip(cases, ours, ref):
        assert o == r, name
        if name == "dict_lt_input":
            assert p.dict_size < len(data)
            with pytest.raises(DecodeError):
                decompress_stream(p, o, 0)
            if p.lz_mode == 3:
                # no ring window in the exact parse at m3-m5
                with pytest.raises(pipeline.EncodeError, match="dictionary"):
                    pipeline.encode_batch([p], [data], device=CPU)
            else:
                assert pipeline.plan_streams([p], [data])[0].parse == \
                    "exact"
        else:
            assert decompress_stream(p, o, 0) == data, name
    props = [c[1] for c in cases]
    datas = [c[2] for c in cases]
    assert pipeline.decode_batch(props, ours,
                                 out_sizes=[len(d) for d in datas],
                                 device=CPU) == datas


@pytest.fixture(scope="module")
def m1(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return encode_both(1, mp)


def test_m1_byte_identical_to_csc_tpu_and_decodes(m1):
    check_streams(*m1)


def test_m1_text_equals_golden_encoder(m1):
    cases, ours, _ = m1
    name, p, data = cases[0]
    assert name == "text"
    assert ours[0] == golden_encode(p, data)


def test_empty_stream_is_the_eof_chunk():
    p = props_init(1, 1)
    out = pipeline.encode_batch([p], [b""], device=CPU)[0]
    assert out == golden_encode(p, b"")
    assert pipeline.decode_batch([p], [out], device=CPU) == [b""]


def test_refuses_what_it_cannot_encode():
    data = corpus.words(500, 1)
    # m3 is encoded now; a stream longer than its dictionary is still
    # refused there (32 KB dictionary, 40 KB stream)
    longer = corpus.repetitive(40 * 1024, 2)
    with pytest.raises(pipeline.EncodeError, match="stream 1.*dictionary"):
        pipeline.encode_batch([props_init(500, 1), props_init(500, 3)],
                              [data, longer], device=CPU)
    # past the fast parse's cap an m1-m4 stream takes the exact parse;
    # m5 (its binary-tree finder) has none
    big = b"z" * (encode_host.MAX_ENCODE + 1)
    with pytest.raises(pipeline.EncodeError,
                       match=r"stream 0.*cap.*binary-tree finder \(m5"):
        pipeline.encode_batch([props_init(len(big), 5)], [big], device=CPU)
    with pytest.raises(ValueError, match="meta"):
        pipeline.encode_batch([props_init(500, 1)], [data],
                              device=torch.device("meta"))


def test_k3_overflow_raises(monkeypatch):
    data = corpus.words(600, 2)

    def small(kk, aa, bb, cc, max_rc, max_bc, nmap, nchunk, bsize):
        return bits_kernel.code_k3(kk, aa, bb, cc, 64, 16, nmap, nchunk,
                                   bsize)
    monkeypatch.setattr(pipeline, "code_k3", small)
    with pytest.raises(pipeline.EncodeError, match=r"\[0\].*overflow"):
        pipeline.encode_batch([props_init(600, 1)], [data], device=CPU)


def test_on_stage_sees_every_stage_of_the_one_path():
    data = corpus.words(600, 3)
    p = props_init(600, 1)
    seen = []
    values = {}

    def on_stage(name, **kv):
        seen.append(name)
        values.update(kv)
    outs = pipeline.encode_batch([p], [data], device=CPU, on_stage=on_stage)
    assert seen == ["plan", "precompute", "k2", "stitch", "k3", "remux"]
    assert outs == values["outs"]
    assert outs == pipeline.encode_batch([p], [data], device=CPU)
    assert torch.equal(values["k2_args"][1],
                       parse_pre.pack_candidates(values["cand"]))
    tape, _, run_tables = values["stitch_args"]
    assert values["k3_args"][0].shape[0] == tape.shape[0] == 1
    assert run_tables == [values["plans"][0][1]]
    for got, want in zip(bits_kernel.code_k3(*values["k3_args"]),
                         values["k3_out"]):
        assert torch.equal(got, want)


def test_cli_round_trip_cpu_and_m3_refusal(tmp_path):
    """The CLI round trip on the CPU at -m 1 and at -m 3, which the CLI
    refused until the optimal parse was ported: each stream decodes with
    the port's CLI and with csc_tpu.golden, and -m 3 codes smaller."""
    from csc_tpu.props import read_properties
    data = corpus.words(3000, seed=5)
    src, dec = tmp_path / "in.bin", tmp_path / "out.bin"
    src.write_bytes(data)
    sizes = {}
    for level in ("1", "3"):
        enc = tmp_path / f"x{level}.csc"
        assert cli.main(["c", "-m", level, "--backend", "cpu", str(src),
                         str(enc)]) == 0
        assert cli.main(["d", "--backend", "cpu", str(enc), str(dec)]) == 0
        assert dec.read_bytes() == data
        blob = enc.read_bytes()
        assert decompress_stream(read_properties(blob[:10]), blob,
                                 10) == data
        sizes[level] = len(blob)
    # the optimal parse codes the word salad smaller than m1's lazy one
    assert sizes["3"] < sizes["1"]


def width_case(level, monkeypatch):
    """(cases, the port's streams, csc_tpu's streams) of a group whose
    longest stream, text ending in a repeated phrase and one fresh byte,
    is 1536 bytes: csc_tpu's group width, and the port's (`ap_width`).
    One column wider, the port's parse of it differs (its last cell takes
    a match there), so the width is what makes them equal."""
    from csc_tpu.ops import pipeline as j_pipeline
    text = corpus.torch_python_text(64 * 1024)
    tail = text[20100:20112] + b"\x02"
    data = text[30000:30000 + 1536 - len(tail)] + tail
    cases = [("width", props_init(1536, level), data),
             ("shorter", props_init(1000, level), text[40000:41000])]
    props = [c[1] for c in cases]
    datas = [c[2] for c in cases]
    plans = [encode_host.plan_stream(p, d) for _, p, d in cases]
    assert pipeline._groups(props, plans) == [([1, 0], 1536)]
    ours = pipeline.encode_batch(props, datas, device=CPU)
    wider = pipeline.encode_group(props, plans, [0], CPU, width=1537)
    assert wider[0] != ours[0]
    monkeypatch.setenv("CSC_ENCODE_PARSE", "fast")
    monkeypatch.setenv("CSC_ENCODE_BITS", "scan")
    ref = j_pipeline.encode_batch(props, datas)
    assert j_pipeline.LAST_ENCODE_FALLBACKS == 0
    return cases, ours, ref
