"""The port's exact encode at m1 on the CPU, through its entry points:
`encode_batch(..., parse="exact", device="cpu")` (K5's and K3's plain
versions) and the CLI `c --parse exact --backend cpu` must give the bytes
of the golden encoder (csc_tpu.golden.encoder.encode_stream) and of
csc_tpu's encode_batch under CSC_ENCODE_PARSE=exact CSC_ENCODE_BITS=scan,
on the 1 KB text and EXE streams and the 3 KB multichunk stream of
corpus.encode_cases.  csc_tpu runs one stream at a time (its exact parse
compiles and runs slowly on a CPU at B > 1); the port encodes them as one
batch.  Every stream decodes with the port's decode_batch and with the
golden decoder; the fast parse's kernels (K2, K4) are not launched.
What csc_tpu hands to its golden encoder on this path: a BAD, an ENTROPY
and a DLT run give golden's bytes (and csc_tpu's, from its fallback); a
dictionary smaller than the stream takes the exact parse, its ring window
wrapping; m5 (its binary-tree finder) raises EncodeError naming the
stream.  m2 is in a file of its own (test_torch_encode_exact_m2.py), so
the levels' JAX references run on two test workers."""
import os

import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli, corpus
from csc_tpu_torch.ops import (exact_kernel, parse_ap_kernel, parse_kernel,
                               pipeline)
from csc_tpu_torch.props import props_init, write_properties

CPU = torch.device("cpu")
KEEP = ("text", "exe", "multichunk")


def exact_both(level, monkeypatch):
    """(cases, the port's streams, csc_tpu's streams, golden's streams)
    of the cases the exact path takes, and the cases it refuses."""
    from csc_tpu.ops import pipeline as j_pipeline
    cases = corpus.encode_cases(level, n=1024, seed=71)
    keep = [c for c in cases if c[0] in KEEP]
    launches = (parse_kernel.LAUNCHES, parse_ap_kernel.LAUNCHES,
                exact_kernel.LAUNCHES)
    ours = pipeline.encode_batch([c[1] for c in keep], [c[2] for c in keep],
                                 device=CPU, parse="exact")
    assert (parse_kernel.LAUNCHES, parse_ap_kernel.LAUNCHES,
            exact_kernel.LAUNCHES) == launches
    monkeypatch.setenv("CSC_ENCODE_PARSE", "exact")
    monkeypatch.setenv("CSC_ENCODE_BITS", "scan")
    ref = []
    for _, p, data in keep:
        ref += j_pipeline.encode_batch([p], [data])
        assert j_pipeline.LAST_ENCODE_FALLBACKS == 0
    gold = [golden_encode(p, data) for _, p, data in keep]
    return keep, ours, ref, gold, [c for c in cases if c[0] not in KEEP]


def check_streams(keep, ours, ref, gold):
    for (name, p, data), o, r, g in zip(keep, ours, ref, gold):
        assert o == g, name
        assert o == r, name
        assert decompress_stream(p, o, 0) == data, name
    assert pipeline.decode_batch([c[1] for c in keep], ours,
                                 out_sizes=[len(c[2]) for c in keep],
                                 device=CPU) == [c[2] for c in keep]


def check_refused(level, refused):
    """What csc_tpu hands to its golden encoder on this path: the BAD,
    ENTROPY and DLT streams, which the exact parse refused before it took
    them, give golden's bytes and csc_tpu's (its fallback's) and decode;
    a dictionary smaller than the stream, which the exact parse refused
    before it followed golden's ring window, is taken by it under either
    parse (its bytes are golden's in test_torch_exact_ring_m1.py / _m2.py;
    csc_tpu's device parse, which has no ring, writes a stream golden
    rejects, test_torch_encode.py); m5 still raises EncodeError naming
    the stream (its index in a batch behind a stream the path
    takes) and the reason."""
    from csc_tpu.ops import pipeline as j_pipeline
    text = corpus.encode_cases(level, n=1024, seed=71)[0]
    assert sorted(c[0] for c in refused) == ["dict_lt_input", "dlt",
                                             "entropy", "random"]
    ring = [c for c in refused if c[0] == "dict_lt_input"]
    taken = [c for c in refused if c[0] != "dict_lt_input"]
    for parse in pipeline.PARSES:
        plans = pipeline.plan_streams([c[1] for c in ring],
                                      [c[2] for c in ring], parse)
        assert len(ring[0][2]) > ring[0][1].dict_size
        assert plans[0].parse == "exact", parse
    ours = pipeline.encode_batch([c[1] for c in taken],
                                 [c[2] for c in taken], device=CPU,
                                 parse="exact")
    for (name, p, data), o in zip(taken, ours):
        assert o == golden_encode(p, data), name
        assert j_pipeline.encode_batch([p], [data]) == [o], name
        assert j_pipeline.LAST_ENCODE_FALLBACKS == 1, name
        assert decompress_stream(p, o, 0) == data, name
    assert pipeline.decode_batch([c[1] for c in taken], ours,
                                 device=CPU) == [c[2] for c in taken]
    ap = props_init(len(text[2]), 5)
    with pytest.raises(pipeline.EncodeError,
                       match=r"stream 1: .*binary-tree finder \(m5"):
        pipeline.encode_batch([text[1], ap], [text[2], text[2]], device=CPU,
                              parse="exact")


def check_cli(level, tmp_path):
    """`c --parse exact --backend cpu` writes the header and golden's
    stream; `d` reads it back."""
    data = corpus.torch_python_text(64 * 1024)[3000:4500]
    src, enc, dst = (str(tmp_path / n) for n in ("in.bin", "out.csc",
                                                 "back.bin"))
    with open(src, "wb") as f:
        f.write(data)
    assert cli.main(["c", "-m", str(level), "--parse", "exact", "--backend",
                     "cpu", src, enc]) == 0
    assert cli.main(["d", "--backend", "cpu", enc, dst]) == 0
    with open(enc, "rb") as f:
        blob = f.read()
    with open(dst, "rb") as f:
        assert f.read() == data
    p = props_init(len(data), level)
    assert blob == write_properties(p) + golden_encode(p, data)
    assert os.path.getsize(enc) < len(data)


@pytest.fixture(scope="module")
def m1(request):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return exact_both(1, mp)


def test_m1_exact_is_golden_and_csc_tpus_and_decodes(m1):
    check_streams(*m1[:4])


def test_m1_exact_refuses_what_csc_tpu_sends_to_golden(m1):
    check_refused(1, m1[4])


def test_m1_cli_parse_exact(tmp_path):
    check_cli(1, tmp_path)
