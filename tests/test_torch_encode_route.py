"""The fast parse past its cap: `encode_batch(..., parse="fast")` codes an
m1 / m2 stream over encode_host.MAX_ENCODE with the exact parse (K5's
plain version here), as csc_tpu hands such a stream to its golden
encoder, so its bytes are golden's and equal parse="exact"'s; a stream
under the cap in the same batch keeps the fast parse (K2); golden's
binary-tree IndexError stream at m5 past the cap raises EncodeError
naming the stream and the reason; the CLI's default `c` writes golden's
stream past the cap.  The cap is lowered to 2 KB with monkeypatch so
that the plain versions run in seconds (K3 and K1 through their g++
builds, torch_ring_cases.gxx_k1_k3); the real size runs in tests/test_torch_exact_golden_big.py (the
g++ builds, 2.2 MB) and on the card (chip_smoke.py phase 9a)."""
import os

import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli, corpus
from csc_tpu_torch.ops import encode_host, pipeline
from csc_tpu_torch.props import props_init, write_properties

import torch_edge_cases as edges
import torch_ring_cases as ring

CPU = torch.device("cpu")
CAP = 2048


@pytest.fixture
def small_cap(monkeypatch, tmp_path_factory):
    monkeypatch.setattr(encode_host, "MAX_ENCODE", CAP)
    ring.gxx_k1_k3(monkeypatch, tmp_path_factory.mktemp("gxx"))
    text = corpus.torch_python_text(64 * 1024)
    return text[20000:21000], text[30000:30000 + CAP + 500]


def test_fast_parse_past_the_cap_takes_the_exact_parse(small_cap,
                                                        monkeypatch):
    small, big = small_cap
    # one parse of each stream for its several entry points
    ring.memo_kernels(monkeypatch, ("parse_k2", "parse_k5", "code_k3"))
    props = [props_init(len(d), 1) for d in (small, big)]
    kernels = []

    def on_stage(name, **values):
        if name in ("k2", "k5"):
            kernels.append(name)
    outs = pipeline.encode_batch(props, [small, big], device=CPU,
                                 on_stage=on_stage)
    assert sorted(kernels) == ["k2", "k5"]
    assert outs[1] == golden_encode(props[1], big)
    assert outs[1] == pipeline.encode_batch([props[1]], [big], device=CPU,
                                            parse="exact")[0]
    assert outs[0] == pipeline.encode_batch([props[0]], [small],
                                            device=CPU)[0]
    assert decompress_stream(props[1], outs[1], 0) == big
    assert pipeline.decode_batch(props, outs, device=CPU) == [small, big]
    # m5 past the cap takes K6's tree too; golden's IndexError stream
    # (tests/torch_edge_cases.py) has no reference bytes
    _, p5, fault = edges.bt_fault_case()
    with pytest.raises(pipeline.EncodeError,
                       match=r"stream\(s\) \[1\]: longer than bt_size.*"
                             "IndexError"):
        pipeline.encode_batch([props[0], p5], [small, fault], device=CPU)


def test_cli_c_past_the_cap_writes_goldens_stream(small_cap, tmp_path):
    _, big = small_cap
    src, enc = str(tmp_path / "in.bin"), str(tmp_path / "out.csc")
    with open(src, "wb") as f:
        f.write(big)
    assert cli.main(["c", "-m", "2", "--backend", "cpu", src, enc]) == 0
    p = props_init(len(big), 2)
    with open(enc, "rb") as f:
        assert f.read() == write_properties(p) + golden_encode(p, big)
    assert os.path.getsize(enc) < len(big)
