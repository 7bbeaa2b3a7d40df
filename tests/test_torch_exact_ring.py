"""The exact parse past its dictionary, through the plain version on the
CPU: an m1 stream of 48 KB under a 36 KB dictionary (`props_init(26 *
1024, 1)`, a ring off the 8 KB grid, a BAD run across the ring's end,
torch_edge_cases.ring48) coded by `encode_batch(..., device="cpu")`
under the exact parse and under the fast parse, which routes it to the
exact one (K5's plain version, run once for both; K3's g++ build, as
K3's plain version takes its turn on a ring stream in
test_torch_exact_ring_m1.py / _m2.py), is golden's stream
(csc_tpu.golden.encoder.encode_stream, whose LZ window is a ring of the
dictionary's size), decodes with the port's decode_batch (K1's plain
version) and with the golden decoder, and K5's g++ build gives the plain
version's outputs on its inputs, every field.  What the device path
still refuses: m3 past its dictionary under either parse, and a stream
over the 1 GB window."""
import shutil

import pytest
import torch

from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import exact_kernel, pipeline
from csc_tpu_torch.props import props_init

import torch_edge_cases as edges
import torch_ring_cases as ring
from test_torch_exact_host import assert_same, k5_host

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return (None,) + ring.host_builds(tmp_path_factory.mktemp("ring"),
                                      ("k3", "k5"))


def test_plain_ring_stream_is_golden(builds, monkeypatch):
    ring.use_host_builds(monkeypatch, builds, ("k3",))
    case = edges.ring48(1)
    name, p, data = case
    assert p.dict_size == 36 * 1024 and p.dict_size % 8192
    assert p.dict_size < 40 * 1024 and len(data) == 48 * 1024
    launches = exact_kernel.LAUNCHES
    outs, seen = ring.encode_both([case], monkeypatch)
    assert exact_kernel.LAUNCHES == launches
    assert outs[0] == golden_encode(p, data)
    monkeypatch.undo()
    assert pipeline.decode_batch([p], outs, device=CPU) == [data]
    # the random block across the ring's end stays a BAD run
    btypes = seen["k5_out"][5][0].tolist()
    assert btypes == [constants.DT_ENGTXT] * 4 + [constants.DT_BAD,
                                                  constants.DT_ENGTXT]
    assert_same(k5_host(builds[2], seen["k5_args"]), seen["k5_out"])


class _Huge:
    """A stream that says it is one byte past the window limit."""

    def __len__(self):
        return constants.MAX_WINDOW + 1


@pytest.mark.parametrize("parse", ["fast", "exact"])
def test_still_refused(parse):
    text = corpus.repetitive(2048, 1)
    big = corpus.repetitive(40 * 1024, 2)
    p1 = props_init(len(text), 1)
    p3 = props_init(1024, 3)
    assert p3.dict_size < len(big)
    # m3-m5 past the dictionary is no longer refused: the exact parse's
    # ring takes it (test_torch_exact_ap_ring.py); a stream past the
    # window limit still is
    plans = pipeline.plan_streams([p1, p3], [text, big], parse)
    assert plans[1].parse == "exact"
    with pytest.raises(pipeline.EncodeError,
                       match=f"stream 1: {constants.MAX_WINDOW + 1} bytes "
                             f"is more than the {constants.MAX_WINDOW}-byte "
                             f"window limit") as e:
        pipeline.plan_streams([p1, props_init(1 << 30, 1)], [text, _Huge()],
                              parse)
    assert e.value.streams == [1]


def test_ring_streams_route_to_the_exact_parse():
    """m1 / m2 past the dictionary take the exact parse under the fast
    parse too; m3 within it keeps the fast parse."""
    big = corpus.repetitive(40 * 1024, 2)
    props = [props_init(1024, 1), props_init(1024, 2), props_init(64 * 1024,
                                                                  3)]
    plans = pipeline.plan_streams(props, [big] * 3, "fast")
    assert [pl.parse for pl in plans] == ["exact", "exact", "fast"]
