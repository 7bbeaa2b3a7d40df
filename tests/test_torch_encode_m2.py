"""The port's encode_batch at m2 on the CPU against csc_tpu's fast path:
the same case set and checks as tests/test_torch_encode.py at m1 (byte
identity with csc_tpu.ops.pipeline.encode_batch under
CSC_ENCODE_PARSE=fast CSC_ENCODE_BITS=scan, decode with the port and
with csc_tpu.golden).  A file of its own, so the two levels' JAX
references run on two test workers."""
import pytest

from test_torch_encode import check_streams, encode_both, gxx


@pytest.fixture(scope="module")
def m2(request, tmp_path_factory):
    gxx(request, tmp_path_factory)
    return encode_both(2)


def test_m2_byte_identical_to_csc_tpu_and_decodes(m2):
    check_streams(*m2)


def test_m2_parse_differs_from_m1_and_covers_every_case(m2):
    cases, ours, _ = m2
    assert [c[0] for c in cases] == ["text", "exe", "random", "entropy",
                                     "dlt", "multichunk", "dict_lt_input"]
    assert all(c[1].hash_width == 8 for c in cases)
    assert all(len(o) > 0 for o in ours)
