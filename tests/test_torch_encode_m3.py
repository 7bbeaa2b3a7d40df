"""The port's encode_batch at m3 (the optimal parse: candidates, K4's
plain version, stitch, K3's plain version, remux) on the CPU against
csc_tpu's fast path: the case set and checks of
tests/test_torch_encode.py (byte identity with
csc_tpu.ops.pipeline.encode_batch under CSC_ENCODE_PARSE=fast
CSC_ENCODE_BITS=scan, decode with the port and with csc_tpu.golden), and
a group whose longest stream is exactly its width, where a match into
the last cell is undone as csc_tpu undoes it.  A file of its own, so the
levels' JAX references run on separate test workers."""
import pytest

from test_torch_encode import check_streams, encode_both, gxx, width_case


@pytest.fixture(scope="module")
def m3(request, tmp_path_factory):
    gxx(request, tmp_path_factory)
    return encode_both(3)


def test_m3_byte_identical_to_csc_tpu_and_decodes(m3):
    check_streams(*m3)


def test_m3_stream_as_long_as_its_groups_width(request,
                                               tmp_path_factory):
    gxx(request, tmp_path_factory)
    check_streams(*width_case(3))
