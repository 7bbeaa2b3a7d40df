"""The port's encode_batch at m5 (the optimal parse: candidates, K4's
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
def m5(request, tmp_path_factory):
    gxx(request, tmp_path_factory)
    return encode_both(5)


def test_m5_byte_identical_to_csc_tpu_and_decodes(m5):
    check_streams(*m5)


def test_m5_stream_as_long_as_its_groups_width(request,
                                               tmp_path_factory):
    gxx(request, tmp_path_factory)
    check_streams(*width_case(5))
