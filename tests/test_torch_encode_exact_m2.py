"""The port's exact encode at m2 on the CPU through encode_batch and the
CLI: the checks of tests/test_torch_encode_exact_m1.py (golden's and
csc_tpu's bytes under CSC_ENCODE_PARSE=exact, the decodes, the BAD /
ENTROPY / DLT streams and the refusals).
A file of its own, so the two levels' JAX references run on two test
workers."""
import pytest

import torch_ring_cases as ring
from test_torch_encode_exact_m1 import (check_cli, check_refused,
                                        check_streams, exact_both)


@pytest.fixture(scope="module")
def m2(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    ring.gxx_k1_k3(mp, tmp_path_factory.mktemp("gxx"))
    return exact_both(2, mp)


def test_m2_exact_is_golden_and_csc_tpus_and_decodes(m2):
    check_streams(*m2[:4])


def test_m2_exact_refuses_what_csc_tpu_sends_to_golden(m2):
    check_refused(2, m2[4])


def test_m2_cli_parse_exact(tmp_path, monkeypatch):
    check_cli(2, tmp_path, monkeypatch)
