"""The checks of tests/test_torch_exact_nolz_m1.py at m2 (golden's and
csc_tpu's bytes on every run type, the decodes, the block types, K5's
g++ build against the plain version and at every step budget).  A file
of its own, so that test workers spread the levels."""
import pytest

from test_torch_exact_host import k5  # noqa: F401
from test_torch_exact_nolz_m1 import (check_budget, check_host,
                                      check_streams, check_types, nolz_run)


@pytest.fixture(scope="module")
def m2(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return nolz_run(2, mp, tmp_path_factory.mktemp("nolz_m2"))


def test_m2_nolz_exact_is_golden_and_csc_tpus_and_decodes(m2):
    check_streams(m2)


def test_m2_nolz_block_types_follow_the_probe(m2):
    check_types(m2)


def test_m2_k5_host_matches_plain_on_nolz_cases(k5, m2):
    check_host(k5, m2)


def test_m2_k5_host_step_budget_through_probes_and_sparse_runs(k5):
    check_budget(k5, 2)
