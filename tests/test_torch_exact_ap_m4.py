"""The exact optimal parse at m4 on the CPU: tests/test_torch_exact_ap_m3.py's
checks (golden's and csc_tpu's bytes, both decoders, each case's
mechanism, the shadow model against golden's Model) on the m4 preset
(hash_width 8, good_len 24)."""
import pytest

from test_torch_exact_ap_m3 import (ap_run, check_bytes, check_mechanisms,
                                    check_models)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return ap_run(4, tmp_path_factory.mktemp("ap_m4"))


def test_bytes_are_goldens_and_csc_tpus(run):
    check_bytes(run)


def test_reaches_each_mechanism(run):
    check_mechanisms(run)


def test_shadow_model_ends_as_goldens_model(run):
    check_models(run)
