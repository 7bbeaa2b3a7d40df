"""The plain PyTorch K4 against csc_tpu's optimal parse at m5: the checks
of tests/test_torch_parse_ap_m3.py (every state field at the start,
midway and at completion, the token tape, the stitch, what the cases
reach) on the same streams.  A file of its own, so the levels' JAX
references run on separate test workers."""
import pytest

from test_torch_parse_ap_m3 import (ap_runs, check_initial, check_reach,
                                    check_states, check_stitch, check_tape)


@pytest.fixture(scope="module")
def m5():
    return ap_runs(5)


def test_m5_initial_state_matches(m5):
    check_initial(m5)


def test_m5_states_match_midway_and_at_completion(m5):
    check_states(m5)


def test_m5_tape_matches_token_tape(m5):
    check_tape(m5)


def test_m5_cases_reach_each_mechanism(m5):
    check_reach(m5)


def test_m5_stitch_matches_stitch_device(m5):
    check_stitch(m5)
