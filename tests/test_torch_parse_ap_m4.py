"""The plain PyTorch K4 against csc_tpu's optimal parse at m4: the checks
of tests/test_torch_parse_ap_m3.py (every state field at the start,
midway and at completion, the token tape, the stitch, what the cases
reach) on the same streams.  A file of its own, so the levels' JAX
references run on separate test workers."""
import pytest

from test_torch_parse_ap_m3 import (ap_runs, check_initial, check_reach,
                                    check_states, check_stitch, check_tape)


@pytest.fixture(scope="module")
def m4():
    return ap_runs(4)


def test_m4_initial_state_matches(m4):
    check_initial(m4)


def test_m4_states_match_midway_and_at_completion(m4):
    check_states(m4)


def test_m4_tape_matches_token_tape(m4):
    check_tape(m4)


def test_m4_cases_reach_each_mechanism(m4):
    check_reach(m4)


def test_m4_stitch_matches_stitch_device(m4):
    check_stitch(m4)
