"""The plain PyTorch K5 against csc_tpu's exact parse at m2 (an HT6 row
of 8): the checks of tests/test_torch_exact_scan_m1.py on the same
streams.  A file of its own, so the two levels' JAX references run on
two test workers."""
import pytest

from test_torch_exact_scan_m1 import (check_batch, check_initial,
                                      check_reach, check_states, check_tape,
                                      scan_runs)


@pytest.fixture(scope="module")
def m2():
    return scan_runs(2)


def test_m2_initial_state_matches(m2):
    check_initial(m2)


def test_m2_states_match_midway_and_at_completion(m2):
    check_states(m2)


def test_m2_tape_matches_token_tape(m2):
    check_tape(m2)


def test_m2_batch_ends_in_each_streams_single_state(m2):
    check_batch(m2)


def test_m2_cases_reach_each_mechanism(m2):
    check_reach(m2)
