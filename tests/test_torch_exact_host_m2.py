"""K5's g++ build against the plain version at m2 (an HT6 row of 8): the
checks of tests/test_torch_exact_host.py on the m2 group of
`exact_cases` and the m2 short group.  A file of its own, so that test
workers spread the levels."""
import pytest

from test_torch_exact_host import (check_budget, check_matches,  # noqa: F401
                                   check_overflow, check_reach, check_width,
                                   exact_group, k5)


@pytest.fixture(scope="module")
def group():
    return exact_group("m2")


def test_m2_k5_host_matches_plain_on_exact_cases(k5, group):
    check_matches(k5, group)


def test_m2_exact_cases_reach_each_mechanism(group):
    check_reach(group)


def test_m2_k5_output_does_not_depend_on_the_width(k5, group):
    check_width(k5, group)


def test_m2_k5_host_tape_overflow_matches_plain(k5):
    check_overflow(k5, 2)


def test_m2_k5_host_step_budget_at_every_step(k5):
    check_budget(k5, 2)
