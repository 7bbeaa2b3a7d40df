"""The plain PyTorch K2 (csc_tpu_torch.ops.parse_scan) against the JAX
fast parse (csc_tpu.ops.encode_scan_fast.run_fast_parse) on the CPU: both
start from one state, built from the same candidates, and every state
field must be equal midway and at completion, at m1 and m2.  K2's
two-word tape, read as csc_tpu's pipeline feeds the stitcher (kind =
w0 & 7, a = w1, b = w0 >> 3), must agree with the JAX token tape.
Integers throughout, so equality is exact.

csc_tpu is frozen, and its fast parse takes minutes on the CPU to finish
these streams, so its states are kept in tests/fixtures/
(torch_fixtures.py; the large tables as digests): the fast tests
read them and run the port live; the slow-marked test makes them live
again and holds the stored ones to them."""
import numpy as np
import pytest
import torch

from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import encode_host, parse_pre, parse_scan, pipeline

import torch_edge_cases as edges
import torch_fixtures as fixture


def _cases(level):
    # dict_lt_input's long repeats reach live extension past EXT_CAP,
    # rep matches and good_len exits; K2's edge streams add extensions
    # that end around 32-byte strides under limits that are no multiple
    # of 32, the HT2 quirk, good_len mid-fold and reps before the data
    # start.  (A full tape is the port's own contract, held to the plain
    # version in test_torch_encode_kernel_host.py: csc_tpu's fast parse
    # has no err field, its pipeline sizes the tape so it cannot fill.)
    return corpus.encode_cases(level, seed=41) + edges.k2_cases(level)


def _np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _inputs(cases):
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    return props, plans, data, run_ends, run_skip, sizes, dicts


STAGES = ("init", "mid", "fin")


def reference(level):
    """csc_tpu's fast-parse states of the cases (torch_fixtures): the
    initial one, after 300 steps and the final one ("<stage>/<field>"),
    and the two runs' step counts ("steps")."""
    import jax.numpy as jnp
    from csc_tpu.ops import encode_scan_fast as jfast
    from csc_tpu.ops import parse_pre as j_pre
    cases = _cases(level)
    props, plans, data, run_ends, _, sizes, dicts = _inputs(cases)
    p0 = props[0]
    cand, data_dev = j_pre.precompute_candidates(
        data.numpy(), sizes.tolist(), run_ends.numpy(), p0.hash_bits,
        p0.hash_width)
    t = parse_scan.tape_capacity(data.shape[1], run_ends.shape[1])
    run_types = np.array([[r[0] for r in plans[j][1]] + [0] * (
        run_ends.shape[1] - len(plans[j][1])) for j in range(len(cases))],
        np.int32)
    st, _ = jfast.make_fast_state(len(cases), data_dev, sizes.tolist(),
                                  dicts.tolist(), cand, run_ends.numpy(), t,
                                  p0.hash_width, run_types=run_types)
    fn = jfast.fast_parse_fn(p0.hash_width, 1, p0.good_len)
    values = {f"init/{k}": np.asarray(v) for k, v in st.items()}
    mid, n_mid = fn(st, jnp.int32(300))
    fin, n_fin = fn(mid, jnp.int32(10 ** 7))
    values.update({f"mid/{k}": np.asarray(v) for k, v in mid.items()})
    values.update({f"fin/{k}": np.asarray(v) for k, v in fin.items()})
    values["steps"] = np.array([int(n_mid), int(n_fin)], np.int64)
    # the token tapes whole: test_tape_matches_token_tape reads them
    full = [k for k in values if k.split("/")[-1].startswith("tok_")]
    return cases, values, full


@pytest.fixture(scope="module", params=[1, 2])
def runs(request):
    """csc_tpu's fast-parse states of one level (initial, after 300 steps,
    final), as tests/fixtures/ keeps them (torch_fixtures), and the port's
    own initial state and its runs from it."""
    level = request.param
    cases = _cases(level)
    props, plans, data, run_ends, run_skip, sizes, dicts = _inputs(cases)
    stored = fixture.load(f"parse_scan_m{level}", cases)
    want = {s: {k.split("/", 1)[1]: v for k, v in stored.items()
                if k.startswith(s + "/")} for s in STAGES}
    n_mid, n_fin = (int(v) for v in stored["steps"])
    p0 = props[0]
    cand = parse_pre.precompute_candidates(data, run_ends, p0.hash_bits,
                                           p0.hash_width)
    t = parse_scan.tape_capacity(data.shape[1], run_ends.shape[1])
    own = parse_scan.make_parse_state(
        data, parse_pre.pack_candidates(cand), run_ends, run_skip, sizes,
        dicts, t)
    own_np = parse_scan.state_to_numpy(own)
    mid_t, m_mid = parse_scan.run_parse(own, p0.good_len, 300)
    mid_np = parse_scan.state_to_numpy(mid_t)
    fin_t, m_fin = parse_scan.run_parse(mid_t, p0.good_len, 10 ** 7)
    return dict(level=level, cases=cases, p0=p0, init=want["init"],
                own=own_np,
                mid=(want["mid"], mid_np, n_mid, m_mid),
                fin=(want["fin"], fin_t, n_fin, m_fin))


def _assert_states(want, got, where):
    fixture.assert_values(want, got, where)


def test_initial_state_matches(runs):
    _assert_states(runs["init"], runs["own"], "init")
    back = parse_scan.state_to_numpy(
        parse_scan.state_from_numpy(runs["own"], "cpu"))
    _assert_states(runs["init"], back, "round trip")


def test_states_match_midway_and_at_completion(runs):
    want, got, n_j, n_t = runs["mid"]
    assert n_j == n_t == 300
    _assert_states(want, got, "after 300 steps")
    want, got, n_j, n_t = runs["fin"]
    assert n_j == n_t
    _assert_states(want, parse_scan.state_to_numpy(got), "final")
    assert want["done"].all()


def test_tape_matches_token_tape(runs):
    want, got, _, _ = runs["fin"]
    tape, tok_cnt, done, err = parse_scan.tape_of(got)
    np.testing.assert_array_equal(tok_cnt.numpy(), want["tok_cnt"])
    assert done.all() and not err.any()
    w0, w1 = tape[..., 0].numpy(), tape[..., 1].numpy()
    for j in range(len(runs["cases"])):
        n = want["tok_cnt"][j]
        kind = want["tok_kind"][j, :n]
        np.testing.assert_array_equal(w0[j, :n] & 7, kind)
        wire = (kind == constants.K_MATCH) | (kind == constants.K_REP)
        np.testing.assert_array_equal(w1[j, :n][wire],
                                      want["tok_a"][j, :n][wire])
        np.testing.assert_array_equal((w0[j, :n] >> 3)[wire],
                                      want["tok_b"][j, :n][wire])
        assert not (w1[j, :n][~wire]).any()
    # what the cases were chosen to reach
    kind, b = want["tok_kind"], want["tok_b"]
    match_len = np.where((kind == constants.K_MATCH)
                         | (kind == constants.K_REP), b + 2, 0)
    assert (match_len > parse_pre.EXT_CAP).any()
    assert (match_len >= runs["p0"].good_len).any()
    assert (kind == constants.K_REP).any()
    assert (kind == constants.K_SENT_A).sum() > len(runs["cases"])


@pytest.mark.slow
@pytest.mark.parametrize("level", [1, 2])
def test_fixture_matches_live_reference(level):
    """The stored csc_tpu states are what csc_tpu's fast parse makes of
    the cases today."""
    fixture.check_live(f"parse_scan_m{level}")
