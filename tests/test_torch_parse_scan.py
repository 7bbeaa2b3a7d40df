"""The plain PyTorch K2 (csc_tpu_torch.ops.parse_scan) against the JAX
fast parse (csc_tpu.ops.encode_scan_fast.run_fast_parse) on the CPU: both
start from one state, built from the same candidates, and every state
field must be equal midway and at completion, at m1 and m2.  K2's
two-word tape, read as csc_tpu's pipeline feeds the stitcher (kind =
w0 & 7, a = w1, b = w0 >> 3), must agree with the JAX token tape.
Integers throughout, so equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csc_tpu.ops import encode_scan_fast as jfast
from csc_tpu.ops import parse_pre as j_pre
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import encode_host, parse_pre, parse_scan, pipeline

import torch_edge_cases as edges


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


@pytest.fixture(scope="module", params=[1, 2])
def runs(request):
    """JAX and torch fast-parse states of one level: initial, after 300
    steps, and final."""
    level = request.param
    cases = _cases(level)
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    p0 = props[0]
    cand, data_dev = j_pre.precompute_candidates(
        data.numpy(), sizes.tolist(), run_ends.numpy(), p0.hash_bits,
        p0.hash_width)
    t = parse_scan.tape_capacity(data.shape[1], run_ends.shape[1])
    run_types = np.array([[r[0] for r in plans[j][1]] + [0] * (
        run_ends.shape[1] - len(plans[j][1])) for j in range(len(cases))],
        np.int32)
    st_j, _ = jfast.make_fast_state(len(cases), data_dev, sizes.tolist(),
                                    dicts.tolist(), cand, run_ends.numpy(),
                                    t, p0.hash_width, run_types=run_types)
    fn = jfast.fast_parse_fn(p0.hash_width, 1, p0.good_len)
    init = _np(st_j)
    mid_j, n_mid = fn(st_j, jnp.int32(300))
    fin_j, n_fin = fn(mid_j, jnp.int32(10 ** 7))
    st_t = parse_scan.state_from_numpy(init, "cpu")
    mid_t, m_mid = parse_scan.run_parse(st_t, p0.good_len, 300)
    mid_np = parse_scan.state_to_numpy(mid_t)
    fin_t, m_fin = parse_scan.run_parse(mid_t, p0.good_len, 10 ** 7)
    own = parse_scan.make_parse_state(
        data, parse_pre.pack_candidates(torch.as_tensor(np.asarray(cand))),
        run_ends, run_skip, sizes, dicts, t)
    return dict(level=level, cases=cases, p0=p0, init=init,
                own=parse_scan.state_to_numpy(own),
                mid=(_np(mid_j), mid_np, int(n_mid), m_mid),
                fin=(_np(fin_j), fin_t, int(n_fin), m_fin))


def _assert_states(want, got, where):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{where} {k}")


def test_initial_state_matches(runs):
    _assert_states(runs["init"], runs["own"], "init")
    back = parse_scan.state_to_numpy(
        parse_scan.state_from_numpy(runs["init"], "cpu"))
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
