"""The plain PyTorch K4 (csc_tpu_torch.ops.parse_ap_scan) against csc_tpu's
optimal parse (csc_tpu.ops.parse_ap.run_ap_parse) on the CPU at m3: both
start from one state, built from the same candidates, and every state
field must be equal at the start, midway and at completion; the port's
own initial state, from its packed candidates and price snapshot, equals
csc_tpu's.  K4's two-word tape, read as csc_tpu's token tape (kind = w0
& 7, a = w1 and b = w0 >> 3 for matches and reps), must agree with it,
and the port's stitch of that tape must equal csc_tpu's stitch_device of
the final state.  The streams are tests/torch_edge_cases.py `ap_cases`:
text, a BAD run and a stream as long as the group's width, runs of one
byte, random bytes, a stretch ended at the AP_LIMIT cap, one byte.
Integers throughout, so equality is exact.  m4 and m5 are in files of
their own (test_torch_parse_ap_m4.py, _m5.py), so that test workers
spread them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csc_tpu.ops import parse_ap as jap
from csc_tpu.ops import parse_pre as j_pre
from csc_tpu.ops import stitch_dev
from csc_tpu_torch import constants
from csc_tpu_torch.ops import (encode_host, parse_ap_scan, parse_pre,
                               parse_scan, pipeline, prices, stitch)

import torch_edge_cases as edges

MID = 1500        # the midway state's step


def _np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def ap_runs(level):
    """csc_tpu's and the plain version's states of ap_cases(level): the
    start, after MID steps, and the end; the plain version's stretch ends
    (post action, end - s0) and the steps that continued a stretch
    start's extensions."""
    cases = edges.ap_cases(level)
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    p0 = props[0]
    w = p0.hash_width or 8
    cand, data_dev = j_pre.precompute_candidates(
        data.numpy(), sizes.tolist(), run_ends.numpy(), p0.hash_bits, w)
    t = parse_scan.tape_capacity(data.shape[1], run_ends.shape[1])
    run_types = np.array([[r[0] for r in plans[j][1]] + [0] * (
        run_ends.shape[1] - len(plans[j][1])) for j in range(len(cases))],
        np.int32)
    st_j, _ = jap.make_ap_state(len(cases), data.numpy(), sizes.tolist(),
                                dicts.tolist(), cand, run_ends.numpy(), t, w,
                                p0.good_len, run_types=run_types)
    init = _np(st_j)
    fn = jap.ap_parse_fn(w, p0.good_len)
    mid_j, n_mid = fn(st_j, jnp.int32(MID))
    fin_j, n_fin = fn(mid_j, jnp.int32(10 ** 7))
    # the plain version step by step, noting each stretch end and each
    # step that goes on extending at a stretch start
    st = parse_ap_scan.state_from_numpy(init, "cpu")
    steps, ends, at_s0 = 0, [], 0
    while not bool((st["done"] == 1).all()):
        prev = st
        st = parse_ap_scan.ap_parse_step(st, p0.good_len)
        steps += 1
        marked = (st["fsm"] == constants.AP_MARK) & (prev["fsm"]
                                                     == constants.AP_FIND)
        for j in marked.nonzero().flatten().tolist():
            ends.append((int(st["post"][j]), int(st["end"][j] - st["s0"][j])))
        at_s0 += int(((prev["armed"] == 1) & (st["armed"] == 1)
                      & (prev["wpos"] == prev["s0"])).sum())
        if steps == MID:
            mid_np = parse_ap_scan.state_to_numpy(st)
    # and run_ap_parse, from the start to MID and on to the end
    mid_t, m_mid = parse_ap_scan.run_ap_parse(
        parse_ap_scan.state_from_numpy(init, "cpu"), p0.good_len, MID)
    np.testing.assert_array_equal(mid_t["tok_cnt"].numpy(),
                                  mid_np["tok_cnt"])
    fin_t, m_fin = parse_ap_scan.run_ap_parse(mid_t, p0.good_len, 10 ** 7)
    assert m_mid + m_fin == steps
    for k in ("tok_kind", "tok_a", "tok_b", "tok_c", "tok_cnt", "price"):
        assert torch.equal(fin_t[k], st[k]), k
    candp = parse_pre.pack_candidates(torch.as_tensor(np.array(cand)))
    pr = torch.from_numpy(prices.pack_prices(prices.snapshot_prices()))
    own = parse_ap_scan.make_ap_state(data, candp, run_ends, run_skip, sizes,
                                      dicts, pr, t)
    return dict(level=level, cases=cases, plans=plans, p0=p0, init=init,
                own=parse_ap_scan.state_to_numpy(own), data_dev=data_dev,
                mid=(_np(mid_j), mid_np, int(n_mid), m_mid),
                fin=(fin_j, fin_t, int(n_fin), m_fin), ends=ends,
                at_s0=at_s0)


def _assert_states(want, got, where):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{where} {k}")


def check_initial(runs):
    _assert_states(runs["init"], runs["own"], "init")
    back = parse_ap_scan.state_to_numpy(
        parse_ap_scan.state_from_numpy(runs["init"], "cpu"))
    _assert_states(runs["init"], back, "round trip")


def check_states(runs):
    want, got, n_j, n_t = runs["mid"]
    assert n_j == n_t == MID
    _assert_states(want, got, f"after {MID} steps")
    want, got, n_j, n_t = runs["fin"]
    assert n_j == n_t
    _assert_states(_np(want), parse_ap_scan.state_to_numpy(got), "final")
    assert np.asarray(want["done"]).all()


def check_tape(runs):
    want, got = _np(runs["fin"][0]), runs["fin"][1]
    tape, tok_cnt, done, err = parse_ap_scan.tape_of(got)
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


def check_reach(runs):
    """What the cases were chosen to reach."""
    want = _np(runs["fin"][0])
    kind, b = want["tok_kind"], want["tok_b"]
    lz = (kind == constants.K_MATCH) | (kind == constants.K_REP)
    assert (lz & (b + 2 >= runs["p0"].good_len)).any()
    assert (kind == constants.K_REP0L1).any()
    posts = {p for p, _ in runs["ends"]}
    assert {constants.POST_LIT, constants.POST_MATCH} <= posts
    # a stretch ended at the cap: its match straddles cell AP_LIMIT
    assert max(n for _, n in runs["ends"]) >= constants.AP_LIMIT - 8
    assert runs["at_s0"] > 0
    skipped = [j for j, pl in enumerate(runs["plans"])
               if any(r[0] >= constants.DT_NO_LZ for r in pl[1])]
    assert [runs["cases"][j][0] for j in skipped] == ["mixed_runs"]
    sizes = [len(c[2]) for c in runs["cases"]]
    assert max(sizes) == runs["init"]["data"].shape[1] == sizes[1]
    assert want["tok_cnt"][sizes.index(1)] == 3      # literal, SENT_A, END


def check_stitch(runs):
    """The port's stitch of the plain version's tape equals csc_tpu's
    stitch_device of its final state over the used length."""
    fin_j, got = runs["fin"][0], runs["fin"][1]
    tape, tok_cnt, _, _ = parse_ap_scan.tape_of(got)
    tape = tape[:, :int(tok_cnt.max())].contiguous()
    run_tables = [pl[1] for pl in runs["plans"]]
    data = got["data"]
    ours = stitch.stitch_tapes(tape, data, run_tables)
    ref = stitch_dev.stitch_device(fin_j, runs["data_dev"], run_tables)
    fill = (constants.K_END, 0, 0, 0)
    for name, o, r, f in zip("kabc", ours[:4], ref[:4], fill):
        o, r = o.numpy(), np.asarray(r)
        used = min(o.shape[1], r.shape[1])
        np.testing.assert_array_equal(o[:, :used], r[:, :used], err_msg=name)
        assert (o[:, used:] == f).all() and (r[:, used:] == f).all(), name


@pytest.fixture(scope="module")
def m3():
    return ap_runs(3)


def test_snapshot_prices_equal_csc_tpus():
    want = jap.snapshot_prices(1)
    got = prices.snapshot_prices()
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    packed = torch.from_numpy(prices.pack_prices(got))
    for name, t in prices.unpack_prices(packed).items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)


def test_m3_initial_state_matches(m3):
    check_initial(m3)


def test_m3_states_match_midway_and_at_completion(m3):
    check_states(m3)


def test_m3_tape_matches_token_tape(m3):
    check_tape(m3)


def test_m3_cases_reach_each_mechanism(m3):
    check_reach(m3)


def test_m3_stitch_matches_stitch_device(m3):
    check_stitch(m3)
