"""The plain PyTorch K5 (csc_tpu_torch.ops.exact_scan) against csc_tpu's
exact parse (csc_tpu.ops.encode_scan.run_parse) on the CPU at m1: both
start from csc_tpu's state, and every state field (registers, the hash
tables ht2 / ht3 / ht6, the candidate slots, reps and the four-word tape)
must be equal at the start, after 1 500 steps and at the end; the port's
own initial state equals csc_tpu's; the two-word tape K5 returns, read as
csc_tpu's token tape (kind = w0 & 7, a = w1 and b = w0 >> 3 for matches
and reps), agrees with it.  csc_tpu runs one stream at a time (its XLA
loop compiles and runs slowly on a CPU at B > 1), jitted once for the
level's shape with the step count as an argument; every stream has the
same width, 1 536.  The streams: torch source text; an executable slice
with the EXE filter (a DT_EXE run); word salad with the TXT filter, which
stays DT_NORMAL, since the dictionary transform takes runs of 16 KB or
more (csc_host.cpp `csc_dict_forward`); one byte 1 500 times.  Batching
is held through the port alone: three of the streams parsed as one batch
end in the state of their single runs.  Integers throughout, so equality
is exact.  m2 is in a file of its own (test_torch_exact_scan_m2.py), so
that test workers spread the levels."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csc_tpu.ops import encode_scan as j_scan
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import encode_host, exact_scan
from csc_tpu_torch.props import props_init

from test_torch_exact_host import exact_args

MID = 1500        # the midway state's step
WIDTH = 1536
BATCH = ("text", "exe", "byte")


def scan_cases(level):
    """(name, props, data): 1.5 KB streams of one preset (a 32 KB
    dictionary)."""
    text = corpus.torch_python_text(64 * 1024)
    exe = corpus.torch_library_exe()

    def p(filters):
        q = props_init(1536, level)
        q.DLTFilter = 0
        q.EXEFilter = 1 if filters == "exe" else 0
        q.TXTFilter = 1 if filters == "txt" else 0
        return q
    mid = len(exe) // 2
    return [("text", p(None), text[7000:8500]),
            ("exe", p("exe"), exe[mid:mid + 1500]),
            ("words", p("txt"), corpus.words(1500, 31)),
            ("byte", p(None), b"\x55" * 1500)]


def _np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def scan_runs(level):
    """Per stream: csc_tpu's states at the start, after MID steps and at
    the end, with its step counts; the port's from csc_tpu's start and
    its own initial state; and the port's batch run of BATCH."""
    fn = None
    runs = {}
    for case in scan_cases(level):
        args = exact_args([case], width=WIDTH)
        data, blocks, sizes, dicts, hb, hw, gl, lazy, tcap, _ = args
        # one block, one run: csc_tpu's run_ends are the block ends
        assert blocks.shape[1] == 1
        run_ends = blocks[..., 0]
        st_j, cfg = j_scan.make_encode_state(
            1, data.numpy(), sizes.tolist(), dicts.tolist(), hb, hw, gl,
            lazy, tcap, run_ends=run_ends.numpy())
        if fn is None:
            fn = jax.jit(lambda s, ms: j_scan.run_parse(s, cfg, ms))
        init = _np(st_j)
        mid_j, n_mid = fn(st_j, jnp.int32(MID))
        fin_j, n_fin = fn(mid_j, jnp.int32(10 ** 7))
        st = exact_scan.state_from_numpy(init, "cpu")
        st, m_mid = exact_scan.run_parse(st, cfg, MID)
        mid_t = exact_scan.state_to_numpy(st)
        st, m_fin = exact_scan.run_parse(st, cfg, 10 ** 7)
        own, own_cfg = exact_scan.make_exact_state(*args[:9])
        assert own_cfg == cfg
        runs[case[0]] = dict(
            case=case, init=init, own=exact_scan.state_to_numpy(own),
            mid=(_np(mid_j), mid_t, int(n_mid), m_mid),
            fin=(_np(fin_j), st, int(n_fin), m_fin))
    batch = [runs[name]["case"] for name in BATCH]
    st, cfg = exact_scan.make_exact_state(*exact_args(batch,
                                                      width=WIDTH)[:9])
    st, _ = exact_scan.run_parse(st, cfg, 10 ** 7)
    return dict(level=level, runs=runs, batch=st)


def _assert_states(want, got, where):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{where} {k}")


def check_initial(res):
    for name, r in res["runs"].items():
        _assert_states(r["init"], r["own"], f"{name} init")
        back = exact_scan.state_to_numpy(
            exact_scan.state_from_numpy(r["init"], "cpu"))
        _assert_states(r["init"], back, f"{name} round trip")


def check_states(res):
    for name, r in res["runs"].items():
        want, got, n_j, n_t = r["mid"]
        assert n_j == n_t, name
        # the one-byte run ends before MID
        assert n_j == MID or want["done"].all(), name
        _assert_states(want, got, f"{name} after {n_j} steps")
        mid = n_j
        want, got, n_j, n_t = r["fin"]
        assert n_j == n_t, name
        _assert_states(want, exact_scan.state_to_numpy(got), f"{name} final")
        assert want["done"].all(), name
        # the port's own register: every step of a live stream
        assert int(got["steps"][0]) == mid + n_t, name


def check_tape(res):
    for name, r in res["runs"].items():
        want, got = r["fin"][0], r["fin"][1]
        tape, tok_cnt, done, err = exact_scan.tape_of(got)[:4]
        n = int(want["tok_cnt"][0])
        assert int(tok_cnt[0]) == n and done.all() and not err.any()
        w0, w1 = tape[0, :n, 0].numpy(), tape[0, :n, 1].numpy()
        kind = want["tok_kind"][0, :n]
        np.testing.assert_array_equal(w0 & 7, kind, err_msg=name)
        wire = (kind == constants.K_MATCH) | (kind == constants.K_REP)
        np.testing.assert_array_equal(w1[wire], want["tok_a"][0, :n][wire])
        np.testing.assert_array_equal((w0 >> 3)[wire],
                                      want["tok_b"][0, :n][wire])
        assert not w1[~wire].any()


def check_batch(res):
    """Each stream of the batch ends in its single run's state."""
    batch = exact_scan.state_to_numpy(res["batch"])
    steps = res["batch"]["steps"].numpy()
    for j, name in enumerate(BATCH):
        fin = res["runs"][name]["fin"][1]
        single = exact_scan.state_to_numpy(fin)
        for k, v in single.items():
            b = batch[k][j] if batch[k].ndim else batch[k]
            np.testing.assert_array_equal(b, v[0], err_msg=f"{name} {k}")
        assert steps[j] == int(fin["steps"][0]), name


def check_reach(res):
    """The streams' tapes hold literals, matches and reps, the byte run is
    one literal and one match of the rest after HT2's quirk, the EXE
    stream is a DT_EXE run and the words stream a DT_NORMAL one."""
    runs = res["runs"]
    kinds = set()
    for name, r in runs.items():
        fin = r["fin"][0]
        n = int(fin["tok_cnt"][0])
        kinds |= set(int(k) for k in fin["tok_kind"][0, :n])
    assert {constants.K_LIT, constants.K_MATCH, constants.K_REP,
            constants.K_SENT_A, constants.K_END} <= kinds
    types = {name: [t[0] for t in encode_host.plan_stream(
        r["case"][1], r["case"][2])[1]] for name, r in runs.items()}
    assert types["exe"] == [constants.DT_EXE]
    assert types["words"] == [constants.DT_NORMAL]
    byte = runs["byte"]["fin"][0]
    assert int(byte["tok_b"][0, 2]) + 2 == 1498


@pytest.fixture(scope="module")
def m1():
    return scan_runs(1)


def test_m1_initial_state_matches(m1):
    check_initial(m1)


def test_m1_states_match_midway_and_at_completion(m1):
    check_states(m1)


def test_m1_tape_matches_token_tape(m1):
    check_tape(m1)


def test_m1_batch_ends_in_each_streams_single_state(m1):
    check_batch(m1)


def test_m1_cases_reach_each_mechanism(m1):
    check_reach(m1)
