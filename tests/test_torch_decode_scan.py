"""The plain PyTorch K1 (csc_tpu_torch.ops.decode_scan) against the JAX
lockstep scan (csc_tpu.ops.decode_scan) on CPU: both start from one state
and every state field must be equal after N steps and at completion.
All values are integers, so equality is exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csc_tpu.golden.encoder import encode_stream
from csc_tpu.ops import decode_scan as jds
from csc_tpu.ops import pallas_decode
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import decode_scan as tds
from csc_tpu_torch.ops import pipeline as tpipe

N = 1536          # bytes per stream: a few thousand lockstep steps


@pytest.fixture(scope="module")
def batch():
    text = corpus.words(8 * N, seed=1)
    cases = corpus.parity_cases(text, corpus.torch_library_exe(), N, seed=2,
                                chunk=1024, big=40 * 1024)[:-1]
    blobs = [encode_stream(p, d) for _, p, d in cases]
    rc, bc, rce, bce = tpipe._demux([p for _, p, _ in cases], blobs,
                                    [0] * len(cases))
    wnd = tpipe._bucket(max(len(d) for _, _, d in cases))
    return cases, rc, bc, rce, bce, wnd


def _np(st):
    return {k: np.asarray(v) for k, v in st.items()}


def _assert_equal(st_j, st_t, where):
    want = _np(st_j)
    got = tds.state_to_numpy(st_t)
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")


def test_constants_match_jax_package():
    names = [n for n in dir(jds) if n.startswith(("P_", "F_", "IP_", "LF_"))]
    assert len(names) == 12 + 22 + 6 + 3
    for name in names + ["COPY_CHUNK", "NPROB", "MASK32"]:
        assert getattr(constants, name) == getattr(jds, name), name
    assert constants.ERR_NONE == pallas_decode.ERR_NONE
    assert constants.ERR_CORRUPT == pallas_decode.ERR_CORRUPT
    assert constants.NSTATES == len(jds._OPCLASS)


def test_state_round_trip(batch):
    _, rc, bc, rce, bce, wnd = batch
    st = _np(jds.make_decode_state(rc.shape[0], wnd, rc, bc, rce, bce))
    back = tds.state_to_numpy(tds.state_from_numpy(st, "cpu"))
    for k in st:
        np.testing.assert_array_equal(back[k], st[k], err_msg=k)
    # and the port's own initial state equals decode_scan's
    own = tds.make_decode_state(wnd, *(torch.from_numpy(a) for a in
                                      (rc, bc, rce, bce)))
    _assert_equal(st, own, "init")


def test_steps_match_jax_scan(batch):
    cases, rc, bc, rce, bce, wnd = batch
    st_j = jds.make_decode_state(rc.shape[0], wnd, rc, bc, rce, bce)
    st_t = tds.state_from_numpy(_np(st_j), "cpu")
    total = 0
    for upto in (1, 40, 400, 2500, 10 ** 7):
        st_j, nj = jds.run_decode_jit(st_j, wnd, jnp.int32(upto - total))
        st_t, nt = tds.run_decode(st_t, wnd, upto - total)
        assert int(nj) == nt
        total += nt
        _assert_equal(st_j, st_t, f"after {total} steps")
    got = tds.state_to_numpy(st_t)
    assert got["done"].all() and not got["err"].any()
    for i, (name, _, data) in enumerate(cases):
        assert got["wnd_pos"][i] == len(data), name
    # every block kind of the batch was decoded
    types = {int(t) for i in range(len(cases))
             for t in got["blk_log"][i, :got["blk_cnt"][i], 0]}
    assert {1, 3, 7, 8, 9}.issubset(types) and any(t >= 16 for t in types)


def test_single_step_matches(batch):
    """decode_step (one step, present states only) agrees too."""
    _, rc, bc, rce, bce, wnd = batch
    st_j = jds.make_decode_state(rc.shape[0], wnd, rc, bc, rce, bce)
    st_j, _ = jds.run_decode_jit(st_j, wnd, jnp.int32(123))
    st_t = tds.state_from_numpy(_np(st_j), "cpu")
    for _ in range(5):
        st_j = jds.decode_step(st_j, wnd)
        st_t = tds.decode_step(st_t, wnd)
        _assert_equal(st_j, st_t, "decode_step")
