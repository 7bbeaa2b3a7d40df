"""The plain PyTorch K3 (csc_tpu_torch.ops.bits_scan) against the JAX
phase-B scan (csc_tpu.ops.encode_bits.run_bits) on the CPU: both start
from one state built from the same stitched tapes, and every state field
(probabilities, rc / bc bytes and counts, the block-crossing maps, the
chunk log, the coder registers) must be equal midway and at completion.
A 512-byte block size makes the crossing maps fill; a bc capacity below
one BAD stream's payload makes that stream overflow.  The cases include
a text + DLT stream (csc_tpu 98304f3's parked literal), BAD, ENTROPY,
long RLE runs and a multichunk stream.  Integers throughout,
so equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csc_tpu.ops import encode_bits
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import (bits_scan, encode_host, parse_pre, parse_scan,
                               pipeline, stitch)
from csc_tpu_torch.props import props_init

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")
BSIZE = 512
MAX_BC = 4096


def _cases():
    rng = np.random.default_rng(61)
    dlt = bytearray(corpus.dlt_ramp(3072))
    dlt[512:1024] = b"\x42" * 512           # a long run in the delta domain
    text = corpus.torch_python_text(16 * 1024)

    def p(n, filters=True, raw_blocksize=None):
        q = props_init(n, 2)
        if not filters:
            q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
        if raw_blocksize:
            q.raw_blocksize = raw_blocksize
        return q
    return [
        ("text", p(1536, False), text[:1536]),
        ("text_dlt", p(9728), corpus.dlt_ramp(8192) + corpus.words(1536, 2)),
        ("dlt_runs", p(3072), bytes(dlt)),
        ("bad", p(8192), rng.integers(0, 256, 8192,
                                      dtype=np.uint8).tobytes()),
        ("entropy", p(640), (rng.integers(0, 10, 640, dtype=np.uint8) * 7
                             + 65).tobytes()),
        ("multichunk", p(2200, False, 1024), corpus.repetitive(2200, 4)),
    ]


def _stitched(tmp_dir):
    """Stitched tapes of the cases, parsed by K2's g++ build."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    cases = _cases()
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    p0 = props[0]
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        data, run_ends, p0.hash_bits, p0.hash_width)).numpy()
    so = str(tmp_dir / "libk2host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    os.path.join(CSRC, "encode_k2_host.cpp"), "-o", so],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.csc_k2_host.argtypes = [p, p, i64, i32, p, p, i32, p, p, i32, p,
                                i64, p, i32]
    arrays = [np.ascontiguousarray(a) for a in
              (data.numpy(), candp, run_ends.numpy(), run_skip.numpy(),
               sizes.numpy(), dicts.numpy())]
    b, n = arrays[0].shape
    t = parse_scan.tape_capacity(n, arrays[2].shape[1])
    tape = np.zeros((b, t, 2), np.int32)
    out = np.zeros((3, b), np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)
    lib.csc_k2_host(ptr(arrays[0]), ptr(arrays[1]), n, arrays[1].shape[1],
                    ptr(arrays[2]), ptr(arrays[3]), arrays[2].shape[1],
                    ptr(arrays[4]), ptr(arrays[5]), p0.good_len, ptr(tape),
                    t, ptr(out), b)
    tape = torch.from_numpy(tape[:, :out[0].max()].copy())
    kk, aa, bb, cc, _ = stitch.stitch_tapes(tape, data,
                                            [pl[1] for pl in plans])
    return cases, n, (kk, aa, bb, cc)


def _np(st):
    return {k: np.asarray(v) for k, v in st.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, n, tapes = _stitched(tmp_path_factory.mktemp("k2host"))
    max_rc = 2 * n + 4096
    old = encode_bits.BSIZE_REF[0]
    encode_bits.BSIZE_REF[0] = BSIZE
    try:
        st = encode_bits.make_bits_state(len(cases),
                                         *(t.numpy() for t in tapes),
                                         max_rc, MAX_BC)
        init = _np(st)
        fn = jax.jit(encode_bits.run_bits)
        mid_j, n_mid = fn(st, jnp.int32(500))
        fin_j, n_fin = fn(mid_j, jnp.int32(10 ** 7))
        mid_j, fin_j = _np(mid_j), _np(fin_j)
    finally:
        encode_bits.BSIZE_REF[0] = old
    st_t = bits_scan.state_from_numpy(init, "cpu")
    mid_t, m_mid = bits_scan.run_bits(st_t, BSIZE, 500)
    mid_np = bits_scan.state_to_numpy(mid_t)
    fin_t, m_fin = bits_scan.run_bits(mid_t, BSIZE, 10 ** 7)
    own = bits_scan.make_bits_state(*tapes, max_rc, MAX_BC,
                                    init["rc_blkmap"].shape[1],
                                    init["chunk_log"].shape[1])
    return dict(cases=cases, tapes=tapes, init=init, max_rc=max_rc,
                own=bits_scan.state_to_numpy(own),
                mid=(mid_j, mid_np, int(n_mid), m_mid),
                fin=(fin_j, fin_t, int(n_fin), m_fin))


def _assert_states(want, got, where):
    assert set(want) == set(got)
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        np.testing.assert_array_equal(got[k], want[k],
                                      err_msg=f"{where} {k}")


def test_initial_state_matches(runs):
    _assert_states(runs["init"], runs["own"], "init")
    back = bits_scan.state_to_numpy(
        bits_scan.state_from_numpy(runs["init"], "cpu"))
    _assert_states(runs["init"], back, "round trip")


def test_states_match_midway_and_at_completion(runs):
    want, got, n_j, n_t = runs["mid"]
    assert n_j == n_t == 500
    _assert_states(want, got, "after 500 steps")
    want, got, n_j, n_t = runs["fin"]
    assert n_j == n_t
    _assert_states(want, bits_scan.state_to_numpy(got), "final")
    assert want["done"].all()


def test_outputs_and_overflow(runs):
    want, got, _, _ = runs["fin"]
    rc_out, bc_out, rc_map, bc_map, clog, stats = bits_scan.outputs_of(got)
    stats = stats.numpy()
    np.testing.assert_array_equal(stats[0], want["rc_cnt"])
    np.testing.assert_array_equal(stats[1], want["bc_cnt"])
    np.testing.assert_array_equal(stats[2], want["chunk_cnt"])
    # csc_tpu's pipeline treats a count at or past the capacity as an
    # overflow (pipeline.py:638); only the BAD stream passes MAX_BC
    over = (want["rc_cnt"] >= runs["max_rc"]) | (want["bc_cnt"] >= MAX_BC)
    np.testing.assert_array_equal(stats[4] == constants.ERR_OVERFLOW, over)
    names = [c[0] for c in runs["cases"]]
    assert over.tolist() == [n == "bad" for n in names]
    # both maps saw crossings, the multichunk stream logged its chunks
    assert (want["rc_cnt"] >= 2 * BSIZE).any()
    assert (want["bc_cnt"] >= 2 * BSIZE).any()
    assert (rc_map.numpy() > 0).any()
    assert stats[2][names.index("multichunk")] == 3
    kinds = runs["tapes"][0].numpy()
    for k in (constants.K_DLIT, constants.K_RLEN, constants.K_RAW,
              constants.K_ELIT, constants.K_REP, constants.K_FLUSH):
        assert (kinds == k).any(), k
