"""The port's tape stitch (csc_tpu_torch.ops.stitch) against
csc_tpu.ops.stitch_dev.stitch_device_tapes with fill_from_data on the
CPU: fed the same K2 tape and LZ input as numpy, the stitched (kind, a,
b, c) tapes must be equal over their used length and K_END / 0 past it.
The cases hold ENGTXT headers, a multichunk stream, BAD and ENTROPY
payloads and DLT runs (the run mixes of tests/test_stitch_dev.py).  The
K2 tapes come from the kernel's own parser built with g++."""
import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csc_tpu.ops import stitch_dev
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import (encode_host, parse_pre, parse_scan, pipeline,
                               stitch)
from csc_tpu_torch.props import props_init

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csc_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def k2_host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    so = str(tmp_path_factory.mktemp("k2host") / "libk2host.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    os.path.join(CSRC, "encode_k2_host.cpp"), "-o", so],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    lib.csc_k2_host.restype = ctypes.c_int
    lib.csc_k2_host.argtypes = [p, p, i64, i32, p, p, i32, p, p, i32, p,
                                i64, p, i32]
    return lib


def _cases(level):
    rng = np.random.default_rng(51)
    text = corpus.torch_python_text(64 * 1024)
    mixed = corpus.words(8192, 5) + rng.integers(
        0, 256, 8192, dtype=np.uint8).tobytes()

    def p(n, filters=True, raw_blocksize=None):
        q = props_init(n, level)
        if not filters:
            q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
        if raw_blocksize:
            q.raw_blocksize = raw_blocksize
        return q
    return [
        # ENGTXT runs with declared-size headers, chunk flushes mid-stream
        ("engtxt_multichunk", p(40000, raw_blocksize=16384), text[:40000]),
        ("bad", p(12000), rng.integers(0, 256, 12000,
                                       dtype=np.uint8).tobytes()),
        ("entropy", p(640), (rng.integers(0, 10, 640, dtype=np.uint8) * 7
                             + 65).tobytes()),
        ("text_then_bad", p(len(mixed)), mixed),
        ("dlt", p(8192), corpus.dlt_ramp(8192)),
        ("dlt_then_text", p(12288), corpus.dlt_ramp(8192)
         + corpus.words(4096, 8)),
    ]


def _host_parse(lib, data, candp, run_ends, run_skip, sizes, dicts,
                good_len):
    arrays = [np.ascontiguousarray(a.numpy()) for a in
              (data, candp, run_ends, run_skip, sizes, dicts)]
    b, n = arrays[0].shape
    t = parse_scan.tape_capacity(n, arrays[2].shape[1])
    tape = np.zeros((b, t, 2), np.int32)
    out = np.zeros((3, b), np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)
    assert lib.csc_k2_host(ptr(arrays[0]), ptr(arrays[1]), n,
                           arrays[1].shape[1], ptr(arrays[2]),
                           ptr(arrays[3]), arrays[2].shape[1],
                           ptr(arrays[4]), ptr(arrays[5]), good_len,
                           ptr(tape), t, ptr(out), b) == 0
    assert out[1].all() and not out[2].any()
    return tape[:, :out[0].max()]


@pytest.mark.parametrize("level", [1, 2])
def test_stitch_matches_jax(k2_host, level):
    cases = _cases(level)
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    types = {run[0] for plan in plans for run in plan[1]}
    assert {constants.DT_ENGTXT, constants.DT_BAD,
            constants.DT_ENTROPY} <= types and max(types) >= 0x10
    data, run_ends, run_skip, sizes, dicts = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    p0 = props[0]
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        data, run_ends, p0.hash_bits, p0.hash_width))
    tape = _host_parse(k2_host, data, candp, run_ends, run_skip, sizes,
                       dicts, p0.good_len)
    run_tables = [plan[1] for plan in plans]
    ours = stitch.stitch_tapes(torch.from_numpy(tape), data, run_tables)
    w0, w1 = jnp.asarray(tape[..., 0]), jnp.asarray(tape[..., 1])
    ref = stitch_dev.stitch_device_tapes(
        (w0 & 7, w1, w0 >> 3, jnp.zeros_like(w0)), jnp.asarray(data.numpy()),
        run_tables, fill_from_data=True)
    fill = (constants.K_END, 0, 0, 0)
    for name, o, r, f in zip("kabc", ours[:4], ref[:4], fill):
        o, r = o.numpy(), np.asarray(r)
        used = min(o.shape[1], r.shape[1])
        np.testing.assert_array_equal(o[:, :used], r[:, :used], err_msg=name)
        assert (o[:, used:] == f).all() and (r[:, used:] == f).all(), name
    kinds = ours[0].numpy()
    for k in (constants.K_RAW, constants.K_ELIT, constants.K_DLIT,
              constants.K_FLUSH, constants.K_SENT, constants.K_LIT):
        assert (kinds == k).any(), k
