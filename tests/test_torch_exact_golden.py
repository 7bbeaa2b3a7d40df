"""The exact encode path with the kernels' g++ builds, byte for byte
against the golden encoder (csc_tpu.golden.encoder.encode_stream, the
reference CSC encoder's Python twin) at sizes the lockstep plain version
cannot afford on a CPU: K5 (encode_k5_host.cpp) -> stitch.stitch_tapes ->
K3 (encode_k3_host.cpp) -> remux, on 9-40 KB streams at m1 and m2:
torch source text with the TXT filter (a DT_ENGTXT run), the same text
with the filters off, an executable slice with the EXE filter (DT_EXE),
and repetitive text in 1 KB raw blocks (nine chunks, a coder flush
each).  Every stream also decodes back with the golden decoder."""
import shutil

import numpy as np
import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import encode_host, pipeline, stitch
from csc_tpu_torch.props import props_init

from test_torch_encode_kernel_host import P, I32, I64, _build, _k3_host
from test_torch_exact_host import exact_args, k5_host, build_k5_host


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    tmp = tmp_path_factory.mktemp("exact_golden")
    k3 = _build(tmp, "encode_k3_host.cpp", "csc_k3_host",
                [P, P, P, P, I64, P, I64, P, I64, P, P, I32, P, I32, I64, P,
                 P, I32])
    return build_k5_host(tmp), k3


def golden_cases(level):
    """(name, props, data), one preset (hash_bits 16 at m1, 14 at m2)."""
    text = corpus.torch_python_text(256 * 1024)
    exe = corpus.torch_library_exe()

    def p(data, filters=True, raw_blocksize=None):
        q = props_init(len(data), level)
        if not filters:
            q.DLTFilter = q.EXEFilter = q.TXTFilter = 0
        if raw_blocksize:
            q.raw_blocksize = raw_blocksize
        return q
    engtxt = text[30000:50000]
    normal = text[100000:112000]
    ex = exe[len(exe) // 3:len(exe) // 3 + 24000]
    multi = corpus.repetitive(9000, 41)
    return [("engtxt", p(engtxt), engtxt),
            ("text", p(normal, False), normal),
            ("exe", p(ex), ex),
            ("multichunk", p(multi, False, 1024), multi)]


def host_encode(host, cases):
    """The exact encode path of one group with the g++ K5 and K3: the
    plans, the run tables rebuilt from K5's block types and the raw
    streams."""
    k5, k3 = host
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2], exact=True) for c in cases]
    args = exact_args(cases, width=pipeline.ap_width(plans))
    tape, tok_cnt, done, err, _, btypes = k5_host(k5, args)
    assert done.all() and not err.any()
    tape = torch.from_numpy(np.ascontiguousarray(tape[:, :tok_cnt.max()]))
    run_tables = [encode_host.exact_run_table(pl, bt[:len(pl.blocks)])
                  for pl, bt in zip(plans, btypes)]
    kk, aa, bb, cc, _ = stitch.stitch_tapes(tape, args[0], run_tables)
    coded = _k3_host(k3, (kk, aa, bb, cc),
                     *pipeline.k3_shapes(props[0], args[0].shape[1],
                                         run_tables))
    stats = coded[5]
    assert stats[3].all() and not stats[4].any()
    return plans, run_tables, pipeline.remux_group(
        props[0], tuple(torch.from_numpy(x) for x in coded))


@pytest.mark.parametrize("level", [1, 2])
def test_host_exact_pipeline_is_golden(host, level):
    cases = golden_cases(level)
    keys = {(c[1].hash_bits, c[1].hash_width, c[1].good_len,
             c[1].lz_mode, c[1].csc_blocksize) for c in cases}
    assert len(keys) == 1
    plans, run_tables, outs = host_encode(host, cases)
    assert run_tables == [encode_host.plan_stream(c[1], c[2]).runs
                          for c in cases]
    types = {c[0]: [r[0] for r in rt] for c, rt in zip(cases, run_tables)}
    assert types["engtxt"] == [constants.DT_ENGTXT]
    assert types["text"] == [constants.DT_NORMAL]
    assert types["exe"] == [constants.DT_EXE]
    assert len(types["multichunk"]) == 9
    for (name, p, data), out in zip(cases, outs):
        assert 9000 <= len(data) <= 40 * 1024
        assert out == golden_encode(p, data), name
        assert decompress_stream(p, out, 0) == data, name
