"""csc_tpu_torch stands alone: it imports nothing of csc_tpu and no jax
(the card's machine has no jax), and its copies of csc_tpu's jax-free
modules equal their originals: the format constants, the props presets
and header, the MemIO demux, and the native filters and analyzer."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from csc_tpu import constants as j_constants
from csc_tpu import native as j_native
from csc_tpu import props as j_props
from csc_tpu.golden import analyzer as j_analyzer
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu.ops import encode_bits, encode_scan, encode_scan_fast
from csc_tpu.ops import framing as j_framing
from csc_tpu.ops import pallas_encode, parse_pre
from csc_tpu_torch import constants, corpus, native, props
from csc_tpu_torch.ops import encode_host, framing, pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import torch
import csc_tpu_torch, csc_tpu_torch.cli, csc_tpu_torch.corpus
from csc_tpu_torch.ops import pipeline
from csc_tpu_torch.props import props_init
data = b"abcabcabd the quick brown window " * 12
p = props_init(len(data), 1)
cpu = torch.device("cpu")
blob = pipeline.encode_stream(p, data, device=cpu)
assert pipeline.decode_stream(p, blob, device=cpu) == data
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "csc_tpu")))
"""


def test_sources_import_nothing_of_csc_tpu_or_jax():
    pat = re.compile(r"^\s*(import\s+(csc_tpu|jax)|from\s+(csc_tpu|jax))\b",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "csc_tpu_torch")):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    found = []
    for f in files:
        with open(f) as fh:
            found += [(f, m.group(0)) for m in pat.finditer(fh.read())]
    assert found == []


def test_encode_decode_load_no_csc_tpu_or_jax():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_constants_equal_their_originals():
    fmt = [n for n in dir(j_constants) if n.isupper()]
    assert len(fmt) >= 30
    for name in fmt:
        assert getattr(constants, name) == getattr(j_constants, name), name
    sources = {
        encode_scan: ("K_LIT", "K_MATCH", "K_REP", "K_REP0L1", "K_SENT_A",
                      "K_END"),
        encode_bits: ("K_RAW", "K_ELIT", "K_DLIT", "K_RLEN", "K_INT",
                      "K_SENT", "K_FLUSH") + tuple(
                          n for n in dir(encode_bits)
                          if n.startswith("B_") and n != "BSIZE_REF"),
        encode_scan_fast: tuple(n for n in dir(constants)
                                if n.startswith("FB_")),
        parse_pre: ("EXT_CAP",),
        pallas_encode: ("ERR_OVERFLOW",),
    }
    for mod, names in sources.items():
        assert names
        for name in names:
            assert getattr(constants, name) == getattr(mod, name), name
    assert constants.NBSTATES == 1 + max(
        getattr(encode_bits, n) for n in dir(encode_bits)
        if n.startswith("B_") and n != "BSIZE_REF")
    assert encode_host._LOG_TABLE == j_analyzer._LOG_TABLE


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_props_presets_and_header(level):
    for dict_size in (1000, 3 * 1024 * 1024, 200 * 1024 * 1024):
        ours = props.props_init(dict_size, level)
        ref = j_props.props_init(dict_size, level)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert props.est_mem_usage(ours) == j_props.est_mem_usage(ref)
        head = props.write_properties(ours)
        assert head == j_props.write_properties(ref)
        back = props.read_properties(head)
        assert dataclasses.asdict(back) == dataclasses.asdict(
            j_props.read_properties(head))
        assert props.write_properties(back) == head


@pytest.fixture(scope="module")
def inputs():
    text = corpus.torch_python_text(64 * 1024)
    exe = corpus.torch_library_exe()
    cases = corpus.parity_cases(text, exe, 1536, seed=12, chunk=1024,
                                big=40 * 1024)
    return text, exe, cases


def test_framing_demux_equal(inputs):
    _, _, cases = inputs
    for name, p, data in cases:
        blob = golden_encode(p, data)
        ours = framing.demux_stream(blob, 0, p.csc_blocksize)
        ref = j_framing.demux_stream(blob, 0, p.csc_blocksize)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b, err_msg=name)
    arrays = [np.arange(n, dtype=np.uint8) for n in (3, 7, 1)]
    np.testing.assert_array_equal(framing.batch_pad(arrays, 9),
                                  j_framing.batch_pad(arrays, 9))
    ends = [np.array([5, 9], np.int32), np.array([4], np.int32)]
    np.testing.assert_array_equal(framing.pad_ends(ends),
                                  j_framing.pad_ends(ends))


def test_native_filters_and_analyzer_equal(inputs):
    text, exe, cases = inputs
    blocks = [d for _, _, d in cases] + [text[:20000], exe[:20000],
                                         exe[-9000:]]
    for data in blocks:
        for k in range(0, len(data), 8192):
            blk = data[k:k + 8192]
            assert native.analyze(blk) == j_native.analyze(blk)
        for fwd, inv, jf, ji in (
                (native.e89_forward, native.e89_inverse,
                 j_native.e89_forward, j_native.e89_inverse),
                (native.dict_forward, native.dict_inverse,
                 j_native.dict_forward, j_native.dict_inverse)):
            a, b = bytearray(data), bytearray(data)
            assert fwd(a) == jf(b)
            assert a == b
            inv(a)
            ji(b)
            assert a == b
        for chn in constants.DLT_INDEX:
            a, b = bytearray(data), bytearray(data)
            native.delta_forward(a, chn)
            j_native.delta_forward(b, chn)
            assert a == b
            native.delta_inverse(a, chn)
            j_native.delta_inverse(b, chn)
            assert a == b == bytearray(data)


def test_decode_error_is_the_ports_own():
    assert pipeline.DecodeError.__module__.startswith("csc_tpu_torch")
    assert pipeline.DecodeError.code == j_constants.DECODE_ERROR


_SPIKES = r"""
import sys
import csc_tpu_torch.spikes, csc_tpu_torch.spikes.__main__
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "csc_tpu", "tools")
             or m.startswith("spike_")))
"""


def test_spikes_load_no_jax_csc_tpu_or_tools():
    """The spike probes import no jax, nothing of csc_tpu and nothing of
    tools/ (the spike files they answer)."""
    r = subprocess.run([sys.executable, "-c", _SPIKES], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
