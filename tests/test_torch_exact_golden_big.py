"""One ~2.2 MB m1 stream through the exact encode path with the kernels'
g++ builds (K5 encode_k5_host.cpp -> stitch -> K3 encode_k3_host.cpp ->
remux, the harness of tests/test_torch_exact_golden.py), byte for byte
against the golden encoder (csc_tpu.golden.encoder.encode_stream): past
the fast parse's 1 MB cap and past one 2 MB raw chunk (two chunks, a
coder flush each), with torch source text, a slice of libc10.so (a
DT_EXE run), random bytes (a DT_BAD run), and a random 8 KB block
repeated after 64 KB of text, which the duplicate-block probe re-types
DT_NORMAL.  About half a minute of golden's time on one core, so a file
of its own."""
import numpy as np

from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import encode_host
from csc_tpu_torch.props import props_init

from test_torch_exact_golden import host, host_encode  # noqa: F401

KB = 1024


def big_case():
    rng = np.random.default_rng(41)
    text = corpus.torch_python_text(2 * 1024 * KB)
    exe = corpus.torch_library_exe()
    block = rng.integers(0, 256, 8 * KB, dtype=np.uint8).tobytes()
    data = (text[:1280 * KB] + exe[len(exe) // 2:len(exe) // 2 + 384 * KB]
            + rng.integers(0, 256, 256 * KB, dtype=np.uint8).tobytes()
            + block + text[1280 * KB:1344 * KB] + block
            + text[1344 * KB:1616 * KB])
    return "big", props_init(len(data), 1), data


def test_host_exact_pipeline_is_golden_past_the_cap(host):
    case = big_case()
    name, p, data = case
    assert len(data) > p.raw_blocksize > encode_host.MAX_ENCODE
    plans, run_tables, outs = host_encode(host, [case])
    types = [r[0] for r in run_tables[0]]
    assert {constants.DT_EXE, constants.DT_BAD} <= set(types)
    assert sum(r[3] for r in run_tables[0]) == 2
    # the repeated block: DT_BAD before the probe, DT_NORMAL after it
    blocks = plans[0].blocks
    sizes = np.diff(blocks[:, 0], prepend=0)
    bad = (blocks[:, 1] & encode_host.BLK_TYPE) == constants.DT_BAD
    assert sum(r[1] for r in run_tables[0]
               if r[0] == constants.DT_BAD) <= int(sizes[bad].sum()) - 8 * KB
    assert outs[0] == golden_encode(p, data)
