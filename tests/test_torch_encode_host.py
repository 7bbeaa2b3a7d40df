"""The port's encode host side (csc_tpu_torch.ops.encode_host) against
csc_tpu.ops.encode_host on the CPU: plan_stream's filtered LZ input and
run table at m1-m5 (csc_tpu's fast path plans with allow_nolz=True and
allow_ap=True), the CompressRLE skeleton, GetDltBpb, and the MemIO
remux."""
import numpy as np
import pytest

from csc_tpu.ops import encode_host as j_host
from csc_tpu_torch import corpus
from csc_tpu_torch.ops import encode_host
from csc_tpu_torch.props import props_init

def _cases(level):
    """The encode case set, plus English-like text long enough for the
    ENGTXT filter."""
    text = corpus.torch_python_text(20000)
    return corpus.encode_cases(level, seed=21) + [
        ("engtxt", props_init(20000, level), text)]


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_plan_stream_matches(level):
    kinds = set()
    for name, p, data in _cases(level):
        ours = encode_host.plan_stream(p, data)
        ref = j_host.plan_stream(p, data, allow_nolz=True, allow_ap=True)
        assert ours == ref, name
        kinds |= {run[0] for run in ours[1]}
        if name == "multichunk":
            assert sum(run[3] for run in ours[1]) == 3
        if name == "dict_lt_input":
            assert p.dict_size < len(data)
    # NORMAL, ENGTXT, EXE, ENTROPY, BAD and a DLT type all planned
    assert {1, 2, 3, 7, 8} <= kinds and max(kinds) >= 0x10


def test_plan_stream_rejects_what_the_device_path_does_not_take():
    data = b"x" * 100
    assert encode_host.plan_stream(props_init(100, 1), b"") is None
    odd = props_init(100, 1)
    odd.lz_mode = 4                      # no device parse has this mode
    assert encode_host.plan_stream(odd, data) is None
    assert j_host.plan_stream(odd, data, allow_nolz=True,
                              allow_ap=True) is None
    big = b"y" * (encode_host.MAX_ENCODE + 1)
    assert encode_host.plan_stream(props_init(len(big), 1), big) is None


def test_rle_tape_and_dlt_bpb_match():
    rng = np.random.default_rng(5)
    for trial in range(30):
        n = int(rng.integers(1, 600))
        vals = rng.integers(0, 4, n).astype(np.uint8)
        if trial % 2:
            vals = np.repeat(vals, rng.integers(1, 40))[:n]
        for a, b in zip(encode_host.rle_tape(vals), j_host.rle_tape(vals)):
            np.testing.assert_array_equal(a, b)
        block = rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()
        for chn in (1, 2, 3, 4, 8):
            assert encode_host._dlt_bpb(block, chn) == \
                j_host._dlt_bpb(block, chn)


def test_remux_stream_matches():
    rng = np.random.default_rng(9)
    bsize = 256
    for trial in range(20):
        rc = rng.integers(0, 256, int(rng.integers(0, 1500)),
                          dtype=np.uint8).tobytes()
        bc = rng.integers(0, 256, int(rng.integers(0, 900)),
                          dtype=np.uint8).tobytes()
        rmap = np.sort(rng.integers(0, len(bc) + 1, 8))
        bmap = np.sort(rng.integers(0, len(rc) + 1, 8))
        nch = int(rng.integers(0, 3))
        ends = sorted((int(rng.integers(0, len(rc) + 1)),
                       int(rng.integers(0, len(bc) + 1)))
                      for _ in range(nch))
        ours = encode_host.remux_stream(bsize, rc, bc, rmap, bmap,
                                        chunk_ends=ends)
        ref = j_host.remux_stream(bsize, rc, bc, rmap, bmap,
                                  chunk_ends=ends)
        assert ours == ref
        regs = (int(rng.integers(0, 1 << 32)), int(rng.integers(0, 2)),
                int(rng.integers(0, 256)), int(rng.integers(1, 4)),
                int(rng.integers(0, 256)), int(rng.integers(0, 8)))
        assert encode_host.remux_stream(bsize, rc, bc, rmap, bmap,
                                        regs=regs) == \
            j_host.remux_stream(bsize, rc, bc, rmap, bmap, regs=regs)
