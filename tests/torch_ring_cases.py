"""Streams longer than their dictionary, for the exact parse's ring window
(golden/lz.py:28, 51-75), and the kernels' g++ builds behind the
pipeline's entry points, so that the CPU tests can drive streams the
lockstep plain versions cannot afford.

Cases are (name, props, data).  `ring48` (torch_edge_cases', which the
card's chip_smoke.py shares): 48 KB of corpus.repetitive under a 36 KB
dictionary (off the 8 KB grid), a random 8 KB block across the ring's
end (a BAD run across it).  `mixed`: 200 KB of torch text
under a 50 KB dictionary (four laps): a random block across the first
ring end and a block that repeats its first 2 KB, whose duplicate-probe
hits reach across the wrap; an EXE run and a DLT run.  `chunks`: 80 KB
of repetitive text in two 40 KB raw chunks under a 32 KB dictionary.
`quirks`: 128 KB of torch text (TXT filter off) under a 36 KB dictionary
with each ring rule made visible: a source 5 bytes before the first ring
end that a probe would match past it, the hashes past a sub-block end
that read the previous lap's bytes, HT2 at a distance equal to the ring
position, and a probe whose window runs on past its frontier into the
previous lap's bytes.  Each rule, undone in K5's g++ build, changes that
stream's bytes at m1 (the hashes' rule) or at m1 and m2 (the others).
"""
from types import SimpleNamespace

import numpy as np
import torch

from csc_tpu_torch import corpus
from csc_tpu_torch.ops import exact_ap_scan, pipeline
from csc_tpu_torch.props import props_init

import test_torch_exact_host
import test_torch_kernel_host
from torch_edge_cases import ring48  # noqa: F401
from test_torch_encode_kernel_host import I32, I64, P, _build, _k3_host

K = 1024


def mixed(level):
    rng = np.random.default_rng(11)
    text = corpus.torch_python_text(512 * K)
    exe = corpus.torch_library_exe()
    r = rng.integers(0, 256, 8 * K, dtype=np.uint8).tobytes()
    d = bytearray(text[:48 * K])
    d += r                                   # across the ring's end, 50 KB
    d += text[100 * K:108 * K]
    d += r[:2 * K] + np.random.default_rng(100).integers(
        0, 256, 6 * K, dtype=np.uint8).tobytes()
    d += text[120 * K:152 * K]
    d += exe[len(exe) // 3:len(exe) // 3 + 24 * K]
    d += corpus.dlt_ramp(16 * K)
    d += text[200 * K:200 * K + (200 * K - len(d) - 4321)]
    return ("mixed", props_init(40 * K, level), bytes(d))


def chunks(level):
    p = props_init(K, level)
    p.raw_blocksize = 40 * K
    return ("chunks", p, corpus.repetitive(80 * K, 3))


def _h2(b0, b1):
    return ((b0 | (b1 << 8)) * 65521) & 0x3FFF


def _probed(block, lo=100):
    """A position of a block whose HASH2 the duplicate probe takes."""
    return next(i for i in range(lo, len(block) - 40)
                if _h2(block[i], block[i + 1]) % 16 == 0)


def quirks(level):
    w = 36 * K
    rng = np.random.default_rng(29)
    d = bytearray(corpus.torch_python_text(256 * K)[:128 * K])

    def rnd(n):
        return bytearray(rng.integers(0, 256, n, dtype=np.uint8).tobytes())

    def word(n):
        return bytes(rng.integers(97, 123, n, dtype=np.uint8).tobytes())
    # a source 5 bytes before the first ring end (hashed with a zero past
    # it), probed from 40960: the ring's end cuts it to 5 bytes
    b2 = rnd(8 * K)
    i2 = _probed(b2)
    b2[i2 + 5] = 0
    d[w - 5:w + 14] = b2[i2:i2 + 19]
    d[40 * K:48 * K] = rnd(8 * K)
    d[48 * K:56 * K] = b2
    # position 65535 ends a sub-block of lap 2: its hashes read the
    # previous lap's bytes, which the string at 60000 and 68000 repeats
    e = 64 * K
    s = bytes([d[e - 1]]) + bytes(d[e - w:e - w + 5]) + word(40)
    d[60000:60000 + len(s)] = s
    d[68000:68000 + len(s)] = s
    # HT2 at distance 700 == the ring position, from the third lap's start
    s2 = word(40)
    d[2 * w:2 * w + 40] = s2
    d[2 * w + 700:2 * w + 740] = s2
    # a BAD run ending at 81920 with a probed block's first 10 bytes, and
    # its next 9 in the previous lap at 90112 - w: the probe from 90112
    # of the block at 98304 reads them past its frontier
    b3 = rnd(8 * K)
    i3 = _probed(b3)
    r0 = rnd(8 * K)
    r0[-10:] = b3[i3:i3 + 10]
    d[80 * K:88 * K] = r0
    d[96 * K:104 * K] = b3
    d[88 * K - w:88 * K - w + 9] = b3[i3 + 10:i3 + 19]
    p = props_init(26 * K, level)
    p.TXTFilter = 0
    return ("quirks", p, bytes(d))


# ------------------------------------------------------- the g++ builds
_HOSTS = {
    "k1": ("decode_k1_host.cpp", "csc_k1_host",
           [P, I64, P, I64, P, I32, P, I32, P, I64, I64, P, P, I32, I64, P,
            I32]),
    "k3": ("encode_k3_host.cpp", "csc_k3_host",
           [P, P, P, P, I64, P, I64, P, I64, P, P, I32, P, I32, I64, P, P,
            I32]),
    "k5": ("encode_k5_host.cpp", "csc_k5_host",
           [P, I64, P, I32, P, P, I32, I32, I32, I32, P, P, P, P, I64, I64,
            P, P, I32]),
}


def host_builds(tmp, kernels=("k1", "k3", "k5")):
    """The g++ builds of `kernels` of K1, K3 and K5 (csc_k1_host,
    csc_k3_host, csc_k5_host) in `tmp`, in that order; at -O0, since the
    harnesses run a few streams and K1's takes 30 s to build at -O2."""
    return tuple(_build(tmp, *_HOSTS[k], opt="-O0") for k in _HOSTS
                 if k in kernels)


def _tensors(arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def k5_host(fn, *args):
    """parse_k5(*args) from K5's g++ build, as CPU tensors."""
    return _tensors(test_torch_exact_host.k5_host(fn, args))


def k3_host(fn, kk, aa, bb, cc, *shapes):
    """code_k3's outputs from K3's g++ build, as CPU tensors."""
    return _tensors(_k3_host(fn, (kk, aa, bb, cc), *shapes))


def k1_host(fn, rc, bc, rc_ends, bc_ends, wnd_size, max_steps, max_blocks):
    """decode_k1's outputs from K1's g++ build, as CPU tensors."""
    return _tensors(test_torch_kernel_host._host(
        SimpleNamespace(csc_k1_host=fn),
        *(np.ascontiguousarray(t.numpy()) for t in (rc, bc, rc_ends,
                                                    bc_ends)),
        wnd_size, max_steps, max_blocks))


def use_host_builds(monkeypatch, builds, kernels=("k1", "k3", "k5")):
    """Run the pipeline's `kernels` of K1, K3 and K5 on CPU tensors
    through their g++ builds (the others stay plain)."""
    k1, k3, k5 = builds
    if "k1" in kernels:
        monkeypatch.setattr(pipeline, "decode_k1",
                            lambda *a: k1_host(k1, *a))
    if "k3" in kernels:
        monkeypatch.setattr(pipeline, "code_k3",
                            lambda *a: k3_host(k3, *a))
    if "k5" in kernels:
        monkeypatch.setattr(pipeline, "parse_k5",
                            lambda *a: k5_host(k5, *a))


def gxx_k1_k3(monkeypatch, tmp):
    """The pipeline's K1 and K3 on CPU tensors through their g++ builds
    (made in tmp), for a test whose subject is another stage:
    test_torch_kernel_host.py, test_torch_k3_edges.py and
    test_torch_encode_kernel_host.py hold the builds to the plain
    versions, which take minutes on these streams."""
    k1, k3 = host_builds(tmp, ("k1", "k3"))
    use_host_builds(monkeypatch, (k1, k3, None), ("k1", "k3"))


def _memo_key(a):
    """A kernel argument as a key: a tensor by its dtype, shape and bytes,
    K6's binary tree (exact_ap_scan.BT) by its size, bits and cycles."""
    if torch.is_tensor(a):
        return a.dtype, tuple(a.shape), a.numpy().tobytes()
    if isinstance(a, exact_ap_scan.BT):
        return "BT", a.size, a.bits, a.cyc
    return a


def memo_kernels(monkeypatch, names=("parse_k5", "code_k3")):
    """Make the pipeline's kernels `names` (K5 and K3 by default) give a
    call on inputs they have seen that call's outputs (their outputs
    depend on their inputs alone), so a test can drive one stream through
    several entry points for the cost of one parse; returns the list of
    the calls that ran."""
    ran = []
    for name in names:
        real, cache = getattr(pipeline, name), {}

        def call(*args, _real=real, _cache=cache, _name=name, **kw):
            key = tuple(_memo_key(a) for a in args) + tuple(sorted(kw.items()))
            if key not in _cache:
                ran.append(_name)
                _cache[key] = _real(*args, **kw)
            return _cache[key]
        monkeypatch.setattr(pipeline, name, call)
    return ran


def dict_lt_input(level):
    """corpus.encode_cases' `dict_lt_input`: 40 KB under a 32 KB
    dictionary."""
    case = corpus.encode_cases(level, n=1024, seed=71)[-1]
    assert case[0] == "dict_lt_input"
    return case


def encode_both(cases, monkeypatch):
    """`cases`, each longer than its dictionary, through encode_batch
    under the exact parse and under the fast parse (which routes them to
    the exact one), one K5 and one K3 call for both (memo_kernels): each
    stream golden's bytes under both, which golden's decoder reads back.
    Returns (the streams, the K5 call's on_stage values: k5_args,
    k5_out)."""
    from csc_tpu.golden.api import decompress_stream
    from csc_tpu.golden.encoder import encode_stream as golden_encode
    props, datas = [c[1] for c in cases], [c[2] for c in cases]
    assert all(len(d) > p.dict_size for p, d in zip(props, datas))
    assert [pl.parse for pl in pipeline.plan_streams(props, datas)] \
        == ["exact"] * len(cases)
    ran = memo_kernels(monkeypatch)
    seen = {}
    cpu = torch.device("cpu")
    exact = pipeline.encode_batch(props, datas, device=cpu, parse="exact",
                                  on_stage=lambda stage, **v: seen.update(v))
    fast = pipeline.encode_batch(props, datas, device=cpu)
    assert ran == ["parse_k5", "code_k3"]
    for (name, p, data), e, f in zip(cases, exact, fast):
        assert f == e == golden_encode(p, data), name
        assert decompress_stream(p, e, 0) == data, name
    return exact, seen


def check_dict_lt_input(level, monkeypatch, tmp):
    """corpus.encode_cases' `dict_lt_input` at `level` through the plain
    K5 and K3 (encode_both: golden's bytes under both parses, golden's
    decoder), then the port's decode_batch through K1's g++ build."""
    k1 = host_builds(tmp, ("k1",))[0]
    case = dict_lt_input(level)
    outs, _ = encode_both([case], monkeypatch)
    use_host_builds(monkeypatch, (k1, None, None), ("k1",))
    assert pipeline.decode_batch([case[1]], outs,
                                 device=torch.device("cpu")) == [case[2]]
