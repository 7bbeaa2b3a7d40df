"""Codec test inputs: the parity batch that holds each kernel against its
plain version, built from a text source, an executable and a seed.

Every case is a (name, props, data) triple; `encode` turns cases into raw
streams with this package's encode_batch.  The kinds cover each path of
the codec: LZ text at m1 and m2, the EXE filter, BAD and ENTROPY blocks,
a DT_DLT ramp (CompressRLE, fused inverse delta), chunk resets, a
dictionary smaller than the input, and a stream to corrupt.
"""
import glob
import os

import numpy as np

from .props import props_init


def torch_library_exe():
    """The bytes of torch/lib/libc10.so: an x86 executable present on
    every machine that runs this package."""
    import torch
    path = os.path.join(os.path.dirname(torch.__file__), "lib", "libc10.so")
    with open(path, "rb") as f:
        return f.read()


def _torch_python_paths():
    """(torch's directory, the paths of its .py sources in sorted
    order)."""
    import torch
    tdir = os.path.dirname(torch.__file__)
    return tdir, sorted(glob.glob(os.path.join(tdir, "**", "*.py"),
                                  recursive=True))


def torch_python_text(limit):
    """Up to `limit` bytes of the .py sources of the installed torch
    package, in a fixed order: English-like text (the analyzer types it
    DT_ENGTXT) present on every machine that runs this package."""
    parts, total = [], 0
    for f in _torch_python_paths()[1]:
        with open(f, "rb") as fh:
            parts.append(fh.read())
        total += len(parts[-1])
        if total >= limit:
            break
    return b"".join(parts)[:limit]


def torch_python_files(count):
    """{path relative to torch's directory: bytes} of the first `count`
    .py sources of the installed torch package, in the order
    torch_python_text reads them."""
    tdir, paths = _torch_python_paths()
    files = {}
    for f in paths[:count]:
        with open(f, "rb") as fh:
            files[os.path.relpath(f, tdir)] = fh.read()
    return files


def dlt_ramp(n):
    """A 4-channel ramp the analyzer types DT_DLT
    (tests/test_pallas_decode.py:118-126)."""
    ch = np.arange(n // 4, dtype=np.int64)
    data = np.zeros(n // 4 * 4, np.uint8)
    data[0::4] = (ch * 3) & 0xFF
    data[1::4] = (ch * 5 + 1) & 0xFF
    data[2::4] = (ch * 7 + 2) & 0xFF
    data[3::4] = 200
    return data.tobytes()


def words(n, seed):
    """Seeded word salad: text with both literals and matches."""
    rng = np.random.default_rng(seed)
    vocab = [b"the", b"quick", b"brown", b"compression", b"window",
             b"entropy", b"coder", b"range", b"match", b"finder", b"stream",
             b"block", b"literal", b"decode", b"\n", b"of", b"a", b"42"]
    out = bytearray()
    while len(out) < n:
        out += vocab[int(rng.integers(len(vocab)))] + b" "
    return bytes(out[:n])


def repetitive(n, seed):
    """Long-match text: few coded bits per byte, so cheap to decode in
    lockstep even at sizes past the smallest dictionary (32 KB)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += b"window %d of the csc stream; " % int(rng.integers(8)) * 12
    return bytes(out[:n])


def _props(level, dict_size, filters):
    p = props_init(dict_size, level)
    if not filters:
        p.DLTFilter = p.EXEFilter = p.TXTFilter = 0
    return p


def parity_cases(text, exe, n, seed, chunk=8192, big=64 * 1024):
    """The parity batch: eight valid streams of about n bytes (8 KB of
    random bytes, `big` for the dict < output case) and, last, the one
    to corrupt with `flip`.

    text/exe: source bytes (at least 4n / n long); chunk: raw_blocksize
    of the multichunk case, whose output is 2 * chunk + 100 bytes so the
    coder re-primes twice."""
    rng = np.random.default_rng(seed)
    off = int(rng.integers(0, max(len(text) - 4 * n, 1)))
    t1, t2, t3 = (text[off + k * n:off + (k + 1) * n] for k in range(3))
    multi = repetitive(2 * chunk + 100, seed + 1)
    p_multi = _props(1, len(multi), False)
    p_multi.raw_blocksize = chunk
    cases = [
        ("m1_text", _props(1, n, False), t1),
        ("m2_text", _props(2, n, True), t2),
        ("exe", _props(2, n, True), exe[len(exe) // 2:len(exe) // 2 + n]),
        # the analyzer types 8 KB of random bytes DT_BAD, and ten
        # symbols spread evenly DT_ENTROPY
        ("random", _props(1, 8192, True),
         rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()),
        ("entropy", _props(1, 640, True),
         (rng.integers(0, 10, 640, dtype=np.uint8) * 7 + 65).tobytes()),
        ("dlt_ramp", _props(2, n, True), dlt_ramp(n)),
        ("multichunk", p_multi, multi),
        # props_init clamps the dict to >= 32 KB: the output outgrows it
        ("dict_lt_output", _props(2, big // 4, False),
         repetitive(big, seed)),
        ("flipped", _props(1, n, False), t3),
    ]
    return cases


def encode_cases(level, n=2048, seed=0):
    """The encode case set at one level: text, an EXE slice, 8 KB of
    random bytes (BAD), ENTROPY, a DLT ramp, a multichunk stream (1 KB
    raw blocks) and, last, a dictionary smaller than its input."""
    rng = np.random.default_rng(seed)
    text = torch_python_text(64 * 1024)
    exe = torch_library_exe()

    def p(size, filters=True, raw_blocksize=None):
        q = _props(level, size, filters)
        if raw_blocksize:
            q.raw_blocksize = raw_blocksize
        return q
    return [
        ("text", p(n, False), text[:n]),
        ("exe", p(n), exe[len(exe) // 2:len(exe) // 2 + n]),
        ("random", p(8192), rng.integers(0, 256, 8192,
                                         dtype=np.uint8).tobytes()),
        ("entropy", p(640), (rng.integers(0, 10, 640, dtype=np.uint8) * 7
                             + 65).tobytes()),
        ("dlt", p(768), dlt_ramp(768)),
        ("multichunk", p(3000, False, 1024), repetitive(3000, seed + 2)),
        ("dict_lt_input", p(8000, False), repetitive(40 * 1024, seed + 3)),
    ]


def encode(cases, device):
    """Raw streams (no property header) of a list of cases, encoded with
    this package's encode_batch on `device`."""
    from .ops.pipeline import encode_batch
    return encode_batch([c[1] for c in cases], [c[2] for c in cases],
                        device=device)


def flip(blob):
    """The stream with one byte in its middle inverted."""
    b = bytearray(blob)
    b[len(b) // 2] ^= 0xFF
    return bytes(b)
