"""The port's index trailer (csc_tpu_torch.archiver.index), each case
built from a synthetic FileIndex, always coded by the exact m2 parse: an
index of LZ runs is coded into csc_tpu's bytes (its golden encoder's)
and reads back on both sides; an index with a DT_BAD run (random
fragment records), which the fast parse took before the exact parse did,
is coded into csc_tpu's bytes too, silently, and reads back on both
sides.  An index over the trailer's dictionary is coded into csc_tpu's
bytes as well (test_torch_exact_ring_host.py)."""
import io
import struct

import numpy as np
import torch

from csc_tpu.archiver import index as j_index
from csc_tpu_torch.archiver import index

CPU = torch.device("cpu")


def _entries(mod, n, frags, rng=None):
    """n entries of `frags` fragments each: random fragment records with
    an rng (8 KB of them make a block the analyzer types DT_BAD), else
    the records of one 1000-byte fragment a file."""
    fi = {}
    for k in range(n):
        fe = mod.FileEntry(edate=20260101000000 + k, esize=1000 * k,
                           eattr=ord("u") + (0o100644 << 8))
        fe.frags = [mod.Frag(*(int(v) for v in (
            rng.integers(0, 2 ** 32), rng.integers(0, 2 ** 32),
            rng.integers(0, 2 ** 63), rng.integers(0, 2 ** 63),
            rng.integers(0, 2 ** 63)))) if rng else
            mod.Frag(k, 0x1234 + k, 1000 * k, 1000, 0)
            for _ in range(frags)]
        fi[f"dir/file{k:04d}.txt"] = fe
    abi = {bid: mod.ArchiveBlocks(blocks=[(24 + 1000 * bid, 1000)])
           for bid in range(n)}
    return fi, abi


def _trailer(fi, abi):
    f = io.BytesIO(b"\0" * index.HEADER_SIZE)
    index.write_trailer(f, fi, abi, CPU)
    return f


def _csc_tpus(fi, abi):
    f = io.BytesIO(b"\0" * j_index.HEADER_SIZE)
    j_index.write_trailer(f, fi, abi)
    return f.getvalue()


def _same(a, b):
    assert index.pack_index(*a) == index.pack_index(*b)


def test_lz_index_is_golden_bytes_and_reads_back():
    fi, abi = _entries(index, 12, 1)
    j_fi, j_abi = _entries(j_index, 12, 1)
    f = _trailer(fi, abi)
    assert f.getvalue() == _csc_tpus(j_fi, j_abi)
    assert index.check_header(f)
    _same(index.read_trailer(f, CPU), (fi, abi))
    _same(j_index.read_trailer(f), (fi, abi))


def test_refused_index_takes_the_fast_parse(capsys):
    """Now the exact parse's, with golden's bytes and nothing on
    stderr."""
    fi, abi = _entries(index, 1, 255, np.random.default_rng(2))
    j_fi, j_abi = _entries(j_index, 1, 255, np.random.default_rng(2))
    f = _trailer(fi, abi)
    assert capsys.readouterr().err == ""
    assert f.getvalue() == _csc_tpus(j_fi, j_abi)
    _same(index.read_trailer(f, CPU), (fi, abi))
    _same(j_index.read_trailer(f), (fi, abi))
    f.seek(8)
    _, _, raw_size = struct.unpack("<QII", f.read(16))
    assert raw_size == len(index.pack_index(fi, abi)) > 8192
