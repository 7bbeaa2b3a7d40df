"""The port's archiver (csc_tpu_torch.archiver) against csc_tpu's: its pure
copies (adler32, adler32_combine, ispath, decimal_time, unix_time,
_autosplit_tasks, _simulate_write_blocks, pack_index / unpack_index)
equal their originals on numpy-seeded random inputs; the command line's
options; `--backend=cuda` without a card raises; and an `a` / `x` round
trip through the port loads no jax and nothing of csc_tpu."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from csc_tpu.archiver import adler32 as j_adler32
from csc_tpu.archiver import csarc as j_csarc
from csc_tpu.archiver import index as j_index
from csc_tpu_torch.archiver import adler32, csarc, index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(4)

_PROBE = r"""
import os, sys
from csc_tpu_torch.archiver.csarc import main
root = sys.argv[1]
os.makedirs(os.path.join(root, "src", "sub"))
files = {"a.txt": b"abcabcabd the quick brown window " * 40,
         "sub/b.bin": bytes(i % 7 for i in range(3000))}
for name, data in files.items():
    with open(os.path.join(root, "src", name), "wb") as f:
        f.write(data)
os.chdir(os.path.join(root, "src"))
arc = os.path.join(root, "p.csa")
assert main(["a", "-r", "--backend=cpu", arc, "."]) == 0
os.makedirs(os.path.join(root, "out"))
assert main(["x", "--backend=cpu", "-o", os.path.join(root, "out"),
             arc]) == 0
for name, data in files.items():
    with open(os.path.join(root, "out", name), "rb") as f:
        assert f.read() == data, name
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "csc_tpu")))
"""


@pytest.mark.parametrize("seed", SEEDS)
def test_adler32_equals_csc_tpus(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 5552, 5553, int(rng.integers(1, 70000))):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        value = int(rng.integers(0, 2 ** 32))
        assert adler32.adler32(data) == j_adler32.adler32(data)
        assert (adler32.adler32(data, value)
                == j_adler32.adler32(data, value))


@pytest.mark.parametrize("seed", SEEDS)
def test_adler32_combine_equals_csc_tpus(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        a = rng.integers(0, 256, int(rng.integers(0, 3000)),
                         dtype=np.uint8).tobytes()
        b = rng.integers(0, 256, int(rng.integers(0, 3000)),
                         dtype=np.uint8).tobytes()
        c1, c2 = adler32.adler32(a), adler32.adler32(b)
        got = adler32.adler32_combine(c1, c2, len(b))
        assert got == j_adler32.adler32_combine(c1, c2, len(b))
        assert got == adler32.adler32(a + b)
        x, y = (int(v) for v in rng.integers(0, 2 ** 32, 2))
        n = int(rng.integers(0, 2 ** 40))
        assert (adler32.adler32_combine(x, y, n)
                == j_adler32.adler32_combine(x, y, n))


@pytest.mark.parametrize("seed", SEEDS)
def test_ispath_equals_csc_tpus(seed):
    rng = np.random.default_rng(seed)
    pat_chars, path_chars = list("ab/*?.A"), list("abB/.")
    matched = 0
    for _ in range(2000):
        a = "".join(rng.choice(pat_chars, int(rng.integers(0, 7))))
        b = "".join(rng.choice(path_chars, int(rng.integers(0, 9))))
        got = csarc.ispath(a, b)
        assert got == j_csarc.ispath(a, b), (a, b)
        matched += got
    assert matched > 50


@pytest.mark.parametrize("seed", SEEDS)
def test_decimal_and_unix_time_equal_csc_tpus(seed):
    rng = np.random.default_rng(seed)
    times = [-1, 0, 59, 86399, 951782400, 1500000000, 4102444800] + [
        int(t) for t in rng.integers(0, 2 ** 33, 500)]
    for t in times:
        d = csarc.decimal_time(t)
        assert d == j_csarc.decimal_time(t), t
        assert csarc.unix_time(d) == j_csarc.unix_time(d), d
    dates = [0, -5] + [int(d) for d in rng.integers(1, 10 ** 14, 500)]
    for d in dates:
        assert csarc.unix_time(d) == j_csarc.unix_time(d), d


def _random_tasks(rng, mod):
    tasks = []
    for _ in range(int(rng.integers(1, 6))):
        t = mod.MainTask()
        for k in range(int(rng.integers(1, 6))):
            size = int(rng.choice([0, int(rng.integers(1, 5000)),
                                   int(rng.integers(5000, 30000))]))
            t.push_back(f"f{k}", int(rng.integers(0, 100)), size,
                        entry_name=f"e{k}")
        tasks.append(t)
    return tasks


def _task_rows(tasks):
    return [[(fb.filename, fb.off, fb.size, fb.posblock, fb.checksum,
              fb.entry_name) for fb in t.filelist] + [t.total_size]
            for t in tasks]


@pytest.mark.parametrize("seed", SEEDS)
def test_autosplit_tasks_equals_csc_tpus(seed):
    for k in range(100):
        cap = int(np.random.default_rng((seed, k)).integers(1000, 20000))
        ours = csarc._autosplit_tasks(_random_tasks(
            np.random.default_rng((seed, k)), csarc), cap)
        ref = j_csarc._autosplit_tasks(_random_tasks(
            np.random.default_rng((seed, k)), j_csarc), cap)
        assert _task_rows(ours) == _task_rows(ref)
        assert all(t.total_size <= cap for t in ours)


def _memio_stream(rng, bsize):
    """A props header and MemIO blocks (csc_memio.cpp): full blocks of
    bsize behind a flag byte, partial ones behind a flag and a 3-byte
    size."""
    out = bytearray(10)
    for _ in range(int(rng.integers(0, 40))):
        if rng.integers(0, 2):
            out.append(0xC0)
            out += bytes(bsize)
        else:
            size = int(rng.integers(0, bsize))
            out += bytes([0x80, size >> 16, (size >> 8) & 0xFF, size & 0xFF])
            out += bytes(size)
    return bytes(out)


@pytest.mark.parametrize("seed", SEEDS)
def test_simulate_write_blocks_equals_csc_tpus(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        bsize = int(rng.choice([1000, 65536, 300000, 1200000]))
        stream = _memio_stream(rng, bsize)
        ours = csarc._simulate_write_blocks(stream, bsize)
        assert ours == j_csarc._simulate_write_blocks(stream, bsize)
        assert sum(ours) == len(stream)


def _random_index(rng, mod):
    fi, abi = {}, {}
    for k in range(int(rng.integers(0, 12))):
        name = "".join(rng.choice(list("abc/._é"), int(rng.integers(1, 20))))
        fe = mod.FileEntry(edate=int(rng.integers(-1, 10 ** 14)),
                           esize=int(rng.integers(0, 2 ** 40)),
                           eattr=int(rng.integers(0, 2 ** 31)))
        for _ in range(int(rng.integers(0, 4))):
            fe.frags.append(mod.Frag(*(int(v) for v in (
                rng.integers(0, 2 ** 32), rng.integers(0, 2 ** 32),
                rng.integers(0, 2 ** 63), rng.integers(0, 2 ** 63),
                rng.integers(0, 2 ** 63)))))
        fi[name + str(k)] = fe
    for bid in rng.permutation(int(rng.integers(0, 8))):
        abi[int(bid)] = mod.ArchiveBlocks(blocks=[
            (int(rng.integers(0, 2 ** 63)), int(rng.integers(0, 2 ** 63)))
            for _ in range(int(rng.integers(0, 5)))])
    return fi, abi


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_and_unpack_index_equal_csc_tpus(seed):
    for k in range(50):
        fi, abi = _random_index(np.random.default_rng((seed, k)), index)
        j_fi, j_abi = _random_index(np.random.default_rng((seed, k)),
                                    j_index)
        raw = index.pack_index(fi, abi)
        assert raw == j_index.pack_index(j_fi, j_abi)
        ours = index.unpack_index(raw)
        ref = j_index.unpack_index(raw)
        assert index.pack_index(*ours) == j_index.pack_index(*ref) == raw
        assert sorted(ours[0]) == sorted(ref[0])
        assert {b: a.blocks for b, a in ours[1].items()} == {
            b: a.blocks for b, a in ref[1].items()}
    assert (index.MAGIC_DATE, index.HEADER_SIZE) == (j_index.MAGIC_DATE,
                                                     j_index.HEADER_SIZE)


def test_options():
    arc = csarc.parse_args(["-m3", "-d64k", "-r", "-f", "-v", "-t4",
                            "-oout", "-p2", "--parse=exact", "arc.csa",
                            "a", "b"])
    assert (arc.level, arc.dict_size, arc.recurse, arc.overwrite,
            arc.verbose, arc.to_dir, arc.split_count, arc.parse,
            arc.backend, arc.arcname, arc.filenames) == (
        3, 64 * 1024, True, True, True, "out", 2, "exact", "cuda",
        "arc.csa", ["a", "b"])
    assert csarc.parse_args(["--backend", "x.csa"]).backend == "cuda"
    assert csarc.parse_args(["--backend=cpu", "x.csa"]).backend == "cpu"
    assert csarc.parse_args(["x.csa"]).parse == "fast"
    for bad in (["--backend=tpu", "x.csa"], ["--parse=golden", "x.csa"],
                ["-q", "x.csa"], ["-f"]):
        with pytest.raises(SystemExit):
            csarc.parse_args(bad)


def test_cuda_backend_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        csarc.main(["a", "-f", str(tmp_path / "c.csa"), str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        csarc.main(["t", "--backend", str(tmp_path / "c.csa")])
    assert not os.path.exists(tmp_path / "c.csa")


def test_round_trip_loads_no_csc_tpu_or_jax(tmp_path):
    r = subprocess.run([sys.executable, "-c", _PROBE, str(tmp_path)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
