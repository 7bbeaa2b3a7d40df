"""The exact parse past its dictionary at sizes the lockstep plain
versions cannot afford on a CPU: the port's entry points with K5, K3 and
K1 on CPU tensors through their g++ builds (torch_ring_cases), byte for
byte against the golden encoder (csc_tpu.golden.encoder.encode_stream,
whose LZ window is a ring of the dictionary's size).  At m1 and m2:
`encode_batch` of torch_ring_cases' `mixed` (200 KB under a 50 KB
dictionary, four laps off the 8 KB grid, with BAD, EXE and DLT runs and
a duplicate-probe hit across a wrap), `chunks` (two raw chunks under a 32
KB dictionary) and `quirks` (each ring rule made visible) under the fast
parse, which routes them to the exact one; each stream decodes with the
port's decode_batch and with the golden decoder.  The CLI past `-d`:
`c -m1 -d 1k --backend cpu` of corpus.encode_cases' 40 KB
`dict_lt_input` text, filters off, equals csc_tpu's `c -m1 -d 1k` (its
golden backend) and `d` reads it back (K5's plain version parses that
stream in test_torch_exact_ring.py).  And the archive index's trailer
past its 266 KB dictionary: `index.write_trailer` writes csc_tpu's
trailer (its golden encoder's bytes) and `index.read_trailer` reads it
back."""
import io
import shutil

import pytest
import torch

from csc_tpu import cli as j_cli
from csc_tpu.archiver import index as j_index
from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch import cli, constants
from csc_tpu_torch.archiver import index
from csc_tpu_torch.ops import pipeline
from csc_tpu_torch.props import props_init

import torch_ring_cases as ring

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return ring.host_builds(tmp_path_factory.mktemp("ring_host"))


@pytest.mark.parametrize("level", [1, 2])
def test_ring_streams_are_golden(builds, monkeypatch, level):
    ring.use_host_builds(monkeypatch, builds)
    cases = [ring.mixed(level), ring.chunks(level), ring.quirks(level)]
    props = [c[1] for c in cases]
    datas = [c[2] for c in cases]
    assert all(len(d) > p.dict_size for p, d in zip(props, datas))
    btypes = {}

    def note(stage, **v):
        if stage == "k5":
            for j, size in enumerate(v["k5_args"][2].tolist()):
                btypes[size] = v["k5_out"][5][j].tolist()
    outs = pipeline.encode_batch(props, datas, device=CPU, on_stage=note)
    for (name, p, data), out in zip(cases, outs):
        assert out == golden_encode(p, data), name
        assert decompress_stream(p, out, 0) == data, name
    assert pipeline.decode_batch(props, outs, device=CPU) == datas
    assert pipeline.decode_batch(props, outs, out_sizes=[len(d) for d in
                                                         datas],
                                 device=CPU) == datas
    bad, normal = constants.DT_BAD, constants.DT_NORMAL
    # mixed: block 6 (across the ring's end) stays BAD; block 8 repeats
    # its first 2 KB, and the probe's hit across the wrap re-types it
    assert btypes[len(datas[0])][6:9] == [
        bad, constants.DT_ENGTXT, normal]
    # quirks: the block at 49152 stays BAD (the ring's end cuts the
    # probe's source), the block at 98304 is re-typed (the probe reads
    # the previous lap's bytes past its frontier)
    q = btypes[len(datas[2])]
    assert q[6] == bad and q[12] == normal


def test_cli_past_d_is_golden(builds, monkeypatch, tmp_path):
    ring.use_host_builds(monkeypatch, builds)
    _, p, data = ring.dict_lt_input(1)
    off = ["--fdelta0", "--fexe0", "--ftxt0"]
    src, ours, ref, back = (str(tmp_path / n) for n in (
        "in.bin", "ours.csc", "ref.csc", "back.bin"))
    with open(src, "wb") as f:
        f.write(data)
    assert cli.main(["c", "-m", "1", "-d", "1k", "--backend", "cpu"] + off
                    + [src, ours]) == 0
    assert j_cli.main(["c", "-m", "1", "-d", "1k"] + off + [src, ref]) == 0
    with open(ours, "rb") as f:
        blob = f.read()
    with open(ref, "rb") as f:
        assert blob == f.read()
    assert blob[10:] == golden_encode(p, data)      # dict_lt_input's stream
    assert cli.main(["d", "--backend", "cpu", ours, back]) == 0
    with open(back, "rb") as f:
        assert f.read() == data


def _index(mod, n):
    fi = {}
    for k in range(n):
        fe = mod.FileEntry(edate=20260101000000 + k, esize=64,
                           eattr=ord("u") + (0o100644 << 8))
        fe.frags = [mod.Frag(k, 0x1234 + k, 64 * k, 64, 0)]
        fi[f"src/module_{k // 64:03d}/generated_file_{k:05d}.txt"] = fe
    abi = {bid: mod.ArchiveBlocks(blocks=[(24 + 64 * bid, 64)])
           for bid in range(n)}
    return fi, abi


def test_trailer_past_the_dictionary_is_csc_tpus(builds, monkeypatch):
    """Replaces the refusal of an index over the trailer's dictionary."""
    ring.use_host_builds(monkeypatch, builds)
    fi, abi = _index(index, 2200)
    raw = index.pack_index(fi, abi)
    assert len(raw) > props_init(index.INDEX_DICT, 2).dict_size
    f = io.BytesIO(b"\0" * index.HEADER_SIZE)
    index.write_trailer(f, fi, abi, CPU)
    g = io.BytesIO(b"\0" * j_index.HEADER_SIZE)
    j_index.write_trailer(g, *_index(j_index, 2200))
    assert f.getvalue() == g.getvalue()
    back = index.read_trailer(f, CPU)
    assert index.pack_index(*back) == raw
