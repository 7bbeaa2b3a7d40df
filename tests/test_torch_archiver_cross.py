"""Cross extraction between the port's archiver and csc_tpu's, in
process: csc_tpu's `x` (its golden decoder) restores an archive the
port wrote with `a --backend=cpu`, the port's `x --backend=cpu` restores
one csc_tpu wrote with its default (golden) backend, `t` returns 0 on
both, `l` lists the same names and sizes, a wildcard selects files as
csc_tpu's does (ispath, csarc.cpp:17-37), mode and mtime come back, and
a corrupted coded byte makes the port's `t` return -1.  With a built
reference (the ref_build fixture), the reference csarc binary extracts
and tests the port's archive and the port extracts the reference's."""
import os
import shutil
import subprocess

import pytest

from csc_tpu.archiver import csarc as j_csarc
from csc_tpu_torch.archiver import csarc, index

from torch_archiver_trees import CROSS_FILES, listing, make_tree, run_in, \
    tree_bytes

WANT = {os.path.normpath(k): v for k, v in CROSS_FILES.items()}
MTIME = 1500000000


@pytest.fixture(scope="module")
def arcs(tmp_path_factory):
    """The tree, the port's archive of it and csc_tpu's golden one."""
    root = tmp_path_factory.mktemp("cross")
    src = root / "src"
    make_tree(str(src), CROSS_FILES)
    os.chmod(src / "a.txt", 0o640)
    os.utime(src / "a.txt", (MTIME, MTIME))
    ours, ref = str(root / "ours.csa"), str(root / "ref.csa")
    assert run_in(src, csarc.main, ["a", "-r", "-m1", "--backend=cpu",
                                    ours, "."])[0] == 0
    assert run_in(src, j_csarc.main, ["a", "-r", "-m1", ref, "."])[0] == 0
    return src, ours, ref


def test_csc_tpu_extracts_the_ports_archive(arcs, tmp_path):
    _, ours, _ = arcs
    assert j_csarc.main(["x", "-o", str(tmp_path), ours]) == 0
    assert tree_bytes(tmp_path) == WANT
    assert j_csarc.main(["t", ours]) == 0


def test_port_extracts_csc_tpus_archive(arcs, tmp_path):
    _, _, ref = arcs
    assert csarc.main(["x", "--backend=cpu", "-o", str(tmp_path), ref]) == 0
    assert tree_bytes(tmp_path) == WANT
    st = os.stat(tmp_path / "a.txt")
    assert (st.st_mode & 0o777) == 0o640
    assert abs(st.st_mtime - MTIME) < 2


def test_port_tests_both_archives(arcs):
    _, ours, ref = arcs
    assert csarc.main(["t", "--backend=cpu", ours]) == 0
    assert csarc.main(["t", "--backend=cpu", ref]) == 0


def test_listing_matches_csc_tpus(arcs):
    _, ours, ref = arcs
    for arc in (ours, ref):
        got = run_in(".", csarc.main, ["l", "--backend=cpu", arc])
        want = run_in(".", j_csarc.main, ["l", arc])
        assert got[0] == want[0] == 0
        assert listing(got[1]) == listing(want[1])
        assert {os.path.normpath(k) for k, v in listing(got[1]).items()
                if not k.endswith("/")} == set(WANT)
    got = run_in(".", csarc.main, ["l", "-v", "--backend=cpu", ours])[1]
    assert got == run_in(".", j_csarc.main, ["l", "-v", ours])[1]


def test_wildcard_selection_and_attributes(arcs, tmp_path):
    _, ours, _ = arcs
    assert csarc.main(["x", "--backend=cpu", "-o", str(tmp_path), ours,
                       "*.txt"]) == 0
    got = tree_bytes(tmp_path)
    assert got == {k: v for k, v in WANT.items() if k.endswith(".txt")}
    st = os.stat(tmp_path / "a.txt")
    assert (st.st_mode & 0o777) == 0o640
    assert abs(st.st_mtime - MTIME) < 2


def test_corrupt_coded_byte_fails_the_test(arcs, tmp_path, capsys):
    _, ours, _ = arcs
    bad = str(tmp_path / "bad.csa")
    shutil.copy(ours, bad)
    with open(bad, "rb") as f:
        _, abi = j_csarc.read_trailer(f)
    off, size = abi[0].blocks[0]
    assert off == index.HEADER_SIZE     # the task's stream, not the trailer
    with open(bad, "r+b") as f:
        f.seek(off + size // 2)
        byte = f.read(1)[0]
        f.seek(off + size // 2)
        f.write(bytes([byte ^ 0xFF]))
    assert csarc.main(["t", "--backend=cpu", bad]) == -1
    err = capsys.readouterr().err
    assert "corrupted" in err


def test_reference_extracts_and_tests_the_ports_archive(arcs, ref_build,
                                                        tmp_path):
    _, ours, _ = arcs
    binary = os.path.join(ref_build, "csarc")
    r = subprocess.run([binary, "x", "-o", str(tmp_path), ours],
                       capture_output=True)
    assert r.returncode == 0, r.stderr
    assert tree_bytes(tmp_path) == WANT
    r = subprocess.run([binary, "t", ours], capture_output=True)
    assert r.returncode == 0 and b"failed" not in r.stderr


def test_port_extracts_the_references_archive(arcs, ref_build, tmp_path):
    src, _, _ = arcs
    arc = str(tmp_path / "refbin.csa")
    r = subprocess.run([os.path.join(ref_build, "csarc"), "a", "-r", "-f",
                        arc, "."], capture_output=True, cwd=str(src))
    assert r.returncode == 0, r.stderr
    out = tmp_path / "out"
    out.mkdir()
    assert csarc.main(["x", "--backend=cpu", "-o", str(out), arc]) == 0
    assert tree_bytes(out) == WANT
