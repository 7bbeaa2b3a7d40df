"""The port's `csarc a --backend=cpu -m1` (the plain versions of K2 and
K3) against csc_tpu's `csarc a --backend=tpu -m1` on its fast path
(CSC_ENCODE_PARSE=fast CSC_ENCODE_BITS=scan, as csc_tpu's own CPU tests
run it), on a tree of two solid tasks: the archives are byte-identical
(task streams, archive blocks, and the index trailer that the port codes
with its exact m2 parse and csc_tpu with its golden encoder), with no
golden fallback inside csc_tpu; csc_tpu's extractor restores the port's
archive.  -m2 is in test_torch_archiver_m2.py."""
import os

from csc_tpu.archiver import csarc as j_csarc

from torch_archiver_trees import TWO_TASK_FILES, archive_both, tree_bytes

FAST = {"CSC_ENCODE_PARSE": "fast", "CSC_ENCODE_BITS": "scan"}


def test_m1_archive_equals_csc_tpus(tmp_path, monkeypatch):
    ours, got, want = archive_both(tmp_path, monkeypatch, TWO_TASK_FILES,
                                   ["-m1"], FAST)
    assert got == want
    with open(ours, "rb") as f:
        _, abi = j_csarc.read_trailer(f)
    assert len(abi) == 2
    out = tmp_path / "out"
    out.mkdir()
    assert j_csarc.main(["x", "-o", str(out), ours]) == 0
    assert j_csarc.main(["t", ours]) == 0
    assert tree_bytes(out) == {os.path.normpath(k): v
                               for k, v in TWO_TASK_FILES.items()}
