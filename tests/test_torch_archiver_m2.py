"""The port's `csarc a --backend=cpu -m2` against csc_tpu's `csarc a
--backend=tpu -m2` on its fast path (CSC_ENCODE_PARSE=fast
CSC_ENCODE_BITS=scan), on a tree of two solid tasks: byte-identical
archives, no golden fallback inside csc_tpu, and the port's extractor
restores the archive; -m1 is in test_torch_archiver_fast.py."""
import os

from csc_tpu_torch.archiver import csarc

from torch_archiver_trees import TWO_TASK_FILES, archive_both, run_in, \
    tree_bytes

FAST = {"CSC_ENCODE_PARSE": "fast", "CSC_ENCODE_BITS": "scan"}


def test_m2_archive_equals_csc_tpus(tmp_path, monkeypatch):
    ours, got, want = archive_both(tmp_path, monkeypatch, TWO_TASK_FILES,
                                   ["-m2"], FAST)
    assert got == want
    out = tmp_path / "out"
    out.mkdir()
    assert run_in(out, csarc.main, ["x", "--backend=cpu", ours])[0] == 0
    assert tree_bytes(out) == {os.path.normpath(k): v
                               for k, v in TWO_TASK_FILES.items()}
