"""The port's `csarc a --backend=cpu -m2 --parse=exact` (the plain version
of K5) against csc_tpu's `csarc a --backend=tpu -m2` under
CSC_ENCODE_PARSE=exact: on a text-only tree (one solid task of LZ runs)
byte-identical archives, both the reference encoder's bytes, with no
golden fallback inside csc_tpu; on a tree whose task is 8 KB of random
bytes (a DT_BAD run, which csc_tpu hands to its golden encoder)
byte-identical archives too, and the archive restores.  The trailer
always takes the exact parse."""
import numpy as np

from csc_tpu_torch.archiver import csarc

from torch_archiver_trees import (TEXT_FILES, archive_both, run_in,
                                  tree_bytes)


def test_exact_m2_archive_equals_csc_tpus(tmp_path, monkeypatch):
    _, got, want = archive_both(tmp_path, monkeypatch, TEXT_FILES,
                                ["-m2", "--parse=exact"],
                                {"CSC_ENCODE_PARSE": "exact"})
    assert got == want


def test_exact_parse_refuses_a_bad_run(tmp_path, monkeypatch):
    """Once refused, now taken: the task with a BAD run is coded by the
    exact parse into golden's bytes, as csc_tpu's golden fallback codes
    it."""
    rng = np.random.default_rng(3)
    files = {"r.bin": rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()}
    arc, got, want = archive_both(tmp_path, monkeypatch, files,
                                  ["-m2", "--parse=exact"],
                                  {"CSC_ENCODE_PARSE": "exact"}, fallbacks=1)
    assert got == want
    out = tmp_path / "out"
    out.mkdir()
    assert run_in(out, csarc.main, ["x", "--backend=cpu", arc])[0] == 0
    assert tree_bytes(str(out)) == files
