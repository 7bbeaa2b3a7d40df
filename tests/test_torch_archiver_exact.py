"""The port's `csarc a --backend=cpu -m2 --parse=exact` (the plain version
of K5) against csc_tpu's `csarc a --backend=tpu -m2` under
CSC_ENCODE_PARSE=exact, on a text-only tree (one solid task of LZ runs):
byte-identical archives, both the reference encoder's bytes, with no
golden fallback inside csc_tpu; the trailer took the exact parse.  And
what `--parse=exact` refuses: a task with a BAD run ends `a` with an
error that names the task's first file, where csc_tpu would fall back to
its golden encoder."""
import numpy as np

from csc_tpu_torch.archiver import csarc

from torch_archiver_trees import TEXT_FILES, archive_both, make_tree, run_in


def test_exact_m2_archive_equals_csc_tpus(tmp_path, monkeypatch):
    _, got, want = archive_both(tmp_path, monkeypatch, TEXT_FILES,
                                ["-m2", "--parse=exact"],
                                {"CSC_ENCODE_PARSE": "exact"})
    assert got == want


def test_exact_parse_refuses_a_bad_run(tmp_path, capsys):
    rng = np.random.default_rng(3)
    make_tree(str(tmp_path / "src"), {
        "r.bin": rng.integers(0, 256, 8192, dtype=np.uint8).tobytes()})
    arc = tmp_path / "r.csa"
    rc, _ = run_in(tmp_path / "src", csarc.main,
                   ["a", "-r", "-m2", "--parse=exact", "--backend=cpu",
                    str(arc), "."])
    assert rc == 1
    err = capsys.readouterr().err
    assert "./r.bin" in err and "DT_BAD" in err
