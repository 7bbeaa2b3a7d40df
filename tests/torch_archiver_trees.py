"""Small file trees for the archiver tests, and helpers to run an
archiver's `main` inside a directory and read a tree back.

The contents are periodic or repetitive, so the plain versions (one
lockstep step a token or coded bit) code them in seconds on the CPU.
"""
import contextlib
import io
import os

# csc_tpu's test_archiver._mktree, with a smaller data.bin
CROSS_FILES = {
    "a.txt": b"hello world, this is a text file.\n" * 300,
    "b.txt": b"the quick brown fox jumps over the lazy dog\n" * 500,
    "data.bin": bytes((i * 7 + 3) & 0xFF for i in range(20000)),
    "sub/c.txt": b"nested file content here\n" * 200,
    "sub/empty": b"",
}
# two solid tasks: the .bin group closes past 64 KB at the change of
# extension (csarc.cpp:515-557), then the .txt group
TWO_TASK_FILES = {
    "data.bin": bytes((i * 7 + 3) & 0xFF for i in range(66000)),
    "a.txt": b"hello world, this is a text file.\n" * 120,
    "b.txt": b"the quick brown fox jumps over the lazy dog\n" * 150,
    "sub/c.txt": b"nested file content here\n" * 200,
    "sub/empty": b"",
}
# text only: one task, LZ runs only (the exact parse takes it)
TEXT_FILES = {
    "a.txt": b"hello world, this is a text file.\n" * 300,
    "b.txt": b"the quick brown fox jumps over the lazy dog\n" * 500,
    "sub/c.txt": b"nested file content here\n" * 200,
}


def make_tree(root, files):
    for name, content in files.items():
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(content)
    return files


def tree_bytes(root):
    """{relative path: contents} of every file under root."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.normpath(os.path.relpath(p, root))] = f.read()
    return out


def run_in(cwd, main, argv):
    """main(argv) with cwd as the working directory; (rc, stdout)."""
    old = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.chdir(old)
    return rc, buf.getvalue()


def listing(stdout):
    """{name: size} of an `l` listing (without -v)."""
    return {ln.split()[0]: ln.split()[1] for ln in stdout.splitlines()
            if ln.strip() and not ln.startswith("CSArc")}


def archive_both(tmp_path, monkeypatch, files, port_argv, env,
                 fallbacks=0):
    """The port's `a --backend=cpu` and csc_tpu's `a --backend=tpu` (under
    the environment `env`) of one tree with the same options; returns
    (the port's archive path, its bytes, csc_tpu's bytes).  csc_tpu's
    run must hand `fallbacks` tasks to its golden encoder (none by
    default)."""
    from csc_tpu.archiver import csarc as j_csarc
    from csc_tpu.ops import pipeline as j_pipeline
    from csc_tpu_torch.archiver import csarc

    src = tmp_path / "src"
    make_tree(str(src), files)
    ours, ref = str(tmp_path / "ours.csa"), str(tmp_path / "ref.csa")
    assert run_in(src, csarc.main, ["a", "-r", "--backend=cpu"] + port_argv
                  + [ours, "."])[0] == 0
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    argv = [a for a in port_argv if not a.startswith("--parse")]
    assert run_in(src, j_csarc.main, ["a", "-r", "--backend=tpu"] + argv
                  + [ref, "."])[0] == 0
    assert j_pipeline.LAST_ENCODE_FALLBACKS == fallbacks
    with open(ours, "rb") as f:
        got = f.read()
    with open(ref, "rb") as f:
        want = f.read()
    return ours, got, want
