"""The port's multi-process archiver (csc_tpu_torch.parallel.dist over
torch.distributed with Gloo): two processes joined through the CSC_DIST_*
environment, as tests/test_distributed.py runs csc_tpu's, split the tasks
round-robin by rank and rank 0 writes one archive, byte-identical to the
one-process archive, which csc_tpu's extractor restores; a task one rank
cannot encode stops both, and so does an archive that exists already
(every rank looks before rank 0 creates the file); and allgather_bytes
returns every rank's payload, an empty one and ones of unequal length
included."""
import os
import socket
import subprocess
import sys

import pytest

from csc_tpu.archiver import csarc as j_csarc
from csc_tpu_torch.archiver import csarc

from torch_archiver_trees import TWO_TASK_FILES, make_tree, run_in, \
    tree_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GATHER = r"""
import sys
from csc_tpu_torch.parallel import dist
assert dist.init_distributed()
pid = dist.process_index()
payload = [b"", bytes(range(256)) * 40 + b"tail"][pid]
got = dist.allgather_bytes(payload)
dist.barrier()
assert dist.is_distributed() and dist.process_count() == 2
assert got == [b"", bytes(range(256)) * 40 + b"tail"], [len(g) for g in got]
print("ok", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ranks(argv, cwd, n=2, timeout=300):
    """Run `argv` in n processes joined by the CSC_DIST_* environment;
    returns their (returncode, stdout, stderr).  A rank still running
    after `timeout` seconds fails the test, and every rank is killed."""
    coord = f"127.0.0.1:{_free_port()}"
    procs = []
    for pid in range(n):
        env = dict(os.environ, CSC_DIST_COORD=coord, CSC_DIST_NPROCS=str(n),
                   CSC_DIST_PID=str(pid),
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    res = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            res.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return res


# csarc a in which one rank's encode raises an error other than a task's
# encode refusal (as a launch failure or an allocation would): the ranks
# are not told of it through the gather
_FAIL_ONE = r"""
import sys
from csc_tpu_torch.archiver import csarc
from csc_tpu_torch.parallel import dist


def produce(self, tasks, ids):
    if dist.process_index() == int(sys.argv[1]):
        raise RuntimeError("injected failure")
    return orig(self, tasks, ids)


orig = csarc.CSArc._produce_streams
csarc.CSArc._produce_streams = produce
sys.exit(csarc.main(sys.argv[2:]))
"""


def test_allgather_bytes_and_barrier(tmp_path):
    res = _ranks(["-c", _GATHER], str(tmp_path))
    for pid, (rc, out, err) in enumerate(res):
        assert rc == 0, err
        assert out.split() == ["ok", str(pid)]


def test_two_process_archive_equals_one_process(tmp_path):
    make_tree(str(tmp_path / "tree"), TWO_TASK_FILES)
    one, two = str(tmp_path / "one.csa"), str(tmp_path / "two.csa")
    assert run_in(tmp_path, csarc.main, ["a", "-r", "-m1", "--backend=cpu",
                                         one, "tree"])[0] == 0
    res = _ranks(["-m", "csc_tpu_torch.archiver.csarc", "a", "-r", "-m1",
                  "--backend=cpu", two, "tree"], str(tmp_path))
    for rc, out, err in res:
        assert rc == 0, err
    assert "Compressed Size" in res[0][1] and res[1][1] == ""
    with open(one, "rb") as f:
        want = f.read()
    with open(two, "rb") as f:
        assert f.read() == want
    with open(two, "rb") as f:
        _, abi = j_csarc.read_trailer(f)
    assert len(abi) == 2
    out = tmp_path / "x"
    out.mkdir()
    assert run_in(out, j_csarc.main, ["x", two])[0] == 0
    assert tree_bytes(out / "tree") == {os.path.normpath(k): v
                                        for k, v in TWO_TASK_FILES.items()}


def test_a_task_one_rank_cannot_encode_stops_both(tmp_path):
    """One task, rank 0's, at m5 under the exact parse (which has no
    binary-tree finder, so it takes m1-m4): rank 0 cannot encode it, and
    rank 1, with no task, stops as well."""
    import numpy as np
    rng = np.random.default_rng(7)
    make_tree(str(tmp_path / "tree"), {
        "r.bin": rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()})
    res = _ranks(["-m", "csc_tpu_torch.archiver.csarc", "a", "-r", "-m5",
                  "--parse=exact", "--backend=cpu", "x.csa", "tree"],
                 str(tmp_path))
    for rc, out, err in res:
        assert rc == 1
        assert "tree/r.bin" in err and "binary-tree finder (m5" in err


@pytest.mark.parametrize("failing", [0, 1])
def test_a_rank_that_raises_stops_both_at_once(tmp_path, failing):
    """A rank whose encode raises leaves the group without its barrier:
    the other rank, waiting in the gather of streams, fails at once
    rather than in Gloo's timeout (30 minutes)."""
    make_tree(str(tmp_path / "tree"), TWO_TASK_FILES)
    res = _ranks(["-c", _FAIL_ONE, str(failing), "a", "-r", "-m1",
                  "--backend=cpu", "x.csa", "tree"], str(tmp_path),
                 timeout=120)
    for pid, (rc, out, err) in enumerate(res):
        assert rc != 0, (pid, err)
    assert "injected failure" in res[failing][2]


def test_an_existing_archive_stops_both(tmp_path):
    make_tree(str(tmp_path / "tree"), {"a.txt": b"text " * 50})
    (tmp_path / "x.csa").write_bytes(b"older")
    res = _ranks(["-m", "csc_tpu_torch.archiver.csarc", "a", "-r",
                  "--backend=cpu", "x.csa", "tree"], str(tmp_path))
    for rc, out, err in res:
        assert rc == 1 and "already exists" in err
    assert (tmp_path / "x.csa").read_bytes() == b"older"

