"""Multi-process runtime for the archiver's task split.

The counterpart of csc_tpu/parallel/dist.py over torch.distributed.  The
reference scales with threads inside one process (csarc.cpp:338-474:
compress_mt workers pull tasks, the writer records each task's archive
blocks + per-file frags in completion order).  Here every process
compresses a deterministic subset of the task list on its own device,
then the per-task streams are gathered to process 0, which lays out the
archive in task order and writes the index trailer.

The group is configured explicitly or through the CSC_DIST_* environment
variables, so the archiver CLI works unchanged under any launcher:

    CSC_DIST_COORD=host0:29500 CSC_DIST_NPROCS=2 CSC_DIST_PID=k \\
        python -m csc_tpu_torch.archiver.csarc a arc.csa tree/

The payloads are host bytes (pickled streams and their checksums), so
the group runs on Gloo over TCP, on a card's machine too.
"""
import os

import torch
import torch.distributed as tdist

_ENV_COORD = "CSC_DIST_COORD"
_ENV_NPROCS = "CSC_DIST_NPROCS"
_ENV_PID = "CSC_DIST_PID"

_initialized = False


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """Join the process group (Gloo, rendezvous at tcp://coordinator).
    No-op for single-process runs (the default when neither arguments
    nor CSC_DIST_* env are present)."""
    global _initialized
    if _initialized:
        return True
    coordinator = coordinator or os.environ.get(_ENV_COORD)
    if num_processes is None and os.environ.get(_ENV_NPROCS):
        num_processes = int(os.environ[_ENV_NPROCS])
    if process_id is None and os.environ.get(_ENV_PID):
        process_id = int(os.environ[_ENV_PID])
    if not coordinator or not num_processes or num_processes <= 1:
        return False
    tdist.init_process_group("gloo", init_method="tcp://" + coordinator,
                             world_size=num_processes,
                             rank=process_id or 0)
    _initialized = True
    return True


def is_distributed():
    return _initialized and tdist.get_world_size() > 1


def process_index():
    return tdist.get_rank() if _initialized else 0


def process_count():
    return tdist.get_world_size() if _initialized else 1


def allgather_bytes(payload: bytes):
    """All-gather one byte string per process; returns a list of
    process_count() byte strings, indexed by rank: the lengths first,
    then the payloads padded to the longest as uint8 tensors."""
    if not is_distributed():
        return [payload]
    n = process_count()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    tdist.all_gather(lens, torch.tensor([len(payload)], dtype=torch.int64))
    lens = [int(t) for t in lens]
    maxlen = max(max(lens), 1)
    buf = torch.frombuffer(bytearray(payload.ljust(maxlen, b"\0")),
                           dtype=torch.uint8)
    bufs = [torch.empty(maxlen, dtype=torch.uint8) for _ in range(n)]
    tdist.all_gather(bufs, buf)
    return [bytes(b[:ln].numpy()) for b, ln in zip(bufs, lens)]


def barrier():
    if is_distributed():
        tdist.barrier()


def shutdown(clean=True):
    """Leave the process group.  After a clean end, which every rank
    reaches, first a barrier, so that no rank leaves while another still
    talks to it: a group left to the interpreter's exit can abort the rank
    that hosts the rendezvous store ("terminate called without an active
    exception") when the ranks end together, as they do when a task fails
    on every rank at once.  After an exception (clean=False) no barrier:
    the other ranks may wait in another collective and would hang there
    until Gloo's timeout; leaving the group closes this rank's
    connections, so their collective fails at once."""
    global _initialized
    if _initialized:
        if clean:
            tdist.barrier()
        tdist.destroy_process_group()
        _initialized = False
