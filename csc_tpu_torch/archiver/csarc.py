"""CSArc-compatible archiver: a/x/l/t commands on the batched pipeline.

    python -m csc_tpu_torch.archiver.csarc a -r -m2 arc.csa tree/
    python -m csc_tpu_torch.archiver.csarc a --parse=exact arc.csa tree/
    python -m csc_tpu_torch.archiver.csarc x -o out/ arc.csa
    python -m csc_tpu_torch.archiver.csarc t arc.csa
    python -m csc_tpu_torch.archiver.csarc l -v arc.csa

A copy of csc_tpu/archiver/csarc.py on its device backend (--backend=tpu
there): directory scanning (csarc.cpp:719-812), extension-based solid
grouping + 64 KB min task (:495-557), -p single-file byte-range splits
(:532-543), tasks split at the device encode cap (`encode_host.
MAX_ENCODE`, 1 MB), per-task CSC streams appended as archive blocks with
1 MB write granularity (csa_io.h:174-200), Adler32 verification
(csa_io.h:250, 342-349) and the CSC-coded index trailer (:219-336).

`a` encodes every task of this process in one `encode_batch` call; `x`
and `t` decode the tasks in size-bucketed `decode_batch` groups.  Both
run on the first CUDA device with --backend=cuda (the default; the
kernels K1-K6) and raise when there is none; --backend=cpu runs the
kernels' plain versions.  --parse=exact (m1-m4) codes every task with
the exact parse, the reference encoder's own bytes (csc_tpu's, whose
golden encoder takes the tasks with BAD / ENTROPY / DLT blocks at m1 /
m2 and every task at m3 / m4); the index trailer always takes it.
Where csc_tpu still falls back to its golden codec this archiver stops
with an error: a task the device encode does not take (m5 under
--parse=exact) ends `a` naming the task's first file, a corrupt stream
ends `x` / `t` with "decode error" and -1.  -t is accepted and ignored, as csc_tpu's device backend ignores
it.

With CSC_DIST_COORD / CSC_DIST_NPROCS / CSC_DIST_PID set, the processes
of a group split the tasks round-robin by rank and rank 0 writes the
archive (parallel/dist.py).
"""
import os
import pickle
import struct
import sys

from .. import cli
from ..ops import encode_host
from ..ops.pipeline import DecodeError, EncodeError, decode_batch, \
    encode_batch
from ..parallel import dist
from ..props import props_init, read_properties, write_properties
from .adler32 import adler32
from .index import (ArchiveBlocks, FileEntry, Frag, HEADER_SIZE,
                    check_header, read_trailer, write_trailer)

KB = 1024
MB = 1048576
# the padded window bytes of one decode group (csc_tpu's default
# CSC_TPU_DECODE_MEMCAP, csarc.py:748-749)
DECODE_GROUP_BYTES = 256 * MB
BACKENDS = ("cuda", "cpu")


def ispath(a: str, b: str) -> bool:
    """Wildcard path match (csarc.cpp:17-37): * and ? in a; a == b, or
    a+'/' prefix of b, or a ending '/' prefix of b."""
    ai = 0
    bi = 0
    while ai < len(a):
        ca = a[ai].lower()
        cb = b[bi].lower() if bi < len(b) else "\0"
        if ca == "*":
            while True:
                if ispath(a[ai + 1:], b[bi:]):
                    return True
                if bi >= len(b):
                    return False
                bi += 1
        elif ca == "?":
            if bi >= len(b):
                return False
        elif ca == cb and ca == "/" and ai + 1 == len(a):
            return True
        elif ca != cb:
            return False
        ai += 1
        bi += 1
    return bi >= len(b) or b[bi] == "/"


def decimal_time(tt: int) -> int:
    """decimal_time, csa_common.cpp:3-26 (quirky hand-rolled calendar)."""
    if tt == -1:
        tt = 0
    t = tt
    second = t % 60
    minute = t // 60 % 60
    hour = t // 3600 % 24
    t //= 86400
    term = t // 1461
    t %= 1461
    t += (t >= 59)
    t += (t >= 425)
    t += (t >= 1157)
    year = term * 4 + t // 366 + 1970
    t %= 366
    t += (t >= 60) * 2
    t += (t >= 123)
    t += (t >= 185)
    t += (t >= 278)
    t += (t >= 340)
    month = t // 31 + 1
    day = t % 31 + 1
    return (year * 10000000000 + month * 100000000 + day * 1000000
            + hour * 10000 + minute * 100 + second)


def unix_time(date: int) -> int:
    """unix_time, csa_common.cpp:28-39."""
    if date <= 0:
        return -1
    days = (0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334)
    year = date // 10000000000 % 10000
    month = (date // 100000000 % 100 - 1) % 12
    day = date // 1000000 % 100
    hour = date // 10000 % 100
    minute = date // 100 % 100
    sec = date % 100
    return ((day - 1 + days[month] + (1 if (year % 4 == 0 and month > 1) else 0)
             + ((year - 1970) * 1461 + 1) // 4) * 86400
            + hour * 3600 + minute * 60 + sec)


class FileBlock:
    __slots__ = ("filename", "checksum", "off", "size", "posblock", "entry_name")

    def __init__(self, filename, off, size, posblock=0, checksum=0,
                 entry_name=None):
        self.filename = filename
        self.off = off
        self.size = size
        self.posblock = posblock
        self.checksum = checksum
        self.entry_name = entry_name


class MainTask:
    def __init__(self):
        self.total_size = 0
        self.filelist = []
        self.ab_id = 0

    def push_back(self, filename, off, size, posblock=0, checksum=0,
                  entry_name=None):
        self.filelist.append(FileBlock(filename, off, size, posblock,
                                       checksum, entry_name))
        self.total_size += size


def _autosplit_tasks(tasks, cap):
    """Split tasks larger than cap into -p-style sub-tasks so every
    task fits the device encode path (csarc.cpp:532-543 semantics: each
    split is an independent stream/archive-block set; windows do not
    span splits, trading a little ratio for device parallelism exactly
    like the reference's -p flag)."""
    out = []
    for t in tasks:
        if t.total_size <= cap:
            out.append(t)
            continue
        cur = MainTask()
        for fb in t.filelist:
            if cur.total_size and cur.total_size + fb.size > cap:
                out.append(cur)
                cur = MainTask()
            if fb.size <= cap:
                cur.push_back(fb.filename, fb.off, fb.size,
                              entry_name=fb.entry_name)
                continue
            off, rem = fb.off, fb.size
            while rem > 0:
                piece = min(cap, rem)
                if cur.total_size and cur.total_size + piece > cap:
                    out.append(cur)
                    cur = MainTask()
                cur.push_back(fb.filename, off, piece,
                              entry_name=fb.entry_name)
                off += piece
                rem -= piece
                if cur.total_size >= cap:
                    out.append(cur)
                    cur = MainTask()
        if cur.total_size:
            out.append(cur)
    return out


def _simulate_write_blocks(stream: bytes, csc_blocksize: int):
    """Reproduce AsyncArchiveWriter's 1 MB coalescing (csa_io.h:182-198):
    write-call boundaries are the MemIO framing fields (flag byte, size
    bytes, payload) plus the initial 10-byte props write.  Returns block
    sizes whose sum is len(stream)."""
    calls = [10]  # props
    pos = 10
    n = len(stream)
    while pos < n:
        fb = stream[pos]
        calls.append(1)
        pos += 1
        if (fb >> 6) & 1:
            size = csc_blocksize
        else:
            calls.append(3)
            size = (stream[pos] << 16) | (stream[pos + 1] << 8) | stream[pos + 2]
            pos += 3
        calls.append(size)
        pos += size
    blocks = []
    cap = MB
    cur = 0
    for c in calls:
        if cur + c > cap:
            if cur:
                blocks.append(cur)
            cap = max(MB, c)
            cur = 0
        cur += c
    if cur:
        blocks.append(cur)
    return blocks


def _read_task(args):
    """Read a task's files into the solid stream; compute posblock +
    Adler32 per file (AsyncFileReader, csa_io.h:207-287)."""
    (filelist,) = args
    datas = []
    results = []
    cumsize = 0
    for fb in filelist:
        try:
            with open(fb.filename, "rb") as f:
                f.seek(fb.off)
                data = f.read(fb.size)
        except OSError:
            results.append((0, 0, 0))   # size, posblock, checksum
            continue
        csum = adler32(data, 0)
        results.append((len(data), cumsize, csum))
        cumsize += len(data)
        datas.append(data)
    return b"".join(datas), results



def _route_output(raw, filelist):
    failures = []
    for fb in filelist:
        seg = raw[fb.posblock:fb.posblock + fb.size]
        csum = adler32(seg, 0)
        if csum != fb.checksum:
            failures.append(fb.entry_name or fb.filename)
        if fb.filename == "<dummy>":
            continue
        with open(fb.filename, "r+b") as f:
            f.seek(fb.off)
            f.write(seg)
    return failures


class _Progress:
    """Console progress bar (ProgressIndicator, csa_progress.cpp:11-69):
    a dedicated 300 ms poll thread draws finished bytes plus the live
    in-flight estimate (the reference polls per-worker processed_raw_;
    workers here report via tick())."""

    def __init__(self, total, width=50):
        self.total = max(total, 1)
        self.done = 0
        self.inflight = 0
        self.width = width
        self.enabled = sys.stderr.isatty()
        self._stop = None
        if self.enabled:
            import threading
            self._stop = threading.Event()
            t = threading.Thread(target=self._poll, daemon=True)
            t.start()

    def _poll(self):
        while not self._stop.wait(0.3):
            self._draw()

    def _draw(self):
        frac = min((self.done + self.inflight) / self.total, 1.0)
        filled = int(self.width * frac)
        sys.stderr.write("\r[%s%s] %3d%% done" % (
            "=" * filled, " " * (self.width - filled), int(frac * 100)))
        sys.stderr.flush()

    def tick(self, n):
        """Live in-flight bytes (per 2 MB raw block / device group)."""
        self.inflight = n

    def add(self, n):
        self.done += n
        self.inflight = 0
        if not self.enabled:
            return
        self._draw()
        if self.done >= self.total:
            if self._stop is not None:
                self._stop.set()
            sys.stderr.write("\n")
            sys.stderr.flush()


class TaskEncodeError(Exception):
    """A task the device encode does not take (csc_tpu codes it with its
    golden encoder there)."""


class CSArc:
    def __init__(self):
        self.index = {}
        self.abindex = {}
        self.arcname = ""
        self.filenames = []
        self.recurse = False
        self.verbose = False
        self.overwrite = False
        self.split_count = 1
        self.to_dir = "./"
        self.level = 2
        self.dict_size = 32000000
        self.backend = "cuda"
        self.parse = "fast"
        self.device = None          # set from backend by main()

    # ---------------------------------------------------------------- scan

    def isselected(self, filename):
        if not self.filenames:
            return True
        return any(ispath(p, filename) for p in self.filenames)

    def addfile(self, filename, edate, esize, eattr):
        if not self.isselected(filename):
            return
        fe = self.index.setdefault(filename, FileEntry())
        fe.edate = edate
        fe.esize = esize
        fe.eattr = eattr

    def scandir(self, filename, recurse=True):
        # csarc.cpp:719-762 (unix branch)
        while len(filename) > 1 and filename.endswith("/"):
            filename = filename[:-1]
        try:
            sb = os.lstat(filename)
        except OSError:
            return
        import stat as stat_mod
        if stat_mod.S_ISREG(sb.st_mode):
            self.addfile(filename, decimal_time(int(sb.st_mtime)),
                         sb.st_size, ord('u') + (sb.st_mode << 8))
        if stat_mod.S_ISDIR(sb.st_mode):
            dirname = "/" if filename == "/" else filename + "/"
            self.addfile(dirname, decimal_time(int(sb.st_mtime)), 0,
                         ord('u') + (sb.st_mode << 8))
            if recurse:
                try:
                    entries = os.listdir(filename)
                except OSError:
                    return
                for name in entries:
                    s = filename if filename == "/" else filename + "/"
                    self.scandir(s + name, recurse)

    # ---------------------------------------------------------------- add

    def add(self):
        exists = os.path.exists(self.arcname)
        # every process looks before the lead creates the file (csc_tpu's
        # ranks race here: a late one finds the lead's new archive)
        dist.barrier()
        if exists and not self.overwrite:
            sys.stderr.write("Archive %s already exists, use -f to force "
                             "overwrite\n" % self.arcname)
            return 1

        for pat in list(self.filenames):
            self.scandir(pat, self.recurse)

        # extension extraction + sort (csarc.cpp:495-513)
        itlist = []
        for name, fe in self.index.items():
            if name.endswith("/"):
                continue
            dot = name.rfind(".")
            slash = name.rfind("/")
            ext = b"\0\0\0\0"
            if dot != -1 and not (slash != -1 and dot < slash):
                ext = name[dot + 1:dot + 5].lower().encode("latin-1", "replace")
                ext = (ext + b"\0\0\0\0")[:4]
            fe.ext = ext
            itlist.append(name)

        def sort_key(name):
            fe = self.index[name]
            if fe.esize > 64 * KB:
                return (fe.ext, 1, fe.esize, "")
            return (fe.ext, 0, 0, name)

        itlist.sort(key=sort_key)

        # task building (csarc.cpp:515-557)
        tasks = []
        valid = [n for n in itlist if self.index[n].esize > 0]
        if len(valid) == 1:
            name = valid[0]
            esize = self.index[name].esize
            split_size = max(esize // self.split_count, MB) + 4
            off = 0
            while off < esize:
                t = MainTask()
                bsize = min(split_size, esize - off)
                t.push_back(name, off, bsize, entry_name=name)
                tasks.append(t)
                off += bsize
        else:
            cur = MainTask()
            prev_ext = None
            for name in itlist:
                fe = self.index[name]
                if (prev_ext is not None and fe.ext != prev_ext
                        and cur.total_size > 64 * KB):
                    tasks.append(cur)
                    cur = MainTask()
                cur.push_back(name, 0, fe.esize, entry_name=name)
                prev_ext = fe.ext
            if cur.total_size:
                tasks.append(cur)

        # every task fits the device encode: there is no host encoder
        tasks = _autosplit_tasks(tasks, encode_host.MAX_ENCODE)

        lead = dist.process_index() == 0
        if lead:
            with open(self.arcname, "wb") as f:
                f.write(b"\0" * HEADER_SIZE)

        try:
            self._compress_mt(tasks)
        except TaskEncodeError as e:
            sys.stderr.write("csarc: %s\n" % e)
            return 1
        if not lead:
            return 0  # rank 0 owns the archive file + trailer

        with open(self.arcname, "r+b") as f:
            write_trailer(f, self.index, self.abindex, self.device)
            f.seek(0, 2)
            size = f.tell()
        print("Compressed Size: %d" % size)
        return 0

    def _compress_mt(self, tasks):
        # greedy big-first (csarc.cpp:355); bid == dispatch order
        self.abindex = {}
        tasks.sort(key=lambda t: -t.total_size)
        arc_off = HEADER_SIZE
        progress = _Progress(sum(t.total_size for t in tasks))

        def finish(taskid, stream, results, csc_blocksize, arc_off):
            t = tasks[taskid]
            ab = ArchiveBlocks(filename=self.arcname)
            for bsize in _simulate_write_blocks(stream, csc_blocksize):
                ab.blocks.append((arc_off, bsize))
                arc_off += bsize
            self.abindex[taskid] = ab
            with open(self.arcname, "r+b") as f:
                f.seek(ab.blocks[0][0])
                f.write(stream)
            for fb, (size, posblock, csum) in zip(t.filelist, results):
                fe = self.index[fb.entry_name]
                fe.frags.append(Frag(bid=taskid, checksum=csum,
                                     posblock=posblock, size=size,
                                     posfile=fb.off))
            progress.add(t.total_size)
            return arc_off

        if dist.is_distributed():
            # multi-process dp: every process compresses tasks round-robin
            # by rank, streams gather to rank 0 which lays the archive
            # out in task order (compress_mt's writer + frag bookkeeping,
            # csarc.cpp:361-400, run once on the lead process); a task
            # one process cannot encode stops every process
            pid, n = dist.process_index(), dist.process_count()
            mine = list(range(pid, len(tasks), n))
            try:
                produced = {i: (s, r, bs)
                            for i, s, r, bs in self._produce_streams(
                                tasks, mine)}
                error = None
            except TaskEncodeError as e:
                produced, error = {}, str(e)
            merged, errors = {}, []
            for blob in dist.allgather_bytes(pickle.dumps((error,
                                                           produced))):
                err, part = pickle.loads(blob)
                errors += [err] if err else []
                merged.update(part)
            if errors:
                raise TaskEncodeError(errors[0])
            if pid != 0:
                return
            for i in range(len(tasks)):
                stream, results, bs = merged[i]
                arc_off = finish(i, stream, results, bs, arc_off)
        else:
            for i, stream, results, bs in self._produce_streams(
                    tasks, list(range(len(tasks)))):
                arc_off = finish(i, stream, results, bs, arc_off)

    def _produce_streams(self, tasks, ids):
        """Compress tasks[i] for i in ids in one batched device encode;
        yields (taskid, stream, results, csc_blocksize)."""
        if not ids:
            return
        datas, allres, props_list = [], [], []
        for i in ids:
            solid, results = _read_task((tasks[i].filelist,))
            datas.append(solid)
            allres.append(results)
            props_list.append(props_init(
                min(self.dict_size, max(len(solid), 1)), self.level))
        try:
            streams = encode_batch(props_list, datas, device=self.device,
                                   parse=self.parse)
        except EncodeError as e:
            k = e.streams[0] if e.streams else 0
            fb = tasks[ids[k]].filelist[0]
            raise TaskEncodeError(
                "cannot encode the task of %d bytes that starts with %s "
                "(offset %d): %s" % (tasks[ids[k]].total_size,
                                     fb.entry_name or fb.filename, fb.off,
                                     e)) from e
        for k, i in enumerate(ids):
            stream = (write_properties(props_list[k]) + streams[k])
            yield (i, stream, allres[k], props_list[k].csc_blocksize)

    # ---------------------------------------------------------------- x/t

    def _build_extract_tasks(self, dummy=False):
        tasks = []
        idmap = {}
        for name in sorted(self.index.keys()):
            fe = self.index[name]
            if self.filenames and not self.isselected(name):
                continue
            if dummy:
                out_name = "<dummy>"
            else:
                new_filename = name
                if len(new_filename) > 1 and new_filename[1] == ":":
                    if (len(new_filename) > 2
                            and new_filename[2] in ("/", "\\")):
                        new_filename = new_filename[0] + new_filename[2:]
                    else:
                        new_filename = (new_filename[0] + "/"
                                        + new_filename[2:])
                if not new_filename.startswith("/") and not self.to_dir.endswith("/"):
                    new_filename = self.to_dir + "/" + new_filename
                else:
                    new_filename = self.to_dir + new_filename
                new_filename = new_filename.replace("\\", "/")
                out_name = new_filename
            for fr in fe.frags:
                if fr.bid not in idmap:
                    idmap[fr.bid] = len(tasks)
                    tasks.append(MainTask())
                    tasks[idmap[fr.bid]].ab_id = fr.bid
                task = tasks[idmap[fr.bid]]
                if fr.size:
                    task.push_back(out_name, fr.posfile, fr.size,
                                   fr.posblock, fr.checksum, entry_name=name)
            if not dummy:
                self._makepath_and_create(out_name, fe)
        return tasks

    def _makepath_and_create(self, out_name, fe):
        # makepath + pre-truncate outputs (csarc.cpp:642-648)
        d = os.path.dirname(out_name.rstrip("/"))
        if d:
            os.makedirs(d, exist_ok=True)
        if not out_name.endswith("/"):
            with open(out_name, "wb"):
                pass
            self._restore_attrs(out_name, fe)
        else:
            os.makedirs(out_name, exist_ok=True)

    @staticmethod
    def _restore_attrs(path, fe):
        if fe.edate > 0:
            t = unix_time(fe.edate)
            try:
                os.utime(path, (t, t))
            except OSError:
                pass
        if (fe.eattr & 0xFF) == ord('u'):
            try:
                os.chmod(path, (fe.eattr >> 8) & 0o7777)
            except OSError:
                pass

    def _read_task_stream(self, f, ab):
        parts = []
        for off, size in ab.blocks:
            f.seek(off)
            parts.append(f.read(size))
        return b"".join(parts)

    def _decode_groups(self, tasks):
        """Task indices in size-bucketed device groups: the batched
        decoder pads every stream's window to the group max, so the
        padded footprint of a group stays under DECODE_GROUP_BYTES."""
        order = sorted(range(len(tasks)), key=lambda i: tasks[i].total_size)
        groups, cur, cur_max = [], [], 0
        for i in order:
            sz = max(tasks[i].total_size, 1)
            m = max(cur_max, sz)
            if cur and m * (len(cur) + 1) > DECODE_GROUP_BYTES:
                groups.append(cur)
                cur, m = [], sz
            cur.append(i)
            cur_max = m
        if cur:
            groups.append(cur)
        return groups

    def _decompress_mt(self, tasks):
        tasks.sort(key=lambda t: -t.total_size)
        for t in tasks:
            t.filelist.sort(key=lambda fb: fb.posblock)

        failures = []
        try:
            with open(self.arcname, "rb") as f:
                for grp in self._decode_groups(tasks):
                    streams = [self._read_task_stream(
                        f, self.abindex[tasks[i].ab_id]) for i in grp]
                    props_list = [read_properties(s2[:10])
                                  for s2 in streams]
                    outs = decode_batch(
                        props_list, streams, [10] * len(streams),
                        out_sizes=[tasks[i].total_size for i in grp],
                        device=self.device)
                    for i, raw in zip(grp, outs):
                        failures += _route_output(raw, tasks[i].filelist)
        except (DecodeError, IndexError, ValueError, IOError,
                struct.error) as e:
            sys.stderr.write("decode error: %s\n" % e)
            return -1
        for name in failures:
            sys.stderr.write("******** %s extraction/verify failed\n" % name)
        return -1 if failures else 0

    def extract(self, dummy=False):
        with open(self.arcname, "rb") as f:
            if not check_header(f):
                sys.stderr.write("Invalid csarc file\n")
                return 1
            self.index, self.abindex = read_trailer(f, self.device)
        tasks = self._build_extract_tasks(dummy=dummy)
        if self._decompress_mt(tasks) < 0:
            sys.stderr.write("Extraction error, archive corrupted\n")
            return -1
        if not dummy:
            # restore attrs again after writes (mtime changed by writing)
            for name in sorted(self.index.keys()):
                if self.filenames and not self.isselected(name):
                    continue
                out = self._target_path(name)
                if not name.endswith("/") and os.path.exists(out):
                    self._restore_attrs(out, self.index[name])
        return 0

    def _target_path(self, name):
        new_filename = name
        if not new_filename.startswith("/") and not self.to_dir.endswith("/"):
            new_filename = self.to_dir + "/" + new_filename
        else:
            new_filename = self.to_dir + new_filename
        return new_filename.replace("\\", "/")

    def list(self):
        with open(self.arcname, "rb") as f:
            if not check_header(f):
                sys.stderr.write("Invalid csarc file\n")
                return -1
            self.index, self.abindex = read_trailer(f, self.device)
        for name in sorted(self.index.keys()):
            fe = self.index[name]
            if self.filenames and not self.isselected(name):
                continue
            if self.verbose:
                for i, fr in enumerate(fe.frags):
                    end = "\n" if i + 1 < len(fe.frags) else ""
                    print("Fragment %1d, in archive block %d, Adler32: "
                          "0x%08x\t\t%s" % (i, fr.bid, fr.checksum, end),
                          end="")
            print("%s %d\t\t\t\t" % (name, fe.esize))
        return 0


def parse_args(argv):
    arc = CSArc()
    i = 0
    while i < len(argv) and argv[i].startswith("-"):
        a = argv[i]
        if a.startswith("-m"):
            arc.level = int(a[2:])
        elif a.startswith("-d"):
            v = a[2:]
            mult = 1
            if v[-1:].lower() == "k":
                mult, v = 1024, v[:-1]
            elif v[-1:].lower() == "m":
                mult, v = MB, v[:-1]
            arc.dict_size = int(v) * mult
        elif a == "-r":
            arc.recurse = True
        elif a == "-f":
            arc.overwrite = True
        elif a == "-v":
            arc.verbose = True
        elif a.startswith("-t"):
            int(a[2:])   # the thread count: one batched call takes all tasks
        elif a == "-o":
            i += 1
            arc.to_dir = argv[i]
        elif a.startswith("-o"):
            arc.to_dir = a[2:]
        elif a.startswith("-p"):
            arc.split_count = max(1, int(a[2:]))
        elif a.startswith("--backend"):
            arc.backend = a.split("=", 1)[1] if "=" in a else "cuda"
            if arc.backend not in BACKENDS:
                raise SystemExit("--backend takes one of %s, not %s"
                                 % ("/".join(BACKENDS), arc.backend))
        elif a.startswith("--parse="):
            arc.parse = a.split("=", 1)[1]
            if arc.parse not in ("fast", "exact"):
                raise SystemExit("--parse takes fast or exact, not %s"
                                 % arc.parse)
        else:
            raise SystemExit("unknown option %s" % a)
        i += 1
    if i >= len(argv):
        raise SystemExit("missing archive name")
    arc.arcname = argv[i]
    arc.filenames = argv[i + 1:]
    return arc


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        sys.stderr.write("usage: csarc a|x|l|t [options] archive [files...]\n")
        return 1
    op = argv[0][0]
    dist.init_distributed()   # no-op unless CSC_DIST_* env is present
    try:
        rc = _run(op, argv[1:])
    except BaseException:
        dist.shutdown(clean=False)
        raise
    dist.shutdown()
    return rc


def _run(op, args):
    arc = parse_args(args)
    arc.device = cli.device_for(arc.backend)
    if op == "a":
        return arc.add()
    if op == "x":
        return arc.extract()
    if op == "t":
        return arc.extract(dummy=True)
    if op == "l":
        return arc.list()
    sys.stderr.write("Invalid command '%s'\n" % op)
    return 1


if __name__ == "__main__":
    sys.exit(main())
