"""Archive index data model + serialization + compressed trailer.

A copy of csc_tpu/archiver/index.py: csa_typedef.h (FileEntry / Frag /
ArchiveBlocks), csa_indexpack.cpp (little-endian pack / unpack) and
csarc.cpp:219-336 (the CSC-coded trailer at EOF with a 16-byte pointer
record at offset 8).

csc_tpu codes the trailer with its golden encoder at level 2 under a
256 KB dictionary and decodes it with its golden decoder.  This package
has no host codec: the trailer goes through the batched pipeline on the
archiver's device.  Its exact m2 parse writes the reference encoder's
own bytes on every index (BAD / ENTROPY / DLT blocks included, and an
index longer than the trailer's dictionary, whose window wraps as
golden's ring), so the trailer, and with it the whole archive, equals
csc_tpu's.
"""
import struct
from dataclasses import dataclass, field
from typing import Dict, List

from ..ops import pipeline
from ..props import props_init, read_properties, write_properties

MAGIC_DATE = 0x20130331
HEADER_SIZE = 24
INDEX_DICT = 256 * 1024     # the trailer's dictionary (csarc.cpp:250-265)
INDEX_LEVEL = 2


@dataclass
class Frag:
    bid: int = 0
    checksum: int = 0
    posblock: int = 0
    size: int = 0
    posfile: int = 0


@dataclass
class FileEntry:
    edate: int = 0
    esize: int = 0
    eattr: int = 0
    ext: bytes = b"\0\0\0\0"
    frags: List[Frag] = field(default_factory=list)


@dataclass
class ArchiveBlocks:
    filename: str = ""
    blocks: List[tuple] = field(default_factory=list)   # (off, size)


FileIndex = Dict[str, FileEntry]
ABIndex = Dict[int, ArchiveBlocks]


def pack_index(fi: FileIndex, abi: ABIndex) -> bytes:
    """PackIndex, csa_indexpack.cpp:160-182.  Iteration in sorted key order
    (std::map semantics)."""
    out = bytearray()
    out += struct.pack("<I", len(fi))
    for name in sorted(fi.keys()):
        fe = fi[name]
        nb = name.encode()
        out += struct.pack("<I", len(nb))
        out += nb
        out += struct.pack("<qqq", fe.edate, fe.esize, fe.eattr)
        out.append(len(fe.frags) & 0xFF)
        for fr in fe.frags:
            out += struct.pack("<IIQQQ", fr.bid, fr.checksum,
                               fr.posblock, fr.size, fr.posfile)
    out += struct.pack("<I", len(abi))
    for bid in sorted(abi.keys()):
        ab = abi[bid]
        out += struct.pack("<QI", bid, len(ab.blocks))
        for off, size in ab.blocks:
            out += struct.pack("<QQ", off, size)
    return bytes(out)


def unpack_index(buf: bytes):
    """UnpackIndex, csa_indexpack.cpp:184-209."""
    fi: FileIndex = {}
    abi: ABIndex = {}
    pos = 0
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        name = buf[pos:pos + ln].decode(errors="surrogateescape")
        pos += ln
        edate, esize, eattr = struct.unpack_from("<qqq", buf, pos)
        pos += 24
        nfrag = buf[pos]
        pos += 1
        fe = FileEntry(edate=edate, esize=esize, eattr=eattr)
        for _ in range(nfrag):
            bid, csum, posblock, size, posfile = struct.unpack_from(
                "<IIQQQ", buf, pos)
            pos += 32
            fe.frags.append(Frag(bid, csum, posblock, size, posfile))
        fi[name] = fe
    (n,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    for _ in range(n):
        bid, nblk = struct.unpack_from("<QI", buf, pos)
        pos += 12
        ab = ArchiveBlocks()
        for _ in range(nblk):
            off, size = struct.unpack_from("<QQ", buf, pos)
            pos += 16
            ab.blocks.append((off, size))
        abi[bid] = ab
    return fi, abi


def compress_index_blob(fi: FileIndex, abi: ABIndex, device):
    """Index blob -> CSC (level 2, 256 KB dict) with the 10-byte props
    header (csarc.cpp:250-265), coded on `device` with the exact parse
    (golden's bytes, whatever its size: an index past the dictionary, a
    tree of some thousands of files, wraps its ring).  Returns (blob, raw
    size)."""
    raw = pack_index(fi, abi)
    props = props_init(INDEX_DICT, INDEX_LEVEL)
    body = pipeline.encode_batch([props], [raw], device=device,
                                 parse="exact")[0]
    return write_properties(props) + body, len(raw)


def write_trailer(f, fi: FileIndex, abi: ABIndex, device):
    """Append the compressed index + fix up the 24-byte header
    (csarc.cpp:269-285)."""
    f.seek(0, 2)
    arc_index_pos = f.tell()
    blob, raw_size = compress_index_blob(fi, abi, device)
    f.write(blob)
    f.seek(8)
    f.write(struct.pack("<QII", arc_index_pos, len(blob), raw_size))
    f.seek(0)
    f.write(b"CSA" + struct.pack("<I", MAGIC_DATE) + b"1")


def check_header(f) -> bool:
    """csarc.cpp:580-599."""
    f.seek(0)
    buf = f.read(8)
    if len(buf) < 8:
        return False
    (num,) = struct.unpack_from("<I", buf, 3)
    return (num == MAGIC_DATE and buf[0:3] == b"CSA" and buf[7:8] == b"1")


def read_trailer(f, device):
    """decompress_index, csarc.cpp:288-336, decoded on `device`."""
    f.seek(8)
    index_pos, compressed_size, raw_size = struct.unpack("<QII", f.read(16))
    f.seek(index_pos)
    blob = f.read(compressed_size)
    props = read_properties(blob[:10])
    raw = pipeline.decode_batch([props], [blob], [10], out_sizes=[raw_size],
                                device=device)[0]
    if len(raw) != raw_size:
        raise pipeline.DecodeError(f"index size mismatch: {len(raw)} bytes "
                                   f"decoded, the header says {raw_size}")
    return unpack_index(raw)
