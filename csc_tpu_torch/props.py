"""CSCProps: codec configuration + level presets + 10-byte stream header.

Semantics match csc_common.h:19-63 (struct), csc_enc.cpp:16-97 (presets),
csc_enc.cpp:145-158 (serialization) and csc_dec.cpp:733-738 (parse).
A copy of csc_tpu/props.py.
"""
from dataclasses import dataclass

from .constants import KB, MB


@dataclass
class CSCProps:
    dict_size: int = 64 * MB
    csc_blocksize: int = 64 * KB
    raw_blocksize: int = 2 * MB
    # encoder-side tuning (not serialized)
    hash_bits: int = 22
    hash_width: int = 1
    bt_hash_bits: int = 23
    bt_size: int = 0
    bt_cyc: int = 32
    good_len: int = 32
    lz_mode: int = 2
    DLTFilter: int = 1
    TXTFilter: int = 1
    EXEFilter: int = 1


def props_init(dict_size: int, level: int) -> CSCProps:
    """Level presets. Mirrors CSCEncProps_Init (csc_enc.cpp:16-97)."""
    p = CSCProps()
    dict_size += 10 * KB
    dict_size = max(32 * KB, min(dict_size, 1024 * MB))
    p.dict_size = dict_size
    level = max(1, min(level, 5))
    p.DLTFilter = p.TXTFilter = p.EXEFilter = 1
    p.csc_blocksize = 64 * KB
    p.raw_blocksize = 2 * MB

    if dict_size < MB:
        hbits = 19
    elif dict_size <= 4 * MB:
        hbits = 20
    elif dict_size <= 16 * MB:
        hbits = 21
    elif dict_size <= 64 * MB:
        hbits = 22
    elif dict_size <= 256 * MB:
        hbits = 23
    else:
        hbits = 24
    while (1 << hbits) > dict_size:
        hbits -= 1

    if dict_size <= 16 * MB:
        p.bt_size = dict_size
    elif dict_size <= 64 * MB:
        p.bt_size = (dict_size - 16 * MB) // 2 + 16 * MB
    elif dict_size <= 256 * MB:
        p.bt_size = (dict_size - 64 * MB) // 4 + 40 * MB
    else:
        p.bt_size = (dict_size - 256 * MB) // 8 + 88 * MB

    p.good_len = 32
    p.hash_bits = hbits
    p.bt_hash_bits = hbits + 1
    p.bt_cyc = 32
    if level == 1:
        p.hash_width = 1
        p.lz_mode = 2
        p.bt_size = 0
        p.hash_bits += 1
    elif level == 2:
        p.hash_width = 8
        p.lz_mode = 2
        p.bt_size = 0
        p.good_len = 24
        p.hash_bits -= 1
    elif level == 3:
        p.hash_width = 2
        p.lz_mode = 3
        p.bt_size = 0
        p.good_len = 16
        p.hash_bits += 1
    elif level == 4:
        p.hash_width = 8
        p.lz_mode = 3
        p.bt_size = 0
        p.good_len = 24
        p.hash_bits -= 1
    else:  # level 5: binary-tree match finder
        p.lz_mode = 3
        p.good_len = 48
        p.bt_cyc = 32
        p.hash_width = 0

    if p.bt_size == p.dict_size:
        p.hash_width = 0
    return p


def est_mem_usage(p: CSCProps) -> int:
    """Estimated encoder working-set in bytes (CSCEnc_EstMemUsage,
    csc_enc.cpp:99-112).  Same formula so the `-m` printout matches the
    reference csc CLI (csc.cpp:144)."""
    ret = p.dict_size
    ret += p.csc_blocksize * 2
    if p.bt_size:
        ret += ((1 << p.bt_hash_bits) + 2 * p.bt_size) * 4
    if p.hash_width:
        ret += (p.hash_width * (1 << p.hash_bits)) * 4
    ret += 80 * KB * 4
    ret += 256 * 256 * 4 * 2
    ret += 2 * MB
    return ret


def write_properties(p: CSCProps) -> bytes:
    """10-byte big-endian header (csc_enc.cpp:145-158)."""
    return bytes([
        (p.dict_size >> 24) & 0xFF,
        (p.dict_size >> 16) & 0xFF,
        (p.dict_size >> 8) & 0xFF,
        p.dict_size & 0xFF,
        (p.csc_blocksize >> 16) & 0xFF,
        (p.csc_blocksize >> 8) & 0xFF,
        p.csc_blocksize & 0xFF,
        (p.raw_blocksize >> 16) & 0xFF,
        (p.raw_blocksize >> 8) & 0xFF,
        p.raw_blocksize & 0xFF,
    ])


def read_properties(s: bytes) -> CSCProps:
    """Parse the 10-byte header (csc_dec.cpp:733-738)."""
    p = CSCProps()
    p.dict_size = (s[0] << 24) | (s[1] << 16) | (s[2] << 8) | s[3]
    p.csc_blocksize = (s[4] << 16) | (s[5] << 8) | s[6]
    p.raw_blocksize = (s[7] << 16) | (s[8] << 8) | s[9]
    return p
