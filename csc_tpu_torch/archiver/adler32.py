"""Adler32 checksums (csa_adler32.{h,cpp}, zlib-derived); a copy of
csc_tpu/archiver/adler32.py.

The archiver seeds with 0 (not zlib's canonical 1): MainTask.push_back
passes checksum=0 and AsyncFileReader accumulates from it (csa_io.h:250).
zlib.adler32 treats `value` as raw state (s2<<16|s1), so seeding 0 matches.

adler32_combine (csa_adler32.cpp:131-160) merges checksums of concatenated
spans.
"""
import zlib

BASE = 65521


def adler32(data, value=0):
    return zlib.adler32(data, value) & 0xFFFFFFFF


def adler32_combine(adler1, adler2, len2):
    """Combine adler32(seq1) and adler32(seq2) into adler32(seq1+seq2),
    for the archiver's seed-0 convention (both inputs seeded 0):
        s1' = s1_1 + s1_2          (mod BASE)
        s2' = s2_1 + len2*s1_1 + s2_2  (mod BASE)
    """
    rem = len2 % BASE
    s1 = ((adler1 & 0xFFFF) + (adler2 & 0xFFFF)) % BASE
    s2 = (((adler1 >> 16) & 0xFFFF) + ((adler2 >> 16) & 0xFFFF)
          + rem * (adler1 & 0xFFFF)) % BASE
    return (s1 | (s2 << 16)) & 0xFFFFFFFF
