"""Decoder layout and state-machine ids of the batched decode.

The values mirror csc_tpu/ops/decode_scan.py:37-107 (probability layout,
FSM states, int purposes, length targets) and pallas_decode.py:108-110
(error codes).  They are restated here because those modules import jax;
a test holds both copies equal.  Format constants come from the jax-free
csc_tpu.constants.
"""
from csc_tpu.constants import (  # noqa: F401  (re-exported)
    DIST_TABLE, REV16_TABLE, DLT_INDEX, DT_NORMAL, DT_EXE, DT_ENGTXT,
    DT_BAD, DT_ENTROPY, SIG_EOF, DT_DLT)

# ---------------------------------------------------------------- layout
P_STATE = 0            # 64*3
P_REPDIST = 192        # 64*3
P_DIST = 384           # 8 + 16*2 + 32*4 = 168
P_MDEXTRA = 552        # 29*16
P_MLSLOT = 1016        # 2
P_MLEX1 = 1018         # 8
P_MLEX2 = 1026         # 8
P_MLEX3 = 1034         # 128
P_LONGLEN = 1162
P_RLEFLAG = 1163
P_LIT = 2048           # 65536
P_DELTA = 67584        # 65536
NPROB = 133120

# ---------------------------------------------------------------- fsm ids
F_IDLE = 0
F_FLAG1 = 1
F_FLAG2 = 2
F_FLAG3 = 3
F_LITTREE = 4
F_REPTREE = 5
F_LENSLOT0 = 6
F_LENSLOT1 = 7
F_LENTREE3 = 8
F_LENTREE7 = 9
F_LONGLEN = 10
F_DISTSLOT = 11
F_DISTEXTRA = 12
F_RLEFLAG = 13
F_RLETREE = 14
F_ENTTREE = 15
F_INTSLOT = 16
F_INTNUM = 17
F_DISTDIRECT = 18
F_BADBYTES = 19
F_COPY = 20
F_RLERUN = 21
NSTATES = 22

# int_purpose codes
IP_BLOCKTYPE = 0
IP_CONT = 1
IP_SIZE_BAD = 2
IP_SIZE_ENT = 3
IP_SIZE_RLE = 4
IP_SIZE_TXT = 5

# len_for codes
LF_MATCH = 0
LF_REP = 1
LF_RLE = 2

COPY_CHUNK = 16
MASK32 = 0xFFFFFFFF

# per-stream error codes
ERR_NONE = 0
ERR_CORRUPT = 1

# typed-block log entries per stream (decode_scan.py:141)
MAX_BLOCKS = 4096
# largest window a decode may grow to: the reference's dict cap
# (csc_typedef.h:12); a window-overflow halt reports at most this + 1
MAX_WINDOW = 1 << 30
