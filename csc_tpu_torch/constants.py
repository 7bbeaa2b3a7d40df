"""Stream-format constants and the state-machine ids of the batched codec.

The format constants are this package's own copy of csc_tpu/constants.py
(csc_typedef.h:7-40, the slot tables of csc_model.cpp:45-62, the match
finder's gates of csc_mf.cpp:245).  The decoder ids mirror
csc_tpu/ops/decode_scan.py:37-107 and pallas_decode.py:108-110; the
encoder ids mirror encode_scan.py:31-57, encode_scan_fast.py:34-38,
encode_bits.py:23-49, parse_pre.py:37, pallas_encode.py:87-88 and
parse_ap.py:34-50.  The port keeps copies because it imports nothing of
csc_tpu; a test holds every copy equal to its original.
"""
KB = 1024
MB = 1024 * 1024

MIN_BLOCK_SIZE = 8 * KB          # csc_typedef.h:9
MAX_DICT_SIZE = 1024 * MB        # csc_typedef.h:12
MIN_DICT_SIZE = 32 * KB          # csc_typedef.h:13

# Block types (csc_typedef.h:20-40)
DT_NONE = 0x00
DT_NORMAL = 0x01
DT_ENGTXT = 0x02
DT_EXE = 0x03
DT_FAST = 0x04
DT_NO_LZ = 0x05
DT_ENTROPY = 0x07
DT_BAD = 0x08
SIG_EOF = 0x09
DT_DLT = 0x10
DLT_CHANNEL_MAX = 5
DLT_INDEX = (1, 2, 3, 4, 8)      # csc_typedef.h:36
DT_SKIP = 0x1E
DT_MAXINVALID = 0x1F

# Error codes (csc_common.h:13-15)
DECODE_ERROR = -96
WRITE_ERROR = -97
READ_ERROR = -98

CSC_PROP_SIZE = 10               # csc_common.h:11

# Match-distance slot base table (csc_model.cpp:45-55 / csc_dec.cpp:44-54).
# slot s covers distances [dist_table[s], dist_table[s+1]).
DIST_TABLE = (
    0, 1, 2, 3,
    5, 9, 17, 33,
    65, 129, 257, 513,
    1025, 2049, 4097, 8193,
    16385, 32769, 65537, 131073,
    262145, 524289, 1048577, 2097153,
    4194305, 8388609, 16777217, 33554433,
    67108865, 134217729, 268435457, 536870913,
    1073741825,
)

# Bit-reversal of a 4-bit value (csc_model.cpp:57-62).
REV16_TABLE = (0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15)

# Probability model geometry (csc_model.h:84-122):
PROB_INIT = 2048                 # 12-bit probability, initial value
PROB_ADAPT_SHIFT = 5

# Minimum-length-vs-distance gates for the match finder (csc_mf.cpp:245)
MF_DIST_BOUND = (0, 0, 64, 1024, 16 * KB, 256 * KB, 4 * MB)
MF_CAND_LIMIT = 32               # csc_mf.h:34

# Archiver magic (csarc.cpp:580-599)
CSA_MAGIC = b"CSA\x20"

# ================================================================= decode
# probability layout
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

# fsm ids
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

# ================================================================= encode
# parse-tape token kinds (encode_scan.py:36-41)
K_LIT = 0
K_MATCH = 1       # (dist_wire, len_wire) = (dist-5, len-2)
K_REP = 2         # (rep_idx, len_wire)
K_REP0L1 = 3
K_SENT_A = 4      # run-end sentinel of the parse tape
K_END = 5
# phase-B token kinds added by the stitcher (encode_bits.py:43-49)
K_RAW = 6         # CompressBad payload: a = 1-2 raw bytes, b = bits
K_ELIT = 7        # CompressLiterals payload: order-1 literal, no LZ flags
K_DLIT = 8        # CompressRLE literal: a = byte, b = s_ctx
K_RLEN = 9        # CompressRLE run: b = run length - 11
K_INT = 10        # EncodeInt(a)
K_SENT = 11       # EncodeMatch(64, 0) block sentinel
K_FLUSH = 12      # Coder::Flush chunk boundary

# fast-parse fsm (encode_scan_fast.py:34-38; its FB_EXT and FB_PICK are
# unused there too)
FB_BLOCK = 0
FB_FIND = 1
FB_DONE = 4
# precomputed candidate length cap; longer matches extend live
# (parse_pre.py:37)
EXT_CAP = 8

# phase-B fsm (encode_bits.py:23-38)
B_DONE = 0
B_NEXT = 1
B_FLAG = 2
B_LITTREE = 3
B_REPTREE = 4
B_LENSLOT = 5
B_LENTREE = 6
B_LONGLEN = 7
B_DISTSLOT = 8
B_DISTEXTRA = 9
B_DISTDIRECT = 10
B_INT = 11
B_FLUSH = 12
B_RAW = 13
B_RLEFLAG = 14
B_DLITTREE = 15
NBSTATES = 16

# phase-B per-stream error (pallas_encode.py:87-88)
ERR_OVERFLOW = 1  # rc or bc output capacity exhausted

# optimal (AP) parse, m3-m5 (parse_ap.py:34-50): the stretch cap
# (csc_lz.h:43), the DP's unreached price, its fsm and the post-stretch
# actions the WALK applies at the end node
AP_LIMIT = 2048
INF = 0x3FFFFFFF
AP_BLOCK = 0
AP_FIND = 1        # node + candidates + extensions + relaxation
AP_MARK = 2        # backward next-pointer marking
AP_WALK = 3        # forward token emission
AP_DONE = 4
POST_NONE = 0      # AP_LIMIT cap: the next stretch starts at the end node
POST_LIT = 1       # a lone literal after the path
POST_MATCH = 2     # a good_len or cap-straddling match after the path
# K4's per-stream error beside ERR_OVERFLOW (the tape is full): the step
# budget ran out before K_END
ERR_STEPS = 2

# exact m1/m2 parse (encode_scan.py:31-57): the hash tables' sizes, the
# candidate slots of one find, the fsm states and the probe phases
HT2_SIZE = 16 * 1024
HT3_SIZE = 64 * 1024
NCAND = 20         # rep0len1 + 4 reps + ht2 + ht3 + 8 * ht6, with slack
E_DONE = 0
E_BLOCK = 1        # sub-block / run / stream bookkeeping
E_PREP = 2         # hashes of the probe position, probe set-up
E_PROBE = 3        # one candidate: distance gate, validity, precheck
E_EXT = 4          # a 4-byte word of match extension
E_DECIDE = 5       # FindMatch's pick and the lazy decision
E_INS = 6          # one SlidePos insertion
PH_REP0 = 0        # .. rep 3 = 3
PH_HT2 = 4
PH_HT3 = 5
PH_HT6 = 6         # the row's slot in its own register
PH_DONE = 7
