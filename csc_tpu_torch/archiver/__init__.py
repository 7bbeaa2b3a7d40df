"""CSArc-compatible archiver (csarc a/x/l/t) over the batched pipeline.

The counterpart of csc_tpu/archiver on its device backend: the same
24-byte header, per-task CSC streams appended as archive blocks and
CSC-coded index trailer (archiver/csarc.cpp), so an archive written here
equals csc_tpu's `csarc a --backend=tpu` byte for byte.  `a` encodes
every task in one `encode_batch` call, `x` / `t` decode them in
size-bucketed `decode_batch` groups; both run on the CUDA card unless
the caller asks for the CPU.  Copies, never imports, of csc_tpu's
adler32.py, index.py and csarc.py.
"""
