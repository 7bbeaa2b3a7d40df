"""csc_tpu_torch: the PyTorch / CUDA port of csc_tpu.

Batched CSC stream decode and encode at m1-m5 on an NVIDIA H100, with
each TPU kernel and device loop as a hand-written CUDA kernel beside its
plain PyTorch version: K1 decode (csrc/decode_k1.cu, ops/decode_scan.py),
K2 lazy parse of m1/m2 (csrc/encode_k2.cu, ops/parse_scan.py), K3
phase-B coder (csrc/encode_k3.cu, ops/bits_scan.py), K4 optimal parse of
m3-m5 (csrc/encode_k4.cu, ops/parse_ap_scan.py) and K5 exact m1/m2 parse
(csrc/encode_k5.cu, ops/exact_scan.py), driven by ops/pipeline.py.  On
top of it: the csc CLI (cli.py), the CSArc archiver (archiver/, `csarc
a / x / t / l`) and the split of stream batches across devices and
processes (parallel/mesh.py, parallel/dist.py over torch.distributed).
csc_tpu stays the reference; this package imports nothing of it and
keeps its own copies of the format constants, props, framing, host
filters and the archiver's index format.
"""
