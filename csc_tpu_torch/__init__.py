"""csc_tpu_torch: the PyTorch / CUDA port of csc_tpu.

Batched CSC stream decode and m1/m2 encode on an NVIDIA H100, with each
TPU kernel as a hand-written CUDA kernel beside its plain PyTorch
version: K1 decode (csrc/decode_k1.cu, ops/decode_scan.py), K2 lazy parse
(csrc/encode_k2.cu, ops/parse_scan.py) and K3 phase-B coder
(csrc/encode_k3.cu, ops/bits_scan.py).  csc_tpu stays the reference; this
package imports nothing of it and keeps its own copies of the format
constants, props, framing and host filters.
"""
