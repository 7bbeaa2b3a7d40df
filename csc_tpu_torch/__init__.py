"""csc_tpu_torch: the PyTorch / CUDA port of csc_tpu.

Batched CSC stream decode on an NVIDIA H100, with the decoder as a
hand-written CUDA kernel (K1, csrc/decode_k1.cu) beside its plain
PyTorch version (ops/decode_scan.py).  csc_tpu stays the reference;
this package imports its jax-free parts (golden, props, constants,
native, ops.framing) and never jax.
"""
