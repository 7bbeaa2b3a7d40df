"""Batched device pipelines: the kernels' plain versions, their wrappers,
the encode precompute and stitch, and the encode / decode pipelines."""
