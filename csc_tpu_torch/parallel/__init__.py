"""Stream batches across devices and processes.

CSC's parallelism units are independent compressed streams: archiver
tasks and -p byte-range splits of one file.  `mesh` splits a stream
batch over a list of torch devices (the counterpart of csc_tpu/parallel/
mesh.py and of the TPU kernels' shard_map launchers); `dist` joins the
processes of an archiver group over torch.distributed (csc_tpu/parallel/
dist.py over jax.distributed).  The codec state of one stream never
crosses a device, so neither needs a collective on the hot path.
"""
