"""A stream batch split over a list of torch devices.

The counterpart of csc_tpu/parallel/mesh.py and of the TPU kernels'
sharded launchers (`_run_fused_sharded`, pallas_decode.py:1849; the
`mesh` branches of pallas_parse.py:1002-1030 and pallas_encode.py:
1322-1350), which are shard_maps of the same kernels.  Streams are
independent, so a split needs no collective: the batch is padded to a
multiple of the device count by repeating its last stream (as
mesh.py:60-73 does), each entry of the device list runs one pipeline
call on its contiguous shard, and the padding is cut off.  Distinct
devices run at once, one host thread each; the shards of a device the
list names more than once run in turn (on one card that is a dry run of
the split; the CPU's plain versions gain nothing from threads).  Any
batch size is taken: there is no divisibility assert.  The kernel
wrappers' LAUNCHES counters are not locked, so a split over distinct
devices may undercount them.
"""
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import pipeline


def stream_devices(n=None):
    """The visible CUDA devices (the first n); raises when there is
    none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is visible; pass devices= "
                           "(for example [torch.device('cpu')] * 2) to run "
                           "the plain versions")
    return [torch.device("cuda", i) for i in range(count)][:n]


def _padded(lists, b, n):
    """Each list (or None) padded by repeating its last entry to a
    multiple of n entries."""
    pad = (-b) % n
    return [None if x is None else list(x) + [x[-1]] * pad for x in lists]


def _run(fn, devices, arrays, b):
    """fn(device, *shard) on each list entry's contiguous shard of the
    padded arrays, distinct devices at once; the outputs in order,
    padding cut."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("the split needs at least one device")
    if b == 0:
        raise ValueError("the split needs at least one stream")
    n = len(devices)
    arrays = _padded(arrays, b, n)
    per = len(arrays[0]) // n
    shards = [[None if x is None else x[k * per:(k + 1) * per]
               for x in arrays] for k in range(n)]
    distinct = list(dict.fromkeys(devices))

    def run(dev):
        return {k: fn(dev, *shards[k]) for k in range(n)
                if devices[k] == dev}
    with ThreadPoolExecutor(len(distinct)) as pool:
        parts = {}
        for done in pool.map(run, distinct):
            parts.update(done)
    return [out for k in range(n) for out in parts[k]][:b]


def decode_batch_sharded(props_list, blobs, positions=None, out_sizes=None,
                         devices=None):
    """decode_batch with the batch split over `devices` (the visible CUDA
    devices by default)."""
    return _run(lambda dev, p, bl, pos, sz: pipeline.decode_batch(
        p, bl, pos, sz, device=dev), devices or stream_devices(),
        [props_list, blobs, positions, out_sizes], len(blobs))


def encode_batch_sharded(props_list, datas, devices=None, parse="fast"):
    """encode_batch with the batch split over `devices` (the visible CUDA
    devices by default)."""
    return _run(lambda dev, p, d: pipeline.encode_batch(
        p, d, device=dev, parse=parse), devices or stream_devices(),
        [props_list, datas], len(datas))
