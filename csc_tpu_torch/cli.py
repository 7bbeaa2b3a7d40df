"""csc-compatible command line: c/d single-file compress/decompress.

The counterpart of csc_tpu/cli.py: the same options, 10-byte property
header and dict clamp (csc.cpp:101-170).  Both modes run the batched
pipeline (ops/pipeline.py) on one stream.  --backend cuda (the default)
runs the kernels (K2 + K3 to encode, K1 to decode) on the first CUDA
device and raises when there is none; --backend cpu runs their plain
PyTorch versions on the CPU.  `c` takes levels 1 and 2; levels 3-5 (the
optimal parse) are not ported yet.

    python -m csc_tpu_torch.cli c -m 1 in.bin out.csc
    python -m csc_tpu_torch.cli d out.csc back.bin
"""
import argparse
import sys
import time

from .constants import KB, MB
from .props import (props_init, read_properties, write_properties,
                    est_mem_usage)


def _parse_size(s):
    s = s.lower()
    if s.endswith('k'):
        return int(s[:-1]) * KB
    if s.endswith('m'):
        return int(s[:-1]) * MB
    return int(s)


def _device(backend):
    import torch
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda needs a CUDA device; none is "
                           "available (--backend cpu runs the plain "
                           "versions)")
    return torch.device("cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="csc", description=__doc__)
    ap.add_argument("mode", choices=["c", "d"])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-m", type=int, default=2, dest="level",
                    help="compression level 1..2 (3..5 not ported yet)")
    ap.add_argument("-d", type=_parse_size, default=32 * MB, dest="dict_size",
                    help="dictionary size (suffix k/m)")
    ap.add_argument("--fdelta0", action="store_true", help="disable DELTA filter")
    ap.add_argument("--fexe0", action="store_true", help="disable EXE filter")
    ap.add_argument("--ftxt0", action="store_true", help="disable TXT filter")
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = _device(args.backend)
    from .ops.pipeline import decode_stream, encode_stream

    with open(args.input, "rb") as f:
        data = f.read()

    t0 = time.time()
    if args.mode == "c":
        dict_size = min(args.dict_size, max(len(data), 1))
        props = props_init(dict_size, args.level)
        if args.fdelta0:
            props.DLTFilter = 0
        if args.fexe0:
            props.EXEFilter = 0
        if args.ftxt0:
            props.TXTFilter = 0
        print("Estimated memory usage: %d MB"
              % (est_mem_usage(props) // 1048576), file=sys.stderr)
        out = write_properties(props) + encode_stream(props, data,
                                                      device=device)
        with open(args.output, "wb") as f:
            f.write(out)
        dt = time.time() - t0
        print("%d -> %d (%.2f MB/s)" % (len(data), len(out),
                                        len(data) / 1e6 / max(dt, 1e-9)))
    else:
        props = read_properties(data[:10])
        raw = decode_stream(props, data, 10, device=device)
        with open(args.output, "wb") as f:
            f.write(raw)
        dt = time.time() - t0
        print("%d -> %d (%.2f MB/s)" % (len(data), len(raw),
                                        len(raw) / 1e6 / max(dt, 1e-9)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
