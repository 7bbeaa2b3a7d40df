"""csc-compatible command line: c/d single-file compress/decompress.

The counterpart of csc_tpu/cli.py: the same options, 10-byte property
header and dict clamp (csc.cpp:101-170).  --backend selects the decoder:
`golden` is the pure-Python codec, `cuda` the batched decode with the K1
kernel on the first CUDA device.  Encoding is golden under either
backend.  --backend cuda with no CUDA device raises; it never falls back
to the CPU.

    python -m csc_tpu_torch.cli d --backend cuda in.csc out.bin
"""
import argparse
import sys
import time

from csc_tpu.constants import KB, MB
from csc_tpu.props import (props_init, read_properties, write_properties,
                           est_mem_usage)


def _parse_size(s):
    s = s.lower()
    if s.endswith('k'):
        return int(s[:-1]) * KB
    if s.endswith('m'):
        return int(s[:-1]) * MB
    return int(s)


def _cuda_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("--backend cuda needs a CUDA device; none is "
                           "available")
    return torch.device("cuda")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="csc", description=__doc__)
    ap.add_argument("mode", choices=["c", "d"])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("-m", type=int, default=2, dest="level",
                    help="compression level 1..5")
    ap.add_argument("-d", type=_parse_size, default=32 * MB, dest="dict_size",
                    help="dictionary size (suffix k/m)")
    ap.add_argument("--fdelta0", action="store_true", help="disable DELTA filter")
    ap.add_argument("--fexe0", action="store_true", help="disable EXE filter")
    ap.add_argument("--ftxt0", action="store_true", help="disable TXT filter")
    ap.add_argument("--backend", choices=["golden", "cuda"], default="golden")
    args = ap.parse_args(argv)
    device = _cuda_device() if args.backend == "cuda" else None

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
        from csc_tpu.golden.encoder import encode_stream
        out = write_properties(props) + encode_stream(props, data)
        with open(args.output, "wb") as f:
            f.write(out)
        dt = time.time() - t0
        print("%d -> %d (%.2f MB/s)" % (len(data), len(out),
                                        len(data) / 1e6 / max(dt, 1e-9)))
    else:
        props = read_properties(data[:10])
        if device is not None:
            from .ops.pipeline import decode_stream
            raw = decode_stream(props, data, 10, device=device)
        else:
            from csc_tpu.golden.api import decompress_stream
            raw = decompress_stream(props, data, 10)
        with open(args.output, "wb") as f:
            f.write(raw)
        dt = time.time() - t0
        print("%d -> %d (%.2f MB/s)" % (len(data), len(raw),
                                        len(raw) / 1e6 / max(dt, 1e-9)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
