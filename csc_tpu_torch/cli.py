"""csc-compatible command line: c/d single-file compress/decompress.

The counterpart of csc_tpu/cli.py: the same options, 10-byte property
header and dict clamp (csc.cpp:101-170).  Both modes run the batched
pipeline (ops/pipeline.py) on one stream.  --backend cuda (the default)
runs the kernels (K2 or K4, then K3, to encode at levels 1-2 or 3-5; K1
to decode) on the first CUDA device and raises when there is none;
--backend cpu runs their plain PyTorch versions on the CPU.  --parse
exact (levels 1-4) encodes with the exact parse, K5 in K2's place at
levels 1-2 and K6 in K4's at levels 3-4: the reference encoder's own
bytes, as csc_tpu's CLI gives them under CSC_ENCODE_PARSE=exact (this
CLI reads no environment variable for it).  A file over 1 MB
(encode_host.MAX_ENCODE) at levels 1-4 takes the exact parse under the
default too, as csc_tpu codes it with its golden encoder, up to 1 GB;
so does a file longer than -d at levels 1-2 (32 MB by default; the
dictionary is clamped to the file, so only a file past -d outgrows it),
whose window wraps as golden's ring.  Level 5 takes files up to 1 MB,
levels 3-5 files up to the dictionary.

    python -m csc_tpu_torch.cli c -m 1 in.bin out.csc
    python -m csc_tpu_torch.cli c -m 3 --parse exact in.bin out.csc
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


def device_for(backend):
    """The torch device of a --backend: the CPU for "cpu", the first CUDA
    device for "cuda" (raises when there is none)."""
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
                    help="compression level 1..5")
    ap.add_argument("-d", type=_parse_size, default=32 * MB, dest="dict_size",
                    help="dictionary size (suffix k/m)")
    ap.add_argument("--fdelta0", action="store_true", help="disable DELTA filter")
    ap.add_argument("--fexe0", action="store_true", help="disable EXE filter")
    ap.add_argument("--ftxt0", action="store_true", help="disable TXT filter")
    ap.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--parse", choices=["fast", "exact"], default="fast",
                    help="c: the fast parse (the exact one past 1 MB), or "
                    "the exact parse of m1-m4 (the reference encoder's "
                    "bytes)")
    args = ap.parse_args(argv)
    device = device_for(args.backend)
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
        out = write_properties(props) + encode_stream(
            props, data, device=device, parse=args.parse)
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
