"""ctypes bindings of the host runtime (csrc/csc_host.cpp): the EXE, dict
and delta filters and the block analyzer, around the batched codec.

A copy of csc_tpu/native/__init__.py's entry points on this package's
own build of the same C++ source.  The library builds with g++ on first
use (_build.host_library); if it cannot build, the call raises.
"""
import ctypes

from . import _build

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.host_library()
        lib.csc_e89_forward.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.csc_e89_inverse.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.csc_delta_forward.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                          ctypes.c_uint32]
        lib.csc_delta_inverse.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                          ctypes.c_uint32]
        lib.csc_dict_forward.restype = ctypes.c_int32
        lib.csc_dict_forward.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.csc_dict_inverse.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.csc_analyze.restype = ctypes.c_uint32
        lib.csc_analyze.argtypes = [ctypes.c_char_p, ctypes.c_uint32,
                                    ctypes.POINTER(ctypes.c_uint32)]
        _lib = lib
    return _lib


def _inplace(fn, buf, *args):
    raw = ctypes.create_string_buffer(bytes(buf), len(buf))
    fn(raw, len(buf), *args)
    buf[:] = raw.raw[:len(buf)]


def e89_forward(buf: bytearray):
    _inplace(_load().csc_e89_forward, buf)


def e89_inverse(buf: bytearray):
    _inplace(_load().csc_e89_inverse, buf)


def dict_forward(buf: bytearray) -> bool:
    """ENGTXT forward filter in place; False (buf untouched) when the
    block does not take it."""
    lib = _load()
    raw = ctypes.create_string_buffer(bytes(buf), len(buf))
    ok = lib.csc_dict_forward(raw, len(buf))
    if ok:
        buf[:] = raw.raw[:len(buf)]
    return bool(ok)


def dict_inverse(buf: bytearray):
    _inplace(_load().csc_dict_inverse, buf)


def delta_forward(buf: bytearray, chn: int):
    _inplace(_load().csc_delta_forward, buf, chn)


def delta_inverse(buf: bytearray, chn: int):
    _inplace(_load().csc_delta_inverse, buf, chn)


def analyze(data) -> tuple:
    """(block_type, bpb) of one block (csc_analyzer.cpp)."""
    bpb = ctypes.c_uint32(0)
    t = _load().csc_analyze(bytes(data), len(data), ctypes.byref(bpb))
    return t, bpb.value
