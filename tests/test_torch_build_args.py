"""The ctypes argument lists `_build` gives the kernels' C launch
functions (`_build._ARGTYPES`) against the declarations in the CUDA
sources: one ctypes type a parameter, in order (a pointer c_void_p,
int64_t c_int64, int32_t c_int32).  A list that drifts from its
declaration makes ctypes pass the arguments off by one, which faults
only on the card; this holds them together on the CPU."""
import ctypes
import os
import re

import pytest

from csc_tpu_torch import _build

C_TYPES = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32}


def declared(fn, source):
    """The ctypes types of `fn`'s parameters as `source` declares it."""
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"{fn} is not declared in {source}"
    types = []
    for param in m.group(1).split(","):
        words = param.replace("*", " * ").split()
        types.append(ctypes.c_void_p if "*" in words
                     else C_TYPES[words[-2]])
    return types


@pytest.mark.parametrize("name", ["csc_k1", "csc_k2", "csc_k3", "csc_k4",
                                  "csc_k5", "csc_k6"])
def test_launch_argtypes_match_the_source(name):
    fn, argtypes = _build._ARGTYPES[name]
    assert declared(fn, _build.KERNELS[name][0]) == argtypes


def test_tree_launch_argtypes_match_the_source():
    """K6's binary-tree launch (m5), whose argument list its wrapper
    keeps (exact_ap_kernel.BT_ARGTYPES)."""
    from csc_tpu_torch.ops import exact_ap_kernel
    assert declared("csc_k6_bt_launch", "encode_k6.cu") == \
        exact_ap_kernel.BT_ARGTYPES
