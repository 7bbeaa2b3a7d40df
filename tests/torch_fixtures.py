"""csc_tpu's outputs that the port's CPU tests compare against, made once
and kept under tests/fixtures/.

csc_tpu is frozen, so what its device paths make of a test's inputs does
not change, and on the CPU its JAX scans take minutes to compile and run
them.  A test module that compares against such an output keeps the
function that makes it live (`reference` below names each); `save` writes
what it returns to `tests/fixtures/<name>.npz`: small arrays in full,
every array named in `full` too, every other one as the sha256 of its
dtype, shape and bytes.  The fast tests `load` it; the module's
slow-marked test makes it live again and holds the stored one to it
(`assert_values`).  The digest of the test's input bytes is stored too,
so changed inputs fail the fast test instead of comparing other streams.

Regenerate with `python tools/make_torch_fixtures.py` (JAX on the CPU,
about 20 minutes for all of them).
"""
import hashlib
import importlib
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures")
FULL_MAX = 4096             # arrays up to this many elements kept whole
SHA = "#sha256"

# name -> (test module, function, arguments): each function returns
# (cases, {key: array}, the keys to keep whole), cases the (name, props,
# data) inputs
REFERENCES = {
    **{f"parse_scan_m{lv}": ("test_torch_parse_scan", "reference", (lv,))
       for lv in (1, 2)},
    **{f"encode_fast_m{lv}": ("test_torch_encode", "reference_fast", (lv,))
       for lv in (1, 2, 3, 4, 5)},
    **{f"encode_width_m{lv}": ("test_torch_encode", "reference_width",
                               (lv,)) for lv in (3, 4, 5)},
    **{f"parse_ap_m{lv}": ("test_torch_parse_ap_m3", "reference", (lv,))
       for lv in (3, 4, 5)},
    **{f"exact_scan_m{lv}": ("test_torch_exact_scan_m1", "reference",
                             (lv,)) for lv in (1, 2)},
    **{f"encode_exact_m{lv}": ("test_torch_encode_exact_m1", "reference",
                               (lv,)) for lv in (1, 2)},
    "k3_edges_jax": ("test_torch_k3_edges_jax", "reference", ()),
    **{f"exact_ap_ring_m{lv}": ("test_torch_exact_ap_ring", "reference",
                                (lv,)) for lv in (3, 4)},
    "exact_bt_ring_m5": ("test_torch_exact_ap_ring", "reference", (5,)),
}


def path(name):
    return os.path.join(FIXTURES, f"{name}.npz")


def digest(a):
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def inputs_digest(cases):
    return digest(np.frombuffer(b"".join(
        len(c[2]).to_bytes(4, "little") + bytes(c[2]) for c in cases),
        np.uint8))


def streams_value(streams):
    """A list of byte strings as one array (kept whole: offsets first)."""
    ends = np.cumsum([len(s) for s in streams], dtype=np.int64)
    return np.concatenate([ends.view(np.uint8),
                           np.frombuffer(b"".join(streams), np.uint8)])


def streams_of(value, count):
    ends = value[:8 * count].view(np.int64)
    data = value[8 * count:].tobytes()
    return [data[a:b] for a, b in zip([0, *ends[:-1]], ends)]


def make(name):
    """(cases, values, keys kept whole) of reference `name`, made
    live."""
    module, fn, args = REFERENCES[name]
    return getattr(importlib.import_module(module), fn)(*args)


def save(name, cases, values, full=()):
    out = {"#inputs": np.array(inputs_digest(cases))}
    for k, a in values.items():
        a = np.asarray(a)
        if a.size <= FULL_MAX or k in full:
            out[k] = a
        else:
            out[k + SHA] = np.array(digest(a))
    os.makedirs(FIXTURES, exist_ok=True)
    np.savez_compressed(path(name), **out)


def load(name, cases):
    """{key: array, or the digest str of one} of reference `name`, made
    from `cases`."""
    z = np.load(path(name))
    assert str(z["#inputs"]) == inputs_digest(cases), (
        f"{path(name)} was made from other inputs: regenerate it with "
        "tools/make_torch_fixtures.py")
    return {(k[:-len(SHA)] if k.endswith(SHA) else k):
            (str(z[k]) if k.endswith(SHA) else z[k])
            for k in z.files if k != "#inputs"}


def assert_values(want, got, where=""):
    """got (arrays) equals want (arrays, or digests of arrays): the same
    keys, each of the same dtype and values."""
    assert set(want) == set(got), (where, set(want) ^ set(got))
    for k, w in want.items():
        g = np.asarray(got[k])
        if isinstance(w, str):
            assert digest(g) == w, f"{where} {k}"
        else:
            assert g.dtype == w.dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f"{where} {k}")


def check_live(name):
    """The stored reference `name` is what its function makes today."""
    cases, values, _ = make(name)
    assert_values(load(name, cases), values, name)
