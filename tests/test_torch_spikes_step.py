"""The card probes of the step spikes (S1 spike_carry, S3 spike_gather,
S5 spike_mxu_stage, S9 spike_regops, S10 spike_roofline): each probe's
plain PyTorch version equals the spike's own Pallas kernel, run in
interpret mode on the same seeded inputs at a small size, exactly: the
output and, for a probe that updates its inputs, their final contents
against the final contents of the spike kernel's refs (the outputs are
integers; S5's float32 rows hold integers below 2**24).  Each helper
returns the spike's output and the kernel's inputs."""
import zlib

import numpy as np
import pytest
import torch

import torch_spike_ref as ref
from csc_tpu_torch.spikes import _probe, carry, gather, mxu_stage, regops
from csc_tpu_torch.spikes import roofline

STEPS = 4
# spike_gather's kernel carries its table as a loop value (:75), never
# stored to a ref, so only its output (:83) holds the probes' updated table
CARRIED = ("gather",)


def _carry(p, s, ins):
    mod = ref.load("spike_carry", ("spike", str(s["B"]), str(s["N"])))
    fn = mod.run_tuple if p.name == "run_tuple" else mod.run_packed
    args = [np.array([[STEPS]], np.int32), ins["init"]]
    return np.asarray(fn(*args)), args


def _gather(p, s, ins):
    ns = ref.load_defs("spike_gather", B=s["B"])
    args = [np.array([[STEPS]], np.int32), ins["x"]]
    fn = ref.capture_call(ns, ns["make_run"](p.name, gather.REPS), *args)
    return np.asarray(fn(*args)), args


def _mxu(p, s, ins):
    ns = ref.load_defs("spike_mxu_stage", B=s["B"], TS=16)
    fn = ref.capture(ns, "make", p.name)
    args = [np.array([[STEPS]], np.int32), ins["tile"], ins["sub"]]
    return np.asarray(fn(*args)), args


def _regops(p, s, ins):
    ns = ref.load_defs("spike_regops", B=s["B"])
    fn = ref.capture(ns, "make", p.name)
    args = [np.array([[STEPS]], np.int32), ins["x"]]
    return np.asarray(fn(*args)), args


def _roofline(p, s, ins):
    mod = ref.load("spike_roofline")
    if p.name == "r4":
        mod.r4(MB=s["MB"], steps=STEPS)
    elif p.name == "r5":
        mod.r5(B=s["B"], steps=STEPS)
    else:
        getattr(mod, p.name)(B=s["B"], NP=s["NP"], steps=STEPS)
    args = [ins[a.name] for a in p.ins(s)]
    return mod.REC.call(*args), args


SPIKE = {"carry": _carry, "gather": _gather, "mxu_stage": _mxu,
         "regops": _regops, "roofline": _roofline}
PROBES = (carry.PROBES + gather.PROBES + mxu_stage.PROBES + regops.PROBES
          + roofline.PROBES)


@pytest.mark.parametrize("p", PROBES, ids=lambda p: p.key)
def test_plain_equals_spike_kernel(p):
    rng = np.random.default_rng(zlib.crc32(p.key.encode()))
    s = p.small
    ins_np = {a.name: a.make(rng) for a in p.ins(s)}
    want, args = SPIKE[p.file](p, s, ins_np)
    ins = {k: torch.from_numpy(v) for k, v in ins_np.items()}
    got = _probe.run(p, ins, STEPS, size=s)
    out = got[p.outs(s)[0][0]].numpy()
    assert out.shape == want.shape
    np.testing.assert_array_equal(out, want)
    if p.mutable and p.file not in CARRIED:
        ref.assert_final_state(p, s, args, want, got)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return ref.host_lib(tmp_path_factory.mktemp("spikehost"))


@pytest.mark.parametrize("p", PROBES, ids=lambda p: p.key)
def test_step_code_equals_plain(host_lib, p):
    """spike_common.cuh's step code, built with g++, equals the plain
    version: every output and every updated input."""
    rng = np.random.default_rng(zlib.crc32(p.key.encode()) + 1)
    s = p.small
    ins = {a.name: a.make(rng) for a in p.ins(s)}
    got = ref.host_run(host_lib, p, s, ins, STEPS + 3)
    want = _probe.run(p, {k: torch.from_numpy(v) for k, v in ins.items()},
                      STEPS + 3, size=s)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
