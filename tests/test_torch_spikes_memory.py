"""The card probes of the memory spikes (S2 spike_dma, S4 spike_marginal,
S6 spike_pallas, S7 spike_pallas2, S8 spike_pallas3): each probe's plain
PyTorch version equals the spike's own Pallas kernel (DMAs, semaphores
and SMEM included), run in interpret mode on the same seeded inputs at a
small size, exactly: the output and, for a probe that updates its inputs
(the buffers its copies write), their final contents against the final
contents of the spike kernel's refs; and the probes' step code built with
g++ equals the plain version."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_spike_ref as ref
from csc_tpu_torch.spikes import _probe, dma, marginal, pallas, pallas2
from csc_tpu_torch.spikes import pallas3

STEPS = 4
# s7's kernel runs a fixed 300 steps; p3 drains its 8 semaphores steps // 8
# times, so its step count is a multiple of 8
STEPS_OF = {"pallas2.s7": 300, "pallas3.p3": 8}


def _rec(mod, s, ins):
    return mod.REC.call(*ins)


def _jitted(mod, s, ins, k=-1):
    return np.asarray(mod.JITTED[k](*ins))


def _last(mod, s, ins):
    """The spike's kernel itself, for the four spikes whose jitted wrapper
    passes the spike's own array in place of its argument
    (spike_pallas.py:147 and :239, spike_pallas3.py:189 and :283)."""
    mod.REC.call(*ins)
    return np.asarray(ref.last_kernel()(*ins))


def _smem_loop(mod, s, n):
    orig = mod._smem_loop
    mod._smem_loop = lambda body_maker, B=256, steps=500: orig(
        body_maker, B=s["B"], steps=n)


# spike file -> {probe: (call of the spike at size s and n steps, how to
# reach its kernel)}
SPIKE = {
    "spike_dma": {
        "w1": (lambda m, s, n: m.w1(CH=s["CH"], N=s["N"]), _rec),
        "w1_check": (lambda m, s, n: m.w1(CH=64, N=2),
                     lambda m, s, ins: _jitted(m, s, ins, 0)),
        "w1b": (lambda m, s, n: m.w1b(CH=s["CH"], N=s["N"]), _rec),
        "w2": (lambda m, s, n: m.w2(B=s["B"], N=s["N"]), _rec),
        "w3": (lambda m, s, n: m.w3(B=s["B"], W=s["W"]), _jitted),
        "w4": (lambda m, s, n: m.w4(B=s["B"], NROW=s["NROW"]), _rec),
        "w5": (lambda m, s, n: m.w5(B=s["B"], N=s["N"], CH=s["CH"]), _rec),
    },
    "spike_marginal": {
        "m1": (lambda m, s, n: m.m1(B=s["B"], NP=s["NP"]), _rec),
        "m1b": (lambda m, s, n: m.m1(B=s["B"], NP=s["NP"],
                                     dtype=jnp.uint16), _rec),
        "m2": (lambda m, s, n: m.m2(B=s["B"], W=s["W"]), _rec),
        "m3": (lambda m, s, n: m.m3(B=s["B"], W=s["W"], CH=s["CH"]), _rec),
        "m4": (lambda m, s, n: m.m4(B=s["B"]), _rec),
        "m5": (lambda m, s, n: m.m5(B=s["B"]), _rec),
        "m5b": (lambda m, s, n: m.m5b(B=s["B"], N=s["N"]), _rec),
        "m6": (lambda m, s, n: m.m6(B=s["B"]), _rec),
        "m6b": (lambda m, s, n: m.m6(B=s["B"], unroll=8), _rec),
        "m7": (lambda m, s, n: m.m7(B=s["B"], NP=s["NP"]), _rec),
        "m8": (lambda m, s, n: m.m8(B=s["B"], W=s["W"]), _rec),
        "m9": (lambda m, s, n: m.m9(B=s["B"], NROW=s["NROW"]), _rec),
    },
    "spike_pallas": {
        "onehot_step_cost": (lambda m, s, n: m.onehot_step_cost(
            s["B"], s["NP"], steps=n), _rec),
        "transition_cost": (lambda m, s, n: m.transition_cost(
            s["B"], steps=n), _rec),
        "scalar_loop_cost": (lambda m, s, n: m.scalar_loop_cost(
            s["B"], steps=n, active_frac=s["AF"]), _rec),
        "row_swap_cost": (lambda m, s, n: m.row_swap_cost(
            s["B"], s["NROW"], steps=n), _last),
        "vmem_to_smem": (lambda m, s, n: m.vmem_to_smem(s["B"]), _jitted),
        "vmem_to_smem_latency": (lambda m, s, n: m.vmem_to_smem_latency(
            s["B"], steps=n), _rec),
        "hbm_row_dma_cost": (lambda m, s, n: m.hbm_row_dma_cost(
            s["B"], steps=n, rows_per_step=s["R"]), _last),
    },
    "spike_pallas2": {
        "s1": (lambda m, s, n: m.onehot_window_byte(
            B=s["B"], W=s["W"], steps=n), _rec),
        "s2": (lambda m, s, n: m.dma_window_copy(
            B=s["B"], W=s["W"], CH=s["CH"], steps=n, active=s["A"]), _rec),
        "s3": (lambda m, s, n: m.vmem_to_smem_block(
            B=s["B"], K=s["K"], steps=n), _rec),
        "s4": (lambda m, s, n: m.hbm_row_swap(
            B=s["B"], steps=n, active=s["A"]), _rec),
        "s5": (lambda m, s, n: m.bitstep_full(
            B=s["B"], NP=s["NP"], steps=n), _rec),
        "s6": (lambda m, s, n: m.scalar_sweep(
            B=s["B"], steps=n, active=s["A"]), _rec),
        "s7": (lambda m, s, n: m.take_along_axis_in_kernel(
            B=s["B"], W=s["W"]), _rec),
    },
    "spike_pallas3": {
        "p1": (lambda m, s, n: (_smem_loop(m, s, n), m.p1()), _rec),
        "p2": (lambda m, s, n: (_smem_loop(m, s, n), m.p2()), _rec),
        "p3": (lambda m, s, n: m.p3(B=s["B"], steps=n), _rec),
        "p3b": (lambda m, s, n: m.p3b(B=s["B"], steps=n), _rec),
        "p4": (lambda m, s, n: m.p4(B=s["B"], N=s["N"], steps=n), _rec),
        "p5": (lambda m, s, n: m.p5(B=s["B"], steps=n), _last),
        "p6": (lambda m, s, n: m.p6(B=s["B"], W=s["W"], steps=n), _rec),
        "p7": (lambda m, s, n: m.p7(B=s["B"], W=s["W"], steps=n), _rec),
        "p8": (lambda m, s, n: m.p8(B=s["B"], NP=s["NP"], steps=n), _last),
    },
}
PROBES = (dma.PROBES + marginal.PROBES + pallas.PROBES + pallas2.PROBES
          + pallas3.PROBES)


def _steps(p):
    return STEPS_OF.get(p.key, 1 if p.steps == (1, 1) else STEPS)


@pytest.mark.parametrize("p", PROBES, ids=lambda p: p.key)
def test_plain_equals_spike_kernel(p):
    rng = np.random.default_rng(zlib.crc32(p.key.encode()))
    s, n = p.small, _steps(p)
    ins_np = {a.name: a.make(rng) for a in p.ins(s)}
    mod = ref.load(f"spike_{p.file}")
    mod.REC.steps = n
    call, reach = SPIKE[f"spike_{p.file}"][p.name]
    call(mod, s, n)
    args = [ins_np[a.name] for a in p.ins(s)]
    want = reach(mod, s, args)
    got = _probe.run(p, {k: torch.from_numpy(v) for k, v in ins_np.items()},
                     n, size=s)
    out = got[p.outs(s)[0][0]].numpy()
    assert out.shape == want.shape
    np.testing.assert_array_equal(out, want)
    if p.mutable:
        ref.assert_final_state(p, s, args, want, got)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return ref.host_lib(tmp_path_factory.mktemp("spikehost"))


@pytest.mark.parametrize("p", PROBES, ids=lambda p: p.key)
def test_step_code_equals_plain(host_lib, p):
    """spike_common.cuh's step code, built with g++, equals the plain
    version: every output and updated input that does not hang on the
    order of the streams (the g++ build runs them one after another)."""
    rng = np.random.default_rng(zlib.crc32(p.key.encode()) + 1)
    s, n = p.small, _steps(p) + (0 if p.steps == (1, 1) else 3)
    ins = {a.name: a.make(rng) for a in p.ins(s)}
    got = ref.host_run(host_lib, p, s, ins, n)
    want = _probe.run(p, {k: torch.from_numpy(v) for k, v in ins.items()},
                      n, size=s)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k not in p.racy:
            np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
