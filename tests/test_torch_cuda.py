"""The kernels on a CUDA card against their plain PyTorch versions: K1
(csrc/decode_k1.cu) and decode_batch through it, K2 (encode_k2.cu) on the
parity batch and on a stream whose dictionary is smaller than it, K3
(encode_k3.cu) with the output capacity cut until ERR_OVERFLOW fires,
and encode_batch raising on that overflow.  Needs a card; without one
every test here skips.  On a machine with a card (it needs no jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from csc_tpu.golden.encoder import encode_stream
from csc_tpu_torch import constants, corpus
from csc_tpu_torch.ops import (bits_kernel, bits_scan, decode_kernel,
                               decode_scan, encode_host, parse_kernel,
                               parse_pre, parse_scan, pipeline, stitch)
from csc_tpu_torch.ops.pipeline import DecodeError, EncodeError

pytestmark = pytest.mark.cuda
N = 1536
FIELDS = ("wnd", "blk_log", "wnd_pos", "done", "err", "blk_cnt")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def batch(dev):
    text = corpus.words(8 * N, seed=10)
    cases = corpus.parity_cases(text, corpus.torch_library_exe(), N, seed=11,
                                chunk=1024, big=40 * 1024)
    blobs = [encode_stream(p, d) for _, p, d in cases]
    blobs[-1] = corpus.flip(blobs[-1])
    rc, bc, rce, bce = pipeline._demux([p for _, p, _ in cases], blobs,
                                       [0] * len(blobs))
    return cases, blobs, (rc, bc, rce, bce)


# the parity batch run out; a window too small for the 40 KB stream plus
# a step cap; a block log too short for the multichunk stream
@pytest.mark.parametrize("wnd_size,max_steps,max_blocks",
                         [(None, 10 ** 7, 4096), (4096, 1500, 4096),
                          (None, 10 ** 7, 2)])
def test_kernel_matches_plain(dev, batch, wnd_size, max_steps, max_blocks):
    cases, _, arrays = batch
    wnd_size = wnd_size or pipeline._bucket(max(len(d) for _, _, d in cases))
    launches = decode_kernel.LAUNCHES
    got = decode_kernel.decode_k1(
        *(torch.from_numpy(a).to(dev) for a in arrays), wnd_size, max_steps,
        max_blocks)
    torch.cuda.synchronize()
    assert decode_kernel.LAUNCHES == launches + 1
    want = decode_scan.decode_plain(
        *(torch.from_numpy(a) for a in arrays), wnd_size, max_steps,
        max_blocks)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


def test_decode_batch_on_card(dev, batch):
    cases, blobs, _ = batch
    props = [p for _, p, _ in cases[:-1]]
    datas = [d for _, _, d in cases[:-1]]
    launches = decode_kernel.LAUNCHES
    assert pipeline.decode_batch(props, blobs[:-1],
                                 out_sizes=[len(d) for d in datas],
                                 device=dev) == datas
    # no declared sizes: the 40 KB stream outgrows its 32 KB dict window
    # and regrows
    assert pipeline.decode_batch(props, blobs[:-1], device=dev) == datas
    assert decode_kernel.LAUNCHES > launches + 1
    _, p, data = cases[-1]
    try:
        out = pipeline.decode_batch([p], [blobs[-1]], out_sizes=[len(data)],
                                    device=dev)
    except DecodeError:
        return
    assert out[0] != data


def _group(cases, level, dev):
    """Device inputs and packed candidates of the cases at one level."""
    sel = [c for c in cases if (c[1].hash_width == 1) == (level == 1)]
    props = [c[1] for c in sel]
    plans = [encode_host.plan_stream(p, d) for _, p, d in sel]
    ins = pipeline.group_inputs(props, plans, list(range(len(sel))), dev)
    p0 = props[0]
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        ins[0], ins[1], p0.hash_bits, p0.hash_width))
    return sel, plans, p0, ins, candp


@pytest.mark.parametrize("level", [1, 2])
def test_k2_matches_plain(dev, batch, level):
    cases = batch[0][:-1]
    sel, plans, p0, ins, candp = _group(cases, level, dev)
    names = [c[0] for c in sel]
    if level == 2:
        assert "dict_lt_output" in names      # dict < input
        i = names.index("dict_lt_output")
        assert sel[i][1].dict_size < len(sel[i][2])
    args = (ins[0], candp, *ins[1:], p0.good_len,
            parse_scan.tape_capacity(ins[0].shape[1], ins[1].shape[1]))
    launches = parse_kernel.LAUNCHES
    got = parse_kernel.parse_k2(*args)
    torch.cuda.synchronize()
    assert parse_kernel.LAUNCHES == launches + 1
    want = parse_scan.parse_plain(*args)
    for name, g, w in zip(("tape", "tok_cnt", "done", "err"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=name)
    assert bool(got[2].all()) and not bool(got[3].any())


def test_k3_overflow_matches_plain_and_encode_raises(dev, batch,
                                                     monkeypatch):
    cases = batch[0][:-1]
    sel, plans, p0, ins, candp = _group(cases, 1, dev)
    tape, tok_cnt, _, _ = parse_kernel.parse_k2(
        ins[0], candp, *ins[1:], p0.good_len,
        parse_scan.tape_capacity(ins[0].shape[1], ins[1].shape[1]))
    tape = tape[:, :int(tok_cnt.max())].contiguous()
    run_tables = [pl[1] for pl in plans]
    tapes = stitch.stitch_tapes(tape, ins[0], run_tables)[:4]
    shapes = pipeline.k3_shapes(p0, ins[0].shape[1], run_tables)
    # full capacity, then cut until ERR_OVERFLOW fires for some streams
    for max_rc, max_bc in ((shapes[0], shapes[1]), (256, 128)):
        args = (*tapes, max_rc, max_bc, *shapes[2:])
        got = bits_kernel.code_k3(*args)
        torch.cuda.synchronize()
        want = bits_scan.bits_plain(*args)
        for name, g, w in zip(("rc", "bc", "rc_map", "bc_map", "chunk_log",
                               "stats"), got, want):
            np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                          err_msg=name)
        over = got[5][4].cpu().numpy() == constants.ERR_OVERFLOW
        assert over.any() == (max_rc == 256)

    def small(kk, aa, bb, cc, max_rc, max_bc, nmap, nchunk, bsize):
        return bits_kernel.code_k3(kk, aa, bb, cc, 256, 128, nmap, nchunk,
                                   bsize)
    monkeypatch.setattr(pipeline, "code_k3", small)
    with pytest.raises(EncodeError, match="overflow"):
        pipeline.encode_batch([sel[0][1]], [sel[0][2]], device=dev)


def test_spike_probes_equal_their_plain_versions(dev):
    """Every spike probe (csc_tpu_torch/spikes), launched once in each
    layout on the spike's own inputs at every size the runner times,
    equals its plain version run on the card: max abs difference 0 over
    every output and updated input."""
    from csc_tpu_torch import spikes
    from csc_tpu_torch.spikes import _probe
    errs = {(k, label): e for k, p in spikes.PROBES.items()
            for label, e in _probe.compare(p, dev, steps=3).items()}
    torch.cuda.synchronize()
    assert {k: e for k, e in errs.items() if e != 0} == {}
