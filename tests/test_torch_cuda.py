"""The kernels on a CUDA card against their plain PyTorch versions: K1
(csrc/decode_k1.cu) and decode_batch through it, K2 (encode_k2.cu) on the
parity batch and on a stream whose dictionary is smaller than it, K3
(encode_k3.cu) with the output capacity cut until ERR_OVERFLOW fires,
and encode_batch raising on that overflow; K1 and K2 on the edge
streams of their designs and K3 on its edge tapes
(tests/torch_edge_cases.py), K1's two blocks
per SM, a 1 MB stream round-tripped through K2, K3 and K1; K4
(encode_k4.cu) at m3, m4 and m5 on its edge streams, with a tape too
short and a step budget cut, on its window cases with its debug copy of
the cells held to the plain version's cells (and without the copy the
same outputs), and m3 streams through K4, K3 and K1, equal to the CPU's
encode; K5 (encode_k5.cu, the exact parse) at m1, m2 and lz_mode 1 on its
edge streams, with a tape too short and step budgets cut, on the 4 x 1
MB m1 task under a budget, launched twice on the same 96 streams, a
CUDA tensor reaching K5 and never the plain version, and exact streams
through K5,
K3 and K1 equal to the CPU's and golden's bytes; K5 on a stream longer
than its dictionary (a ring window) against the plain version, and
encode_batch of such streams equal to golden's bytes; K6
(encode_k6.cu, the exact optimal parse of m3-m5) at m3 and m4 on its
edge streams and K5's, with tapes too short, launched twice on the same
96 streams, a CUDA tensor reaching K6 and never the plain version, and
exact m3 / m4 streams through K6, K3 and K1 equal to the CPU's and
golden's bytes; K6's binary-tree kernel (m5) on its edge streams and
golden's IndexError stream, with tapes too short, launched twice on the
same 96 streams, and exact m5 streams through K6, K3 and K1 equal to the
CPU's and golden's bytes; K1's block log
sized from the stream past MAX_BLOCKS; the A/B tool
(csc_tpu_torch/kernel_ab.py) run against this checkout; the archiver's
a / x / t round trip of a 2.5 MB tree split into several tasks, its
archives of small trees equal to --backend=cpu's, and the batch split
over cuda:0 named twice equal to one device.  Needs a card; without one
every test here skips.
On a machine with a card (it needs no jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""
import json
import os

import numpy as np
import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream
from csc_tpu_torch import _build, constants, corpus, kernel_ab
from csc_tpu_torch.ops import (bits_kernel, bits_scan, decode_kernel,
                               decode_scan, encode_host, exact_ap_kernel,
                               exact_ap_scan, exact_kernel, exact_scan,
                               parse_ap_kernel, parse_ap_scan,
                               parse_kernel, parse_pre, parse_scan, pipeline,
                               prices, stitch)
from csc_tpu_torch.ops.pipeline import DecodeError, EncodeError
from csc_tpu_torch.props import props_init

import torch_edge_cases as edges
import torch_ring_cases as ring
from test_torch_exact_ap_host import k6_args
from test_torch_exact_host import exact_args
from test_torch_parse_ap_host import plain_cells
from torch_archiver_trees import CROSS_FILES, TEXT_FILES, make_tree, \
    run_in, tree_bytes

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


# ------------------------------------------- K1 / K2 designs' edge streams
@pytest.fixture(scope="module")
def k1_edge():
    cases = edges.k1_cases()
    blobs = [encode_stream(p, d) for _, p, d in cases]
    arrays = pipeline._demux([p for _, p, _ in cases], blobs,
                             [0] * len(blobs))
    return cases, arrays, pipeline._bucket(max(len(d) for _, _, d in cases))


def _k1_against_plain(dev, arrays, wnd_size, max_steps):
    got = decode_kernel.decode_k1(
        *(torch.from_numpy(a).to(dev) for a in arrays), wnd_size, max_steps)
    torch.cuda.synchronize()
    want = decode_scan.decode_plain(
        *(torch.from_numpy(a) for a in arrays), wnd_size, max_steps)
    for name, g, w in zip(FIELDS, got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    return [g.cpu().numpy() for g in got]


@pytest.mark.parametrize("cut", [None, "rc", "bc"])
def test_k1_edge_streams_match_plain(dev, k1_edge, cut):
    """Distances under 16, of 16, at the ring's reach and past it, a DLT
    block longer than the ring, chunk resets; then the same with the rc
    or bc array cut inside a buffered word."""
    cases, (rc, bc, rce, bce), wnd_size = k1_edge
    ends = {"rc": rce, "bc": bce}.get(cut)
    if cut:
        used = np.where(ends < 0x7FFFFFFF, ends, 0).max(axis=1)
        n = int(np.sort(used)[len(used) // 2]) - 3 | 1
        rc = edges.cut(rc, n) if cut == "rc" else rc
        bc = edges.cut(bc, n) if cut == "bc" else bc
    wnd, _, pos, done, err, _ = _k1_against_plain(
        dev, (rc, bc, rce, bce), wnd_size, 10 ** 7)
    if cut:
        assert err[used > n].all()
    else:
        for i, (name, _, data) in enumerate(cases):
            assert done[i] == 1 and err[i] == 0, name
            assert wnd[i, :pos[i]].tobytes() == data, name


@pytest.mark.parametrize("where", ["copy", "literal"])
def test_k1_step_cap_inside(dev, k1_edge, where):
    _, arrays, wnd_size = k1_edge
    cap = edges.caps_inside([a[:1] for a in arrays], wnd_size, 0,
                            4000)[where]
    for steps in (cap, cap + 1):
        _k1_against_plain(dev, arrays, wnd_size, steps)


def test_k1_two_blocks_per_sm(dev):
    assert decode_kernel.blocks_per_sm() == 2


def _k2_edge_args(level, dev, tcap=None):
    cases = edges.k2_cases(level)
    prs = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    ins = pipeline.group_inputs(prs, plans, list(range(len(cases))), dev)
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        ins[0], ins[1], prs[0].hash_bits, prs[0].hash_width))
    tcap = tcap or parse_scan.tape_capacity(ins[0].shape[1], ins[1].shape[1])
    return (ins[0], candp, *ins[1:], prs[0].good_len, tcap)


@pytest.mark.parametrize("level,tcap", [(1, None), (2, None), (1, 7)])
def test_k2_edge_streams_match_plain(dev, level, tcap):
    """Lane-stride edges, limits that are no multiple of 32, the HT2
    quirk, good_len mid-fold, C = 3 and 10; and a tape too short."""
    args = _k2_edge_args(level, dev, tcap)
    got = parse_kernel.parse_k2(*args)
    torch.cuda.synchronize()
    want = parse_scan.parse_plain(*(a.cpu() if torch.is_tensor(a) else a
                                    for a in args))
    for name, g, w in zip(("tape", "tok_cnt", "done", "err"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    assert bool(got[3].any()) == (tcap is not None)


@pytest.mark.parametrize("case", [c[0] for c in edges.k3_cases()])
def test_k3_edge_tapes_match_plain(dev, case):
    """Every token kind, slot edges of lengths and distances, long runs,
    flushes, clipped maps and chunk log, capacity cuts, passes that
    overrun the record ring, a tape without K_END, random tapes."""
    _, tapes, args, _ = next(c for c in edges.k3_cases() if c[0] == case)
    launches = bits_kernel.LAUNCHES
    got = bits_kernel.code_k3(*(torch.from_numpy(t).to(dev) for t in tapes),
                              *args)
    torch.cuda.synchronize()
    assert bits_kernel.LAUNCHES == launches + 1
    want = bits_scan.bits_plain(*(torch.from_numpy(t) for t in tapes), *args)
    for name, g, w in zip(("rc", "bc", "rc_map", "bc_map", "chunk_log",
                           "stats"), got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"{case} {name}")


def test_one_mb_round_trips_through_k2_k3_k1(dev):
    """A 1 MB stream is too long for the lockstep plain versions: it must
    come back byte-exact through K2 -> K3 (encode) and K1 (decode), with
    done = 1 and err = 0."""
    data = corpus.torch_python_text(2 * 1024 * 1024)[1024 * 1024:]
    p = props_init(len(data), 1)
    p.DLTFilter = p.EXEFilter = p.TXTFilter = 0    # the window is the data
    launches = (parse_kernel.LAUNCHES, bits_kernel.LAUNCHES)
    blob = pipeline.encode_batch([p], [data], device=dev)[0]
    assert (parse_kernel.LAUNCHES, bits_kernel.LAUNCHES) == tuple(
        n + 1 for n in launches)
    rc, bc, rce, bce = pipeline._demux([p], [blob], [0])
    wnd, _, pos, done, err, _ = decode_kernel.decode_k1(
        *(torch.from_numpy(a).to(dev) for a in (rc, bc, rce, bce)),
        pipeline._bucket(len(data)), 1 << 62)
    assert int(done[0]) == 1 and int(err[0]) == 0
    assert wnd[0, :int(pos[0])].cpu().numpy().tobytes() == data
    assert pipeline.decode_batch([p], [blob], device=dev) == [data]


def test_kernel_ab_against_this_checkout(dev, tmp_path):
    """The A/B tool, with this checkout as the other one: every cell is
    timed for both builds (whose outputs it holds equal), and both
    builds' resources are read."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "ab.json"
    res = kernel_ab.main(["--other", root, "--json", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert sorted(res["cells"]) == sorted([
        "K1 headline 128 x 16 KB", "K1 extract 256 x 1 MB",
        "K2 m1 96 x 16 KB", "K2 m2 96 x 16 KB", "K2 task 4 x 1 MB",
        "K3 m1 96 x 16 KB", "K3 m2 96 x 16 KB", "K3 task 4 x 1 MB",
        "K4 m3 32 x 16 KB", "K4 m4 32 x 16 KB", "K4 m5 32 x 16 KB",
        "K4 m3 1024 x 16 KB", "K4 m3 4096 x 16 KB", "K4 task m3 4 x 1 MB",
        "K5 m1 96 x 16 KB", "K5 m2 96 x 16 KB", "K5 m1 1024 x 16 KB",
        "K5 m1 4096 x 16 KB", "K5 task m1 4 x 1 MB",
        "K6 m3 96 x 16 KB", "K6 m4 96 x 16 KB", "K6 m3 1024 x 16 KB",
        "K6 task m3 4 x 1 MB", "K6 m3 ring 96 x 48 KB",
        "K6 m3 past the cap 4.67 MB", "K6 m3 past -d 1m 4.67 MB",
        "K6 m5 96 x 16 KB",
        "K6 m5 1024 x 16 KB", "K6 task m5 4 x 1 MB",
        "K6 m5 past the cap 4.67 MB"])
    for cell in res["cells"].values():
        assert sorted(cell["ms"]) == ["other", "this"]
        assert all(t > 0 for t in cell["ms"].values())
    for name in ("K3 m1 96 x 16 KB", "K3 m2 96 x 16 KB", "K3 task 4 x 1 MB"):
        longest = res["cells"][name]["longest"]
        assert longest["modelled_bits"] > longest["tape_entries"] > 0
    this, other = res["resources"]["this"], res["resources"]["other"]
    assert this["csc_k1"].pop("blocks_per_sm") == 2
    assert this == other


# ------------------------------------------------- K4, the optimal parse
K4_FIELDS = ("tape", "tok_cnt", "done", "err", "finds")


def _k4_args(cases, dev, tcap=None, max_steps=None):
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    ins = pipeline.group_inputs(props, plans, list(range(len(cases))), dev)
    p0 = props[0]
    candp = parse_pre.pack_candidates(parse_pre.precompute_candidates(
        ins[0], ins[1], p0.hash_bits, p0.hash_width or 8))
    pr = torch.from_numpy(prices.pack_prices(prices.snapshot_prices()))
    n, r = ins[0].shape[1], ins[1].shape[1]
    return (ins[0], candp, *ins[1:], pr.to(dev), p0.good_len,
            tcap or parse_scan.tape_capacity(n, r),
            max_steps or parse_ap_scan.max_steps_for(n))


def _k4_against_plain(args):
    launches = parse_ap_kernel.LAUNCHES
    got = parse_ap_kernel.parse_k4(*args)
    torch.cuda.synchronize()
    assert parse_ap_kernel.LAUNCHES == launches + 1
    want = parse_ap_scan.parse_ap_plain(*(a.cpu() if torch.is_tensor(a)
                                          else a for a in args))
    for name, g, w in zip(K4_FIELDS, got, want, strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("level", [3, 4, 5])
def test_k4_matches_plain(dev, level):
    """The streams the plain version is held to csc_tpu with and K4's
    edge streams (runs across the sub-block end, extensions past 8
    rounds at stretch starts, the AP_LIMIT cap, the last column)."""
    for cases in (edges.ap_cases(level), edges.k4_cases(level)):
        got = _k4_against_plain(_k4_args(cases, dev))
        assert bool(got[2].all()) and not bool(got[3].any())


@pytest.mark.parametrize("tcap,max_steps", [(7, None), (None, 1234)])
def test_k4_tape_overflow_and_step_budget(dev, tcap, max_steps):
    got = _k4_against_plain(_k4_args(edges.k4_cases(3), dev, tcap,
                                     max_steps))
    err = constants.ERR_OVERFLOW if tcap else constants.ERR_STEPS
    assert bool((got[3] == err).any())


def _k4_cells_against_plain(args, dev, good_len, max_steps=None):
    """K4 launched on the card with its debug copy of the cells against
    the plain version's outputs and cells (on the CPU), and K4 through its
    wrapper with no copy (the encode path's launch) against both; K4's
    outputs (tape, tok_cnt, done, err, finds)."""
    n, r = args[0].shape[1], args[2].shape[1]
    b = args[0].shape[0]
    tcap = parse_scan.tape_capacity(n, r)
    max_steps = max_steps or parse_ap_scan.max_steps_for(n)
    card = tuple(a.to(dev) for a in args)
    tape = torch.zeros((b, tcap, 2), dtype=torch.int32, device=dev)
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    cells = parse_ap_kernel.new_cells(b, n, dev)
    parse_ap_kernel.launch(_build.kernel_library("csc_k4"), *card, good_len,
                           tape, max_steps, cells, out)
    got = (tape, *out)
    bare = parse_ap_kernel.parse_k4(*card, good_len, tcap, max_steps)
    want, want_cells = plain_cells(args, good_len, max_steps)
    for name, g, w in zip(K4_FIELDS + ("cells",), got + (cells,),
                          want + (want_cells,), strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), np.asarray(w),
                                      err_msg=name)
    for name, g, w in zip(K4_FIELDS, bare, got, strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                      err_msg=f"{name} with no cell copy")
    return got


@pytest.mark.parametrize("case", ["lanes4", "lanes10_24", "lanes10_48",
                                  "last600", "last601", "top"])
def test_k4_window_cases_match_plain(dev, case):
    """The window cases of tests/test_torch_k4_window.py: every lane
    recording at C = 4 and C = 10, the last column at width n and n + 1,
    a stretch to the window's top at good_len 48."""
    if case == "top":
        c = edges.k4_top_cases()
        args = _k4_args(c, torch.device("cpu"))[:7]
        good_len = c[0][1].good_len
    elif case.startswith("last"):
        args = edges.k4_lane_inputs(4, width=int(case[4:]), last=True)
        good_len = 16
    else:
        ncand, good_len = {"lanes4": (4, 16), "lanes10_24": (10, 24),
                           "lanes10_48": (10, 48)}[case]
        args = edges.k4_lane_inputs(ncand)
    got = _k4_cells_against_plain(args, dev, good_len)
    assert bool(got[2].all()) and not bool(got[3].any())


def test_k4_step_budget_across_a_long_position(dev):
    """Every budget from before to after the first position whose
    candidate extends 120 bytes (4 lockstep steps): tape, counts, err
    and cells equal the plain version's."""
    args = edges.k4_lane_inputs(4)
    errs = set()
    for t in range(592, 612):
        got = _k4_cells_against_plain(args, dev, 16, max_steps=t)
        errs.add(int(got[3][0]))
    assert errs == {constants.ERR_STEPS}


def test_k4_unstaged_stream_matches_plain(dev):
    """A stream just over 64 KB, whose data K4 reads from device memory
    rather than staging it in shared memory, cut by a step budget so that
    the plain version stays short: outputs and cells equal the plain
    version's."""
    text = corpus.torch_python_text(256 * 1024)
    data = text[:66 * 1024 + 300]
    args = _k4_args([("big", props_init(len(data), 3), data)],
                    torch.device("cpu"))[:7]
    assert args[0].shape[1] > 64 * 1024
    got = _k4_cells_against_plain(args, dev, 16, max_steps=3000)
    assert int(got[3][0]) == constants.ERR_STEPS and int(got[4][0]) > 500


def test_m3_streams_through_k4_k3_k1_equal_the_cpus(dev):
    """m3 streams encoded on the card (K4 and K3 launched once each) are
    the CPU's (the plain versions) byte for byte and decode through K1;
    a 256 KB stream, too long for the plain versions, round-trips on the
    card alone."""
    text = corpus.torch_python_text(1024 * 1024)
    datas = [text[:3000], text[5000:6500], b"A" * 700 + text[9000:9800]]
    props = [props_init(len(d), 3) for d in datas]
    launches = (parse_ap_kernel.LAUNCHES, bits_kernel.LAUNCHES)
    card = pipeline.encode_batch(props, datas, device=dev)
    assert (parse_ap_kernel.LAUNCHES, bits_kernel.LAUNCHES) == tuple(
        n + 1 for n in launches)
    assert card == pipeline.encode_batch(props, datas,
                                         device=torch.device("cpu"))
    assert pipeline.decode_batch(props, card, device=dev) == datas
    for p, blob, data in zip(props, card, datas):
        assert decompress_stream(p, blob, 0) == data
    big = text[512 * 1024:768 * 1024]
    p = props_init(len(big), 3)
    blob = pipeline.encode_batch([p], [big], device=dev)[0]
    assert pipeline.decode_batch([p], [blob], device=dev) == [big]


# --------------------------------------------------- K5, the exact parse
K5_FIELDS = ("tape", "tok_cnt", "done", "err", "steps", "btypes")


def _k5_against_plain(args, dev):
    """K5 on the card against the plain version (on the CPU) on the same
    arguments, every field."""
    card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    got = exact_kernel.parse_k5(*card)
    want = exact_scan.exact_plain(*args)
    for name, g, w in zip(K5_FIELDS, got, want, strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("level,lz_mode", [(1, None), (2, None), (1, 1)])
def test_k5_matches_plain(dev, level, lz_mode):
    """The edge streams of the exact parse (tests/torch_edge_cases.py
    `exact_cases`): tape, tok_cnt, done, err and steps."""
    got = _k5_against_plain(exact_args(edges.exact_cases(level, lz_mode)),
                            dev)
    assert bool(got[2].all()) and not bool(got[3].any())


def test_k5_matches_plain_on_nolz_cases(dev):
    """Every run type golden codes (tests/torch_edge_cases.py
    `exact_nolz_cases`: BAD, ENTROPY and DLT runs, the duplicate-block
    probe's hit and the DT_SKIP block that follows it, small raw chunks)
    at m1: every field, the block types included."""
    got = _k5_against_plain(exact_args(edges.exact_nolz_cases(1)), dev)
    assert bool(got[2].all()) and not bool(got[3].any())
    assert int(got[5][3, 2]) == constants.DT_NORMAL


@pytest.mark.parametrize("level", [1, 2])
def test_k5_step_budget(dev, level):
    """A tape too short (ERR_OVERFLOW) and step budgets cut across a
    short group: K5 stops at the token where the lockstep version stops
    (ERR_STEPS, steps = the budget)."""
    cases = edges.exact_small_cases(level)
    got = _k5_against_plain(exact_args(cases, tcap=32), dev)
    assert (got[3] == constants.ERR_OVERFLOW).any()
    full = exact_args(cases)
    total = int(exact_scan.exact_plain(*full)[4].max())
    for budget in (0, 1, 7, total // 3, total // 2, total - 1, total):
        got = _k5_against_plain(full[:9] + (budget,), dev)
        assert bool((got[3] == constants.ERR_STEPS).any()) == (
            budget < total)


def test_k5_launches_on_a_cuda_tensor(dev, monkeypatch):
    """parse_k5 on CUDA tensors launches K5 (LAUNCHES counts it) and never
    runs the plain version; on another device it raises."""
    def plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")
    args = exact_args(edges.exact_small_cases(1))
    card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    monkeypatch.setattr(exact_scan, "exact_plain", plain)
    before = exact_kernel.LAUNCHES
    got = exact_kernel.parse_k5(*card)
    assert exact_kernel.LAUNCHES == before + 1
    assert got[0].device.type == "cuda" and bool(got[2].all())
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError, match="CUDA"):
        exact_kernel.parse_k5(*meta)


def test_k5_data_off_a_word_boundary(dev):
    """Data of whole words a row in a contiguous view that starts one
    byte past a word: K5 stages it byte by byte (no misaligned word
    load) and gives the plain version's every field."""
    cases = edges.exact_small_cases(1)
    n = exact_args(cases)[0].shape[1]
    args = exact_args(cases, width=n + (-n) % 4)
    data = args[0]
    buf = torch.zeros(data.numel() + 1, dtype=torch.uint8, device=dev)
    view = buf[1:].view(data.shape)
    view.copy_(data)
    assert view.is_contiguous() and view.data_ptr() % 4 == 1
    card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args[1:])
    got = exact_kernel.parse_k5(view, *card)
    want = exact_scan.exact_plain(*args)
    for name, g, w in zip(K5_FIELDS, got, want, strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


# chip_smoke.py's budget for K5's plain job: about 40 % of a 16 KB m1
# stream's micro-ops, a few hundred tokens into a 1 MB one
K5_PLAIN_STEPS = 40_000


def test_k5_task_matches_plain_under_a_budget(dev):
    """The 4 x 1 MB m1 task (data past K5's 64 KB staging, read from
    device memory) cut at K5_PLAIN_STEPS: every field of the plain
    version's."""
    text = corpus.torch_python_text(8 * 1024 * 1024)
    mb = 1024 * 1024
    cases = [("task", props_init(mb, 1), text[i * mb:(i + 1) * mb])
             for i in range(4)]
    args = exact_args(cases, max_steps=K5_PLAIN_STEPS)
    assert args[0].shape[1] > 64 * 1024
    got = _k5_against_plain(args, dev)
    assert (got[3] == constants.ERR_STEPS).all()
    assert (got[4] == K5_PLAIN_STEPS).all()


def test_k5_relaunch_gives_the_same_outputs(dev):
    """K5 launched twice on the same 96 x 16 KB m1 and m2 text (a dozen
    warps an SM share its L2 and issue slots, so a lane hazard would
    show as a difference) gives the same tape and counters."""
    text = corpus.torch_python_text(4 * 1024 * 1024)
    kb = 16 * 1024
    for level in (1, 2):
        cases = [("t", props_init(kb, level), text[i * kb:(i + 1) * kb])
                 for i in range(96)]
        card = tuple(a.to(dev) if torch.is_tensor(a) else a
                     for a in exact_args(cases))
        first = exact_kernel.parse_k5(*card)
        second = exact_kernel.parse_k5(*card)
        assert bool(first[2].all()) and not bool(first[3].any())
        for name, a, b in zip(K5_FIELDS, first, second, strict=True):
            assert torch.equal(a, b), name


def test_exact_streams_through_k5_k3_k1(dev):
    """Exact m1 and m2 streams encoded on the card (K5 and K3 launched
    once each) are the CPU's (the plain versions) and golden's byte for
    byte and decode through K1; a 96 KB stream, too long for the plain
    versions, is golden's and round-trips on the card alone."""
    text = corpus.torch_python_text(1024 * 1024)
    exe = corpus.torch_library_exe()
    datas = [text[:3000], exe[len(exe) // 2:len(exe) // 2 + 2000],
             b"A" * 700 + text[9000:9800]]
    for level in (1, 2):
        props = [props_init(len(d), level) for d in datas]
        launches = (exact_kernel.LAUNCHES, bits_kernel.LAUNCHES,
                    parse_kernel.LAUNCHES)
        card = pipeline.encode_batch(props, datas, device=dev,
                                     parse="exact")
        assert (exact_kernel.LAUNCHES, bits_kernel.LAUNCHES,
                parse_kernel.LAUNCHES) == (launches[0] + 1, launches[1] + 1,
                                           launches[2])
        assert card == pipeline.encode_batch(
            props, datas, device=torch.device("cpu"), parse="exact")
        assert pipeline.decode_batch(props, card, device=dev) == datas
        for p, blob, data in zip(props, card, datas):
            assert blob == encode_stream(p, data)
    big = text[300 * 1024:396 * 1024]
    p = props_init(len(big), 1)
    blob = pipeline.encode_batch([p], [big], device=dev, parse="exact")[0]
    assert blob == encode_stream(p, big)
    assert pipeline.decode_batch([p], [blob], device=dev) == [big]


def test_k5_matches_plain_on_the_ring(dev):
    """48 KB under a 36 KB dictionary (the window a ring off the 8 KB
    grid, a BAD run across its end, torch_edge_cases.ring48): K5 gives
    the plain version's every field."""
    got = _k5_against_plain(exact_args([edges.ring48(1)]), dev)
    assert bool(got[2].all()) and not bool(got[3].any())
    assert constants.DT_BAD in got[5][0].tolist()


@pytest.mark.parametrize("level", [1, 2])
def test_encode_past_the_dictionary_is_golden(dev, level):
    """encode_batch on the card (fast parse, routed to the exact one) of
    streams longer than their dictionary: torch_ring_cases' mixed (four
    laps, BAD / EXE / DLT runs, a probe hit across a wrap), chunks (two
    raw chunks) and quirks (each ring rule made visible) are golden's
    bytes and decode through K1."""
    cases = [ring.mixed(level), ring.chunks(level), ring.quirks(level)]
    props = [c[1] for c in cases]
    datas = [c[2] for c in cases]
    launches = exact_kernel.LAUNCHES
    card = pipeline.encode_batch(props, datas, device=dev)
    assert exact_kernel.LAUNCHES > launches
    for (name, p, data), blob in zip(cases, card):
        assert len(data) > p.dict_size, name
        assert blob == encode_stream(p, data), name
    assert pipeline.decode_batch(props, card, device=dev) == datas


# ------------------------------------- K6, the exact optimal parse (m3/m4)
K6_FIELDS = ("tape", "tok_cnt", "done", "err", "btypes")


def _k6_against_plain(args, dev):
    launches = exact_ap_kernel.LAUNCHES
    card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    got = exact_ap_kernel.parse_k6(*card)
    torch.cuda.synchronize()
    assert exact_ap_kernel.LAUNCHES == launches + 1
    want = exact_ap_scan.exact_ap_plain(*args)
    for name, g, w in zip(K6_FIELDS, got, want, strict=True):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    return got


@pytest.mark.parametrize("level", [3, 4])
def test_k6_matches_plain(dev, level):
    """The edge streams of the exact optimal parse (torch_edge_cases
    `exact_ap_cases`: every run type, the probe, raw chunks, a stretch at
    AP_LIMIT, the length cache rebuilt) and K5's (`exact_cases`,
    `k5_lane_cases`) at m3 / m4: every field."""
    for cases in (edges.exact_ap_cases(level), edges.exact_cases(level),
                  edges.k5_lane_cases(level)):
        got = _k6_against_plain(k6_args(cases), dev)
        assert bool(got[2].all()) and not bool(got[3].any())


@pytest.mark.parametrize("tcap", [1, 40, 700])
def test_k6_tape_overflow(dev, tcap):
    """A tape too short: K6 stops at the token where the plain version
    stops (done 0, ERR_OVERFLOW, tok_cnt the capacity)."""
    cases = [c for c in edges.exact_ap_cases(3)
             if c[0] in ("text", "dlt", "entropy_lz", "chunks")]
    got = _k6_against_plain(k6_args(cases, tcap=tcap), dev)
    assert (got[3] == constants.ERR_OVERFLOW).any()


def test_k6_launches_on_a_cuda_tensor(dev, monkeypatch):
    """parse_k6 on CUDA tensors launches K6 (LAUNCHES counts it) and never
    runs the plain version; on another device it raises."""
    def plain(*args, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")
    args = k6_args(edges.exact_small_cases(3))
    card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    monkeypatch.setattr(exact_ap_scan, "exact_ap_plain", plain)
    before = exact_ap_kernel.LAUNCHES
    got = exact_ap_kernel.parse_k6(*card)
    assert exact_ap_kernel.LAUNCHES == before + 1
    assert got[0].device.type == "cuda" and bool(got[2].all())
    meta = tuple(a.to("meta") if torch.is_tensor(a) else a for a in args)
    with pytest.raises(ValueError, match="CUDA"):
        exact_ap_kernel.parse_k6(*meta)


def test_k6_relaunch_gives_the_same_outputs(dev):
    """K6 launched twice on the same 96 x 16 KB m3 and m4 text gives the
    same tape, counters and block types, and its first streams equal the
    plain version's."""
    text = corpus.torch_python_text(4 * 1024 * 1024)
    kb = 16 * 1024
    for level in (3, 4):
        cases = [("t", props_init(kb, level), text[i * kb:(i + 1) * kb])
                 for i in range(96)]
        args = k6_args(cases)
        card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
        first = exact_ap_kernel.parse_k6(*card)
        second = exact_ap_kernel.parse_k6(*card)
        assert bool(first[2].all()) and not bool(first[3].any())
        for name, a, b in zip(K6_FIELDS, first, second, strict=True):
            assert torch.equal(a, b), name
        want = exact_ap_scan.exact_ap_plain(*(a[:3] if torch.is_tensor(a)
                                              else a for a in args))
        for name, g, w in zip(K6_FIELDS, first, want, strict=True):
            np.testing.assert_array_equal(g[:3].cpu().numpy(), w.numpy(),
                                          err_msg=name)


def test_exact_ap_streams_through_k6_k3_k1(dev):
    """Exact m3 and m4 streams encoded on the card (K6 and K3 launched
    once each, no K4) are the CPU's (the plain versions) and golden's
    byte for byte and decode through K1; a 96 KB stream, long for the
    plain K3, is golden's and round-trips on the card alone."""
    text = corpus.torch_python_text(1024 * 1024)
    exe = corpus.torch_library_exe()
    datas = [text[:3000], exe[len(exe) // 2:len(exe) // 2 + 2000],
             b"A" * 700 + text[9000:9800]]
    for level in (3, 4):
        props = [props_init(len(d), level) for d in datas]
        launches = (exact_ap_kernel.LAUNCHES, bits_kernel.LAUNCHES,
                    parse_ap_kernel.LAUNCHES)
        card = pipeline.encode_batch(props, datas, device=dev,
                                     parse="exact")
        assert (exact_ap_kernel.LAUNCHES, bits_kernel.LAUNCHES,
                parse_ap_kernel.LAUNCHES) == (
            launches[0] + 1, launches[1] + 1, launches[2])
        assert card == pipeline.encode_batch(
            props, datas, device=torch.device("cpu"), parse="exact")
        assert pipeline.decode_batch(props, card, device=dev) == datas
        for p, blob, data in zip(props, card, datas):
            assert blob == encode_stream(p, data)
    big = text[300 * 1024:396 * 1024]
    p = props_init(len(big), 3)
    blob = pipeline.encode_batch([p], [big], device=dev, parse="exact")[0]
    assert blob == encode_stream(p, big)
    assert pipeline.decode_batch([p], [blob], device=dev) == [big]


# --------------------------------- K6 with m5's binary tree (k6<true>)
def test_k6_tree_matches_plain(dev):
    """The tree's edge streams (torch_edge_cases `exact_bt_cases`: long
    walks, good_len exits, lengths past the length cache, more records
    than find_match keeps, the head candidate and bt_pos wrapping under a
    bt_size of 4 KB beside streams of 74 KB, BAD / ENTROPY / DLT runs and
    a probe hit) and golden's IndexError stream (`bt_fault_case`, ERR_BT):
    every field."""
    cases = edges.exact_bt_cases() + [edges.bt_fault_case()]
    got = _k6_against_plain(k6_args(cases), dev)
    assert got[3].tolist() == [0] * (len(cases) - 1) + [constants.ERR_BT]


@pytest.mark.parametrize("tcap", [1, 700])
def test_k6_tree_tape_overflow(dev, tcap):
    """A tape too short stops K6's tree parse at the plain version's
    token."""
    cases = [c for c in edges.exact_bt_cases()
             if c[0] in ("repeat", "cap", "dup_skip")]
    got = _k6_against_plain(k6_args(cases, tcap=tcap), dev)
    assert (got[3] == constants.ERR_OVERFLOW).any()


def test_k6_tree_relaunch_gives_the_same_outputs(dev):
    """K6's tree launched twice on the same 96 x 16 KB m5 text gives the
    same tape, counters and block types, and its first streams equal the
    plain version's."""
    text = corpus.torch_python_text(4 * 1024 * 1024)
    kb = 16 * 1024
    cases = [("t", props_init(kb, 5), text[i * kb:(i + 1) * kb])
             for i in range(96)]
    args = k6_args(cases)
    card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    first = exact_ap_kernel.parse_k6(*card)
    second = exact_ap_kernel.parse_k6(*card)
    assert bool(first[2].all()) and not bool(first[3].any())
    for name, a, b in zip(K6_FIELDS, first, second, strict=True):
        assert torch.equal(a, b), name
    want = exact_ap_scan.exact_ap_plain(*(a[:2] if torch.is_tensor(a)
                                          else a for a in args))
    for name, g, w in zip(K6_FIELDS, first, want, strict=True):
        np.testing.assert_array_equal(g[:2].cpu().numpy(), w.numpy(),
                                      err_msg=name)


def test_exact_m5_streams_through_k6_k3_k1(dev):
    """Exact m5 streams encoded on the card (K6's tree and K3 launched
    once each, no K4) are the CPU's and golden's byte for byte and decode
    through K1; a 96 KB stream is golden's and round-trips on the card
    alone."""
    text = corpus.torch_python_text(1024 * 1024)
    exe = corpus.torch_library_exe()
    datas = [text[:3000], exe[len(exe) // 2:len(exe) // 2 + 2000],
             b"A" * 700 + text[9000:9800]]
    props = [props_init(len(d), 5) for d in datas]
    launches = (exact_ap_kernel.LAUNCHES, bits_kernel.LAUNCHES,
                parse_ap_kernel.LAUNCHES)
    card = pipeline.encode_batch(props, datas, device=dev, parse="exact")
    assert (exact_ap_kernel.LAUNCHES, bits_kernel.LAUNCHES,
            parse_ap_kernel.LAUNCHES) == (
        launches[0] + 1, launches[1] + 1, launches[2])
    assert card == pipeline.encode_batch(
        props, datas, device=torch.device("cpu"), parse="exact")
    assert pipeline.decode_batch(props, card, device=dev) == datas
    for p, blob, data in zip(props, card, datas):
        assert blob == encode_stream(p, data)
    big = text[300 * 1024:396 * 1024]
    p = props_init(len(big), 5)
    blob = pipeline.encode_batch([p], [big], device=dev, parse="exact")[0]
    assert blob == encode_stream(p, big)
    assert pipeline.decode_batch([p], [blob], device=dev) == [big]


# ---------------------------- K6 past the dictionary (its ring kernels)
def _staged_ring_batch(cases):
    """K6's arguments of the cases of at most 64 KB: a batch whose
    streams the kernel stages in shared memory (csc_k6_smem holds their
    words)."""
    args = k6_args([c for c in cases if len(c[2]) <= 64 * 1024])
    assert exact_ap_kernel.smem_bytes(args[0].shape[1]) >= args[0].shape[1]
    return args


@pytest.mark.parametrize("level", [3, 4])
def test_k6_ring_matches_plain(dev, level):
    """Streams longer than their dictionary at m3 / m4 (torch_edge_cases
    `exact_ap_ring_cases`: ring ends off the 8 KB grid, the literal priced
    at ring position 0, sources stopped at the ring's end, BAD / ENTROPY /
    DLT runs and a probe hit across a wrap, raw chunks; torch_ring_cases'
    mixed and quirks) beside streams their dictionary covers, in one
    launch of both kernels, the batch past 64 KB (unstaged), and those of
    at most 64 KB (lit0, cut and the covered ones) as a staged batch of
    their own: every field."""
    cases = (edges.exact_ap_ring_cases(level) + [ring.mixed(level),
             ring.quirks(level)] + edges.exact_ap_cases(level)[:2])
    for args in (k6_args(cases), _staged_ring_batch(cases)):
        got = _k6_against_plain(args, dev)
        assert bool(got[2].all()) and not bool(got[3].any())
        assert bool((args[2] > args[3]).any())


@pytest.mark.parametrize("level", [3, 4])
def test_k6_far_back_cells_match_plain(dev, level):
    """Cells entered from as far back as a relaxed length reaches
    (torch_edge_cases `exact_ap_far_cases`: good_len - 1 behind, by a
    match and by a rep, at the level's good_len and at 32; a stretch at
    AP_LIMIT), streams their dictionary covers and streams past a 32 KB
    one (the ring kernel), staged and, at a width past 64 KB, unstaged:
    every field."""
    for past in (False, True):
        for good_len in (None, 32):
            cases = edges.exact_ap_far_cases(level, past, good_len)
            for width in (None, 64 * 1024 + 4):
                got = _k6_against_plain(k6_args(cases, width), dev)
                assert bool(got[2].all()) and not bool(got[3].any())


def test_k6_tree_ring_matches_plain(dev):
    """The tree's ring kernel (m5 past the dictionary, so past bt_size:
    torch_edge_cases `exact_bt_ring_cases`, whose `fault` golden raises
    IndexError on, and torch_ring_cases' mixed, which it raises on too)
    beside the covered tree's edge streams, in one launch of both
    kernels, the batch past 64 KB (unstaged), and cut, ring48 and the
    covered ones as a staged batch of their own: every field, ERR_BT
    where golden raises."""
    cases = (edges.exact_bt_ring_cases() + [ring.mixed(5)]
             + edges.exact_bt_cases()[:3])
    got = _k6_against_plain(k6_args(cases), dev)
    assert got[3].tolist() == [0, 0, constants.ERR_BT, constants.ERR_BT,
                               0, 0, 0]
    args = _staged_ring_batch(cases)
    assert int((args[2] > args[3]).sum()) == 2
    got = _k6_against_plain(args, dev)
    assert bool(got[2].all()) and not bool(got[3].any())


@pytest.mark.parametrize("level", [3, 4])
def test_encode_past_the_dictionary_is_golden_at_m3_m4(dev, level):
    """encode_batch on the card (the fast parse, routed to the exact one:
    K6's ring kernel, no K4) of m3 / m4 streams longer than their
    dictionary gives golden's bytes, which decode through K1."""
    cases = edges.exact_ap_ring_cases(level)
    props = [c[1] for c in cases]
    datas = [c[2] for c in cases]
    launches = (exact_ap_kernel.LAUNCHES, parse_ap_kernel.LAUNCHES)
    card = pipeline.encode_batch(props, datas, device=dev)
    assert exact_ap_kernel.LAUNCHES > launches[0]
    assert parse_ap_kernel.LAUNCHES == launches[1]
    for (name, p, data), blob in zip(cases, card):
        assert len(data) > p.dict_size, name
        assert blob == encode_stream(p, data), name
    assert pipeline.decode_batch(props, card, device=dev) == datas


def test_k6_phase_build_equals_k6(dev):
    """K6 built with its phase clocks (-DK6_PHASES, csc_tpu_torch/
    k6_phases.py) gives K6's every field on the tree's and the ring's
    edge streams (the tree's ring ones unstaged and staged) and on 96 x
    16 KB m5 text, and its clocks count block 0's finds and walk
    steps."""
    from csc_tpu_torch import k6_phases
    lib = k6_phases.library()
    text = corpus.torch_python_text(4 * 1024 * 1024)
    kb = 16 * 1024
    head = [("t", props_init(kb, 5), text[i * kb:(i + 1) * kb])
            for i in range(96)]
    bt_ring = edges.exact_bt_ring_cases()
    for args in (k6_args(edges.exact_bt_cases()), k6_args(bt_ring),
                 _staged_ring_batch(bt_ring),
                 k6_args(edges.exact_ap_ring_cases(3)), k6_args(head)):
        card = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
        want = exact_ap_kernel.parse_k6(*card)
        got, clocks = k6_phases.run(lib, card)
        for name, g, w in zip(K6_FIELDS, got, want, strict=True):
            assert torch.equal(g, w), name
        counts = dict(zip(k6_phases.COUNTS, clocks[len(k6_phases.PHASES):]))
        assert counts["finds"] > 0 and sum(clocks[:len(k6_phases.PHASES)])
        if args[0].shape[0] == len(head):
            assert counts["walk_steps"] > counts["finds"] > 8000


@pytest.mark.parametrize("sized", [True, False])
def test_block_log_past_max_blocks_on_the_card(dev, monkeypatch, sized):
    """K1's block log sized from the stream, on cuda:0
    (test_torch_pipeline.py's CPU tests)."""
    p, data, blob = edges.k1_block_log_case()
    monkeypatch.setattr(constants, "MAX_BLOCKS", 4)
    launches = decode_kernel.LAUNCHES
    assert pipeline.decode_batch([p], [blob], out_sizes=[len(data)]
                                 if sized else None, device=dev) == [data]
    assert decode_kernel.LAUNCHES == launches + (1 if sized else 2)


# ------------------------------------------------------------- archiver
def _launches():
    return {k: m.LAUNCHES for k, m in (("K1", decode_kernel),
                                       ("K2", parse_kernel),
                                       ("K3", bits_kernel),
                                       ("K5", exact_kernel))}


def test_archiver_round_trip_on_the_card(dev, tmp_path):
    """`a` / `x` / `t` on the card of a 2.5 MB tree whose 1.5 MB file is
    over the 1 MB task cap: several tasks, K2 and K3 (and K5 for the
    index trailer) launched by `a`, K1 by `x` and `t`, the tree restored
    byte-exact."""
    from csc_tpu_torch.archiver import csarc, index
    text = corpus.torch_python_text(2 * 1024 * 1024)
    files = {"big.txt": text[:1536 * 1024],
             "lib.so": corpus.torch_library_exe()[:512 * 1024],
             "ramp.dlt": corpus.dlt_ramp(256 * 1024),
             "sub/a.txt": text[-200 * 1024:],
             "sub/b.txt": text[-300 * 1024:-200 * 1024], "sub/empty": b""}
    make_tree(str(tmp_path / "src"), files)
    arc = str(tmp_path / "card.csa")
    before = _launches()
    assert run_in(tmp_path / "src", csarc.main, ["a", "-r", arc, "."])[0] == 0
    after = _launches()
    assert after["K2"] > before["K2"] and after["K3"] > before["K3"]
    assert after["K5"] == before["K5"] + 1 and after["K1"] == before["K1"]
    with open(arc, "rb") as f:
        _, abi = index.read_trailer(f, dev)
    assert len(abi) >= 4
    out = tmp_path / "out"
    assert csarc.main(["x", "-o", str(out), arc]) == 0
    assert tree_bytes(out) == files
    assert csarc.main(["t", arc]) == 0
    assert _launches()["K1"] >= after["K1"] + 2


@pytest.mark.parametrize("files,opts", [(CROSS_FILES, []),
                                        (TEXT_FILES, ["-m2",
                                                      "--parse=exact"])])
def test_archiver_on_the_card_equals_cpu(dev, tmp_path, files, opts):
    """The card's archive of a tree of a few KB a file is the one the
    plain versions write (--backend=cpu), byte for byte."""
    from csc_tpu_torch.archiver import csarc
    make_tree(str(tmp_path / "src"), files)
    arcs = []
    for backend in ("cuda", "cpu"):
        arcs.append(str(tmp_path / f"{backend}.csa"))
        assert run_in(tmp_path / "src", csarc.main,
                      ["a", "-r", f"--backend={backend}"] + opts
                      + [arcs[-1], "."])[0] == 0
    with open(arcs[0], "rb") as f, open(arcs[1], "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("level,parse", [(1, "fast"), (2, "exact")])
def test_split_over_cuda0_twice_equals_one_device(dev, level, parse):
    """encode_batch_sharded / decode_batch_sharded over [cuda:0, cuda:0]
    on an odd batch equal encode_batch / decode_batch on cuda:0."""
    from csc_tpu_torch.parallel import mesh
    text = corpus.torch_python_text(256 * 1024)
    datas = [text[k * 16384:(k + 1) * 16384] for k in range(5)]
    props = [props_init(len(d), level) for d in datas]
    one = pipeline.encode_batch(props, datas, device=dev, parse=parse)
    assert mesh.encode_batch_sharded(props, datas, devices=[dev, dev],
                                     parse=parse) == one
    sizes = [len(d) for d in datas]
    assert mesh.decode_batch_sharded(props, one, out_sizes=sizes,
                                     devices=[dev, dev]) == datas
    assert mesh.stream_devices()[0] == dev

