"""The exact parse on every run type golden's encoder codes, at m1 on
the CPU: `encode_batch(..., parse="exact", device="cpu")` (K5's plain
version; K3 and K1 through their g++ builds, which
test_torch_k3_edges.py and test_torch_kernel_host.py hold to their plain
versions, as in test_torch_exact_ap_m3.py) on tests/torch_edge_cases.py `exact_nolz_cases` (a
DT_BAD, a DT_ENTROPY and a DT_DLT run, a random block the duplicate-block
probe re-types DT_NORMAL with a DT_SKIP block after it that follows it,
runs cut at small raw chunks) must give the bytes of the golden encoder
(csc_tpu.golden.encoder.encode_stream) and of csc_tpu's encode_batch
under CSC_ENCODE_PARSE=exact (which hands these streams to golden), and
decode back through the golden decoder and the port's decode_batch.
K5's g++ build (encode_k5_host.cpp) is held to the plain version on the
same inputs, every output field and the block types, and at every step
budget around the probes and sparse sub-blocks of three of the streams.
Tolerance 0 throughout.  m2 is in test_torch_exact_nolz_m2.py, so that
test workers spread the levels."""
import collections
import contextlib

import pytest
import torch

from csc_tpu.golden.api import decompress_stream
from csc_tpu.golden.encoder import encode_stream as golden_encode
from csc_tpu_torch.constants import (DT_BAD, DT_DLT, DT_ENTROPY, DT_NORMAL,
                                     ERR_STEPS)
from csc_tpu_torch.ops import encode_host, exact_scan, pipeline

import torch_edge_cases as edges
import torch_ring_cases as ring
from test_torch_exact_host import (assert_same, exact_args, k5,  # noqa: F401
                                   k5_host)

CPU = torch.device("cpu")


@contextlib.contextmanager
def one_thread():
    """The plain versions' ops are small: one intra-op thread runs them
    as fast, and spares them the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def nolz_run(level, monkeypatch, tmp):
    """The cases, the port's streams, K5's arguments and plain outputs as
    the encode path gave them, csc_tpu's streams, golden's streams and
    the port's decode (K3 and K1 built with g++ in tmp)."""
    with one_thread():
        return _nolz_run(level, monkeypatch, tmp)


def _nolz_run(level, monkeypatch, tmp):
    from csc_tpu.ops import pipeline as j_pipeline
    cases = edges.exact_nolz_cases(level)
    props, datas = [c[1] for c in cases], [c[2] for c in cases]
    seen = []

    def on_stage(name, **values):
        if name == "k5":
            seen.append((values["k5_args"], values["k5_out"]))
    k1, k3 = ring.host_builds(tmp, ("k1", "k3"))
    ring.use_host_builds(monkeypatch, (k1, k3, None), ("k1", "k3"))
    ours = pipeline.encode_batch(props, datas, device=CPU, parse="exact",
                                 on_stage=on_stage)
    assert len(seen) == 1
    # K5's rows: the streams in the group's order
    (order, _), = pipeline._groups(props, pipeline.plan_streams(
        props, datas, "exact"))
    monkeypatch.setenv("CSC_ENCODE_PARSE", "exact")
    monkeypatch.setenv("CSC_ENCODE_BITS", "scan")
    ref = []
    for p, data in zip(props, datas):
        ref += j_pipeline.encode_batch([p], [data])
        assert j_pipeline.LAST_ENCODE_FALLBACKS == 1
    gold = [golden_encode(p, data) for p, data in zip(props, datas)]
    back = pipeline.decode_batch(props, ours, device=CPU)
    return dict(cases=cases, ours=ours, k5=seen[0], order=order, ref=ref,
                gold=gold, back=back)


def check_streams(run):
    for (name, p, data), o, r, g in zip(run["cases"], run["ours"],
                                        run["ref"], run["gold"]):
        assert o == g, name
        assert o == r, name
        assert decompress_stream(p, o, 0) == data, name
    assert run["back"] == [c[2] for c in run["cases"]]


def check_types(run):
    """The final block types: the runs golden codes, where the fast
    parse's plan (no probe) differs on the re-typed block and the skipped
    one after it."""
    names = [c[0] for c in run["cases"]]
    btypes = run["k5"][1][5].numpy()
    plans = [encode_host.plan_stream(p, d, exact=True)
             for _, p, d in run["cases"]]
    fast = [encode_host.plan_stream(p, d).runs for _, p, d in run["cases"]]
    got = {n: btypes[run["order"].index(j), :len(plans[j].blocks)].tolist()
           for j, n in enumerate(names)}
    assert got["bad"][0] == DT_BAD
    assert got["entropy"] == [DT_ENTROPY, DT_ENTROPY]
    assert got["dlt"][0] >= DT_DLT and got["dlt"][1] == DT_NORMAL
    assert got["dup_skip"][0] == DT_BAD
    assert got["dup_skip"][2:] == [DT_NORMAL, DT_NORMAL]
    assert got["chunks"] == [DT_BAD, DT_BAD]
    j = names.index("dup_skip")
    assert fast[j][-1][0] == DT_BAD and fast[j][-1][1] == 8192 + 300
    rebuilt = encode_host.exact_run_table(plans[j], got["dup_skip"])
    assert [r[0] for r in rebuilt][-1] == DT_NORMAL
    for j, name in enumerate(names):
        if name != "dup_skip":
            assert encode_host.exact_run_table(
                plans[j], got[name]) == fast[j], name


def check_host(k5, run):
    """K5's g++ build on the encode path's inputs, every field."""
    args, want = run["k5"]
    assert_same(k5_host(k5, args), want)


def check_budget(k5, level):
    """The group of the DT_ENTROPY, DT_DLT and raw-chunk streams, cut at
    every step in and around their probes (E_DUP) and sparse sub-blocks
    (E_SPARSE) and at every 101st: the g++ build stops where the lockstep
    version stops."""
    with one_thread():
        _check_budget(k5, level)


def _check_budget(k5, level):
    cases = [c for c in edges.exact_nolz_cases(level)
             if c[0] in ("entropy", "dlt", "chunks")]
    args = exact_args(cases)
    st, cfg = exact_scan.make_exact_state(*args[:9])
    total, after, picks = 0, 0, {}
    recent = collections.deque(maxlen=3)
    while not bool((st["done"] == 1).all()):
        live = st["fsm"][st["done"] == 0]
        hot = bool(((live == exact_scan.E_DUP)
                    | (live == exact_scan.E_SPARSE)).any())
        st = exact_scan.encode_parse_step(st, cfg)
        total += 1
        out = exact_scan.tape_of(st)
        recent.append((total, out))
        if hot:
            picks.update(recent)
            after = 2
        elif after or total % 101 == 0:
            picks[total] = out
            after = max(after - 1, 0)
    assert len(picks) > 20
    for budget, want in picks.items():
        assert_same(k5_host(k5, args[:9] + (budget,)), want)
    cut = k5_host(k5, args[:9] + (3,))
    assert (cut[3] == ERR_STEPS).all()
    assert cut[5][:, 0].tolist() == [DT_ENTROPY, DT_DLT + 3, DT_BAD]


@pytest.fixture(scope="module")
def m1(request, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    return nolz_run(1, mp, tmp_path_factory.mktemp("nolz_m1"))


def test_m1_nolz_exact_is_golden_and_csc_tpus_and_decodes(m1):
    check_streams(m1)


def test_m1_nolz_block_types_follow_the_probe(m1):
    check_types(m1)


def test_m1_k5_host_matches_plain_on_nolz_cases(k5, m1):
    check_host(k5, m1)


def test_m1_k5_host_step_budget_through_probes_and_sparse_runs(k5):
    check_budget(k5, 1)
