"""The port's decode_batch (csc_tpu_torch.ops.pipeline) on CPU, where K1's
wrapper runs the plain PyTorch version, against the JAX scan pipeline
(csc_tpu.ops.pipeline._decode_batch_scan) and the original bytes.  The
streams come from csc_tpu's golden encoder."""
import pytest

from csc_tpu.golden.encoder import encode_stream
from csc_tpu.ops.pipeline import _decode_batch_scan
from csc_tpu_torch import cli, constants, corpus
from csc_tpu_torch.ops import decode_kernel, pipeline
from csc_tpu_torch.ops.pipeline import DecodeError

N = 1536


@pytest.fixture(scope="module")
def cases():
    text = corpus.words(8 * N, seed=3)
    cs = corpus.parity_cases(text, corpus.torch_library_exe(), N, seed=4,
                             chunk=1024, big=40 * 1024)
    return cs, [encode_stream(p, d) for _, p, d in cs]


def test_mixed_batch_matches_scan_and_data(cases):
    cs, blobs = cases
    cs, blobs = cs[:-1], blobs[:-1]
    props = [p for _, p, _ in cs]
    datas = [d for _, _, d in cs]
    sizes = [len(d) for d in datas]
    launches = decode_kernel.LAUNCHES
    ours = pipeline.decode_batch(props, blobs, out_sizes=sizes, device="cpu")
    assert decode_kernel.LAUNCHES == launches   # CPU: the plain version
    ref = _decode_batch_scan(props, blobs, out_sizes=sizes)
    for (name, _, data), o, r in zip(cs, ours, ref):
        assert o == r, name
        assert o == data, name


def test_regrow_without_sizes(cases):
    # dict (32 KB) < output (40 KB) and no declared sizes: the window
    # guess overflows, the stream halts with its would-be position, and
    # decode_batch regrows (pipeline.py:147-158 in csc_tpu)
    name, p, data = cases[0][-2]
    assert name == "dict_lt_output" and p.dict_size < len(data)
    blob = cases[1][-2]
    ours = pipeline.decode_batch([p], [blob], device="cpu")
    assert ours == _decode_batch_scan([p], [blob]) == [data]


def test_corrupt_stream(cases):
    name, p, data = cases[0][-1]
    assert name == "flipped"
    blob = corpus.flip(cases[1][-1])
    try:
        outs = pipeline.decode_batch([p], [blob], out_sizes=[len(data)],
                                     device="cpu")
    except DecodeError:
        return
    # a bit flip that survives decode must at least corrupt the output
    assert outs[0] != data


def test_corrupt_stream_in_batch_names_it(cases):
    cs, blobs = cases
    bad = corpus.flip(blobs[-1])
    with pytest.raises(DecodeError, match=r"\[1\]"):
        pipeline.decode_batch([cs[5][1], cs[-1][1]], [blobs[5], bad],
                              out_sizes=[len(cs[5][2]), len(cs[-1][2])],
                              device="cpu")


def test_block_log_overflow(cases, monkeypatch):
    name, p, data = cases[0][6]
    assert name == "multichunk"           # 3 typed blocks + EOF
    monkeypatch.setattr(constants, "MAX_BLOCKS", 2)
    with pytest.raises(DecodeError, match="block log overflow"):
        pipeline.decode_batch([p], [cases[1][6]], out_sizes=[len(data)],
                              device="cpu")


def test_step_cap_is_an_error(cases):
    name, p, data = cases[0][0]
    with pytest.raises(DecodeError):
        pipeline.decode_batch([p], [cases[1][0]], out_sizes=[len(data)],
                              max_steps=100, device="cpu")


def test_unsupported_device_raises(cases):
    _, p, data = cases[0][0]
    with pytest.raises(ValueError, match="meta"):
        pipeline.decode_batch([p], [cases[1][0]], device="meta")


def test_cli_round_trip_golden(tmp_path):
    """`c` and `d` with --backend cpu (the plain versions) round-trip, and
    `d` decodes a golden-encoded file."""
    from csc_tpu.props import props_init, write_properties
    data = corpus.words(3000, seed=5)
    src, enc, dec = (tmp_path / n for n in ("in.bin", "x.csc", "out.bin"))
    src.write_bytes(data)
    assert cli.main(["c", "-m", "1", "--backend", "cpu", str(src),
                     str(enc)]) == 0
    assert cli.main(["d", "--backend", "cpu", str(enc), str(dec)]) == 0
    assert dec.read_bytes() == data
    gp = props_init(len(data), 1)
    enc.write_bytes(write_properties(gp) + encode_stream(gp, data))
    assert cli.main(["d", "--backend", "cpu", str(enc), str(dec)]) == 0
    assert dec.read_bytes() == data


def test_cli_cuda_backend_needs_a_card(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = tmp_path / "in.bin"
    src.write_bytes(b"abc")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["d", "--backend", "cuda", str(src), str(tmp_path / "o")])
    # cuda is the default backend of both modes
    for mode in ("c", "d"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([mode, str(src), str(tmp_path / "o")])
