"""K1 (csrc/decode_k1.cu) on a CUDA card against its plain PyTorch
version, and decode_batch through it.  Needs a card; without one every
test here skips.  On a machine with a card (it needs no jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from csc_tpu.golden.decoder import DecodeError
from csc_tpu_torch import corpus
from csc_tpu_torch.ops import decode_kernel, decode_scan, pipeline

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
    blobs = corpus.encode(cases)
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
