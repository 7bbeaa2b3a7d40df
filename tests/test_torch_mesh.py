"""The port's stream-batch split (csc_tpu_torch.parallel.mesh) on the
CPU, where every wrapper runs its plain version: encode_batch_sharded
and decode_batch_sharded over two CPU devices on an odd batch (B = 3,
padded by repeating the last stream, with no divisibility assert) equal
one device's encode_batch / decode_batch, under the fast and the exact
parse; a batch smaller than the device list works too; and
stream_devices raises without a CUDA device."""
import pytest
import torch

from csc_tpu_torch import corpus
from csc_tpu_torch.ops import pipeline
from csc_tpu_torch.parallel import mesh
from csc_tpu_torch.props import props_init, write_properties

CPU = torch.device("cpu")


def _batch(level, n=3):
    datas = [corpus.repetitive(1500 + 300 * k, seed=k) for k in range(n)]
    return [props_init(len(d), level) for d in datas], datas


@pytest.mark.parametrize("level,parse", [(1, "fast"), (2, "fast"),
                                         (2, "exact")])
def test_split_over_two_devices_equals_one(level, parse):
    props, datas = _batch(level)
    one = pipeline.encode_batch(props, datas, device=CPU, parse=parse)
    two = mesh.encode_batch_sharded(props, datas, devices=[CPU, CPU],
                                    parse=parse)
    assert two == one
    sizes = [len(d) for d in datas]
    back = mesh.decode_batch_sharded(props, one, out_sizes=sizes,
                                     devices=["cpu", "cpu"])
    assert back == pipeline.decode_batch(props, one, out_sizes=sizes,
                                         device=CPU) == datas


def test_batch_smaller_than_the_devices():
    props, datas = _batch(1, n=1)
    blobs = mesh.encode_batch_sharded(props, datas, devices=[CPU] * 3)
    assert blobs == pipeline.encode_batch(props, datas, device=CPU)
    framed = [write_properties(props[0]) + blobs[0]]
    assert mesh.decode_batch_sharded(props, framed, positions=[10],
                                     devices=[CPU] * 3) == datas
    with pytest.raises(ValueError):
        mesh.decode_batch_sharded([], [], devices=[CPU])


def test_stream_devices_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.stream_devices()
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.encode_batch_sharded(*_batch(1))
