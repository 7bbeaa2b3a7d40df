"""The port's match-finder precompute (csc_tpu_torch.ops.parse_pre)
against csc_tpu.ops.parse_pre on the CPU: the [B, 2C, N] candidate array
(ht2, ht3 and hash_width ht6 chain links with their capped lengths) and
the packed [B, C, N] array K2 reads must be equal, at m1 (C = 3) and m2
(C = 10).  Integers throughout, so equality is exact."""
import numpy as np
import pytest
import torch

from csc_tpu.ops import parse_pre as j_pre
from csc_tpu_torch import corpus
from csc_tpu_torch.ops import encode_host, parse_pre, pipeline

def _cases(level):
    return corpus.encode_cases(level, seed=31)


@pytest.mark.parametrize("level", [1, 2])
def test_candidates_match_jax(level):
    cases = _cases(level)
    props = [c[1] for c in cases]
    plans = [encode_host.plan_stream(c[1], c[2]) for c in cases]
    data, run_ends, _, sizes, _ = pipeline.group_inputs(
        props, plans, list(range(len(cases))), torch.device("cpu"))
    p0 = props[0]
    assert all(p.hash_bits == p0.hash_bits for p in props)
    ours = parse_pre.precompute_candidates(data, run_ends, p0.hash_bits,
                                           p0.hash_width)
    ref, _ = j_pre.precompute_candidates(data.numpy(), sizes.tolist(),
                                         run_ends.numpy(), p0.hash_bits,
                                         p0.hash_width)
    ref = np.asarray(ref)
    assert ours.shape == (len(cases), 2 * (2 + p0.hash_width),
                          data.shape[1])
    np.testing.assert_array_equal(ours.numpy(), ref)
    packed = parse_pre.pack_candidates(ours)
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(j_pre.pack_candidates(ref)))
    np.testing.assert_array_equal(
        parse_pre.unpack_candidates(packed).numpy(), ref)
    # capped lengths (extend live), chain links and no-candidate slots
    # all occur
    lens = ref[:, 1::2]
    assert (lens == j_pre.EXT_CAP).any() and (ref[:, 0::2] == 0).any()
    assert ((lens > 0) & (lens < j_pre.EXT_CAP)).any()
