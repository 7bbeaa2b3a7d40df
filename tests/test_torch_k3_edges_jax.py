"""The plain PyTorch K3 (csc_tpu_torch.ops.bits_scan) against the JAX
phase-B scan (csc_tpu.ops.encode_bits.run_bits) on the CPU, on K3's edge
tapes (tests/torch_edge_cases.py `k3_cases`): rc / bc bytes, counts, the
block-crossing maps, the chunk log and done must be equal on every batch
the JAX scan takes.  Integers throughout, so equality is exact.  Two
batches are the port's alone: a tape without K_END, and maps and a chunk
log shorter than csc_tpu's fixed 64 entries (encode_bits.make_bits_state),
held to the plain version by tests/test_torch_k3_edges.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csc_tpu.ops import encode_bits
from csc_tpu_torch import constants
from csc_tpu_torch.ops import bits_scan

import torch_edge_cases as edges

CASES = edges.k3_cases()


def _run_jax(tp, max_rc, max_bc, bsize):
    old = encode_bits.BSIZE_REF[0]
    encode_bits.BSIZE_REF[0] = bsize
    try:
        st = encode_bits.make_bits_state(tp[0].shape[0], *tp, max_rc, max_bc)
        fin, _ = jax.jit(encode_bits.run_bits)(st, jnp.int32(10 ** 8))
        return {k: np.asarray(v) for k, v in fin.items()}
    finally:
        encode_bits.BSIZE_REF[0] = old


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[3] == "jax"])
def test_plain_matches_jax_on_k3_edge_tapes(case):
    _, tp, (max_rc, max_bc, nmap, nchunk, bsize), _ = next(
        c for c in CASES if c[0] == case)
    want = _run_jax(tp, max_rc, max_bc, bsize)
    assert want["rc_blkmap"].shape[1] == nmap
    assert want["chunk_log"].shape[1] == nchunk
    got = bits_scan.bits_plain(*(torch.from_numpy(x) for x in tp), max_rc,
                               max_bc, nmap, nchunk, bsize)
    rc, bc, rmap, bmap, clog, stats = (t.numpy() for t in got)
    for name, g, w in (("rc_out", rc, want["rc_out"]),
                       ("bc_out", bc, want["bc_out"]),
                       ("rc_blkmap", rmap, want["rc_blkmap"]),
                       ("bc_blkmap", bmap, want["bc_blkmap"]),
                       ("chunk_log", clog, want["chunk_log"]),
                       ("rc_cnt", stats[0], want["rc_cnt"]),
                       ("bc_cnt", stats[1], want["bc_cnt"]),
                       ("chunk_cnt", stats[2], want["chunk_cnt"]),
                       ("done", stats[3], want["done"])):
        np.testing.assert_array_equal(g, w, err_msg=f"{case} {name}")
    assert want["done"].all()


def test_tape_without_end_is_port_only():
    """A tape without K_END: the port codes it to its end with done = 0.
    Held to the plain version only, since this is the port's own
    contract: csc_tpu's scan re-reads the last token until its step limit
    (encode_bits.py:563), and its pipeline always ends a tape with K_END."""
    _, tp, args, held = next(c for c in CASES if c[0] == "no_end")
    assert held == "port"
    assert not (tp[0][0] == constants.K_END).any()
    stats = bits_scan.bits_plain(*(torch.from_numpy(x) for x in tp),
                                 *args)[5].numpy()
    assert stats[3].tolist() == [0, 1]
    # the first stream codes its body twice: more than the second
    assert (stats[:2, 0] > stats[:2, 1]).all()
